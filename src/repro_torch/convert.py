"""Move JAX-side state into the port: same keys, shapes and dtypes.

The port keeps the JAX package's layouts ((in, out) matrices, stacked
``blocks`` with a leading L axis, a (L, B, T, K, hd) cache, an SSM
state stacked over L), so nothing is transposed. Inputs are numpy
arrays (``np.asarray`` of the JAX arrays); bfloat16 arrives as numpy's
ml_dtypes bfloat16 and is moved bit for bit.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models.ssm import SSMState
from repro_torch.optim.adamw import TrainState


def tensor_from_numpy(a, device="cuda") -> torch.Tensor:
    """A copy of ``a`` on ``device`` (never a view of JAX's read-only buffer)."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(tree: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """A params tree of numpy arrays -> the same tree of tensors on ``device``."""
    return {k: params_from_jax(v, device) if isinstance(v, dict)
            else tensor_from_numpy(v, device) for k, v in tree.items()}


def state_from_jax(state, device="cuda") -> TrainState:
    """A JAX ``TrainState`` (params, m, v, step; numpy leaves) -> the port's."""
    return TrainState(params=params_from_jax(state.params, device),
                      m=params_from_jax(state.m, device),
                      v=params_from_jax(state.v, device),
                      step=tensor_from_numpy(state.step, device))


def cache_from_jax(cache: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """A decode cache of numpy arrays -> tensors on ``device``, ``pos`` a host int.

    A KV cache's ``k``/``v`` arrays move as they are. The JAX ``SSMState``
    under ``ssm`` (a NamedTuple of four arrays) becomes the port's
    ``SSMState``, field by field name.
    """
    def move(k, v):
        if k == "pos":
            return int(np.asarray(v))
        if k == "ssm":
            fields = v._asdict()
            return SSMState(**{f: tensor_from_numpy(fields[f], device)
                               for f in SSMState._fields})
        return tensor_from_numpy(v, device)
    return {k: move(k, v) for k, v in cache.items()}
