"""Weights from the seed, made on the device in the program's tree.

The tree's shapes and dtypes come from the program's meta tree (the
layout it takes its params in); the values are the benchmark's own. One
normal draw a dtype covers every leaf of that dtype, in the order of the
leaves' paths, each leaf a view of it turned into its values by its rule.
The same seed gives the same weights, so the reference makes them again
rather than read the program's.

A leaf is judged by its own key and by its shape without its stacking
axes: the layer axis of ``blocks/*`` and ``cross_blocks/*``, and the axes
that the configuration's ``stacked`` key adds ({subtree path: axes}, such
as {"blocks/moe": 1} for a layer's experts). The rules (``RULES``, by key):

- ``small``: embeddings, norm scales (stored as offsets from 1) and
  biases, N(0, 0.02^2);
- ``residual_out``: the residual outputs of a layer with two residual adds
  (attention's ``wo``, the MLP's ``w2``), N(0, 1/fan_in) further scaled by
  1/sqrt(2L); ``mamba_out``: Mamba2's ``out``, the one residual add of its
  layer, scaled by 1/sqrt(L), as mamba_ssm's ``_init_weights`` rescales a
  Mamba2 stack with no MLP;
- ``conv``: a depthwise conv's weights (W, channels) and biases
  (channels,), N(0, 1/W): the fan-in of a channel is the conv's width;
- Mamba2's leaves as arXiv:2405.21060's code sets them: ``a_log``, A_log =
  log A with A ~ U[1, 16]; ``dt_bias``, softplus^-1(dt) with dt
  log-uniform in [dt_min, dt_max] and floored at dt_floor (the
  configuration's ``init`` section; defaults 1e-3, 1e-1, 1e-4); ``one``,
  D_skip = 1. A uniform draw is the normal draw through its CDF;
- any other leaf that is a matrix without its stacking axes: N(0,
  1/fan_in), fan_in its second-to-last axis. Any other leaf raises.

One departure from torch's and mamba_ssm's defaults holds for every fan-in
draw, the dense cells' included: it is normal with variance 1/fan_in,
where ``nn.Linear`` and ``nn.Conv1d`` draw U(-1/sqrt(fan_in),
1/sqrt(fan_in)), variance 1/(3 fan_in).
"""
from __future__ import annotations

import math

import torch

STACKED = {"blocks": 1, "cross_blocks": 1}
RULES = {
    **dict.fromkeys(("embed", "head", "ln", "ln1", "ln2", "final_norm", "gate_norm",
                     "bq", "bk", "bv"), "small"),
    **dict.fromkeys(("wo", "w2"), "residual_out"),
    "out": "mamba_out",
    **dict.fromkeys(("conv_x", "conv_B", "conv_C", "conv_x_bias", "conv_B_bias", "conv_C_bias"),
                    "conv"),
    "A_log": "a_log", "dt_bias": "dt_bias", "D_skip": "one",
}
INIT = {"dt_min": 1e-3, "dt_max": 1e-1, "dt_floor": 1e-4}


def flatten(tree, prefix: str = "") -> dict:
    """{"a/b/c": leaf}, keys in sorted order at every level."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, path + "/"))
        else:
            out[path] = v
    return out


def unflatten(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        node = out
        *heads, last = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def stacking_axes(path: str, stacked: dict) -> int:
    """The leading axes of leaf ``path`` that stack layers (or experts)."""
    return sum(n for p, n in stacked.items() if path == p or path.startswith(p + "/"))


def _uniform(x: torch.Tensor) -> torch.Tensor:
    """The standard normal draw ``x`` as U(0, 1), through the normal CDF, in f32."""
    return 0.5 * (1.0 + torch.erf(x.float() / math.sqrt(2.0)))


def _fill(path: str, x: torch.Tensor, axes: int, arch: dict, init: dict) -> None:
    """Turn the standard normal draw ``x`` into leaf ``path``'s values, in place."""
    n_layers = arch["n_layers"]
    key = path.rsplit("/", 1)[-1]
    shape = x.shape[axes:]
    rule = RULES.get(key, "fan_in" if len(shape) >= 2 else None)
    if rule == "small":
        x.mul_(0.02)
    elif rule in ("fan_in", "residual_out", "mamba_out") and len(shape) >= 2:
        scale = 1.0 / math.sqrt(shape[-2])
        if rule == "residual_out":
            scale /= math.sqrt(2 * n_layers)
        elif rule == "mamba_out":
            scale /= math.sqrt(n_layers)
        x.mul_(scale)
    elif rule == "conv" and len(shape) <= 2:      # (W, channels) or (channels,): fan-in W
        x.mul_(1.0 / math.sqrt(arch["ssm_conv_width"]))
    elif rule == "a_log":
        x.copy_(torch.log(1.0 + 15.0 * _uniform(x)))
    elif rule == "dt_bias":
        lo, hi = math.log(init["dt_min"]), math.log(init["dt_max"])
        dt = torch.exp(lo + (hi - lo) * _uniform(x)).clamp(min=init["dt_floor"])
        x.copy_(dt + torch.log(-torch.expm1(-dt)))
    elif rule == "one":
        x.fill_(1.0)
    else:
        raise ValueError(f"no init rule for leaf {path!r} of shape {tuple(x.shape)} "
                         f"({axes} stacking axes, rule {rule!r})")


def make(meta_tree: dict, config: dict, seed: int, device) -> dict:
    """Leaves of ``meta_tree``'s shapes and dtypes on ``device`` from
    ``seed``, by the rules of configuration ``config`` (its ``arch``, and
    its ``stacked`` and ``init`` sections where it has them)."""
    flat = flatten(meta_tree)
    stacked = {**STACKED, **config.get("stacked", {})}
    init = {**INIT, **config.get("init", {})}
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for dtype in sorted({t.dtype for t in flat.values()}, key=str):
        paths = [p for p, t in flat.items() if t.dtype == dtype]
        total = sum(flat[p].numel() for p in paths)
        buf = torch.randn(total, generator=gen, device=device, dtype=dtype)
        off = 0
        for p in paths:
            n = flat[p].numel()
            leaf = buf[off:off + n].view(flat[p].shape)
            _fill(p, leaf, stacking_axes(p, stacked), config["arch"], init)
            out[p] = leaf
            off += n
    return unflatten(out)
