"""Per-device FLOPs, memory traffic and collectives of one traced step.

The counterpart of the JAX package's ``repro/launch/hlo_analysis.py``.
There, XLA partitions the step into one per-device module, whose HLO text
is parsed. The port runs the step eagerly on DTensors whose local shards
are meta tensors (``launch/dryrun.py``), so each rank's work is the
sequence of ops on local shards; ``TraceAnalysis``, a
``TorchDispatchMode``, sees each of them once and counts, per device:

  * ``flops``            -- the products: 2*M*N*K for mm / addmm / bmm /
                            baddbmm (``torch.utils.flop_counter``'s
                            formulas), and K1's and K2's own formulas
                            (``kernels/flash_attention.py::flops``,
                            ``kernels/ssd_scan.py::flops``), registered for
                            their operators; ``flops_by_op`` splits them
  * ``mem_bytes``        -- the operand + result bytes of every op that is
                            not a view (an HBM traffic model: each op
                            reads its inputs and writes its outputs)
  * ``collective_bytes`` -- the operand bytes of each collective, by type
                            (the ``_c10d_functional`` all-gather,
                            reduce-scatter, all-reduce and all-to-all that
                            DTensor calls, and the ``c10d`` ops of
                            ``torch.distributed``'s own calls, such as
                            ``parallel/overlap.py``'s ring sends), with
                            ``collective_counts``
  * ``peak_live_bytes``  -- the high-water mark of the bytes of the
                            storages made during the step and still alive
  * ``peak_holders``     -- the storages alive at that mark, summed by the
                            op, shape and dtype that made them, largest
                            first (``PEAK_HOLDERS`` of them)

Only local ops count. An op with a DTensor argument is left to DTensor
(``NotImplemented``), which then runs it on the local shards, seen
here. DTensor's sharding propagation runs each new op signature once on
fake tensors of the GLOBAL shapes to learn the output's shape
(``ShardingPropagator._propagate_tensor_meta_non_cached`` in torch 2.11
and 2.13); no rank does that work, so nothing is counted while it runs.
That hook is a private name: if it is missing the analysis refuses to
run rather than count those runs silently.

The HLO walk's ``n_while`` and ``trip_counts`` have no counterpart: the
port's layers and micro-batches are Python loops, each op seen as often
as it runs.
"""
from __future__ import annotations

import contextlib
import weakref
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

# op-name fragments -> the HLO collective of the same meaning
_COLLECTIVES = (("all_gather", "all-gather"), ("allgather", "all-gather"),
                ("reduce_scatter", "reduce-scatter"), ("all_reduce", "all-reduce"),
                ("allreduce", "all-reduce"), ("all_to_all", "all-to-all"),
                ("alltoall", "all-to-all"), ("send", "collective-permute"),
                ("recv", "collective-permute"), ("broadcast", "broadcast"))
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d", "c10d_functional")
# ops that move no data (views are skipped by their schema)
_FREE = {"wait_tensor", "detach", "alias", "lift_fresh", "_local_scalar_dense"}
PEAK_HOLDERS = 8


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _collective(func) -> str:
    if func.namespace not in _COLLECTIVE_NAMESPACES:
        return ""
    name = func._opname
    for frag, kind in _COLLECTIVES:
        if frag in name:
            return kind
    return ""


@dataclass
class TraceStats:
    flops: float = 0.0
    flops_by_op: Dict[str, float] = field(default_factory=lambda: defaultdict(float))
    mem_bytes: float = 0.0
    collective_bytes: Dict[str, float] = field(default_factory=lambda: defaultdict(float))
    collective_counts: Dict[str, int] = field(default_factory=lambda: defaultdict(int))
    peak_live_bytes: int = 0
    peak_holders: list = field(default_factory=list)

    @property
    def total_collective_bytes(self) -> float:
        return float(sum(self.collective_bytes.values()))


def _propagator():
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    if not hasattr(ShardingPropagator, "_propagate_tensor_meta_non_cached"):
        raise RuntimeError(
            "torch.distributed.tensor._sharding_prop.ShardingPropagator has no "
            "_propagate_tensor_meta_non_cached in this torch: the analysis cannot tell "
            "DTensor's global-shape propagation runs from local ops")
    return ShardingPropagator


class TraceAnalysis(TorchDispatchMode):
    """``with TraceAnalysis() as ta: step(...)``, then ``ta.stats``."""

    def __init__(self):
        super().__init__()
        self.stats = TraceStats()
        self._live: Dict[int, tuple] = {}
        self._live_bytes = 0
        self._at_peak: Dict[int, tuple] = {}
        self._propagating = 0
        self._patch = None

    # -- DTensor's global-shape propagation counts nothing ----------------
    @contextlib.contextmanager
    def _skip_propagation(self):
        cls = _propagator()
        real = cls._propagate_tensor_meta_non_cached
        mode = self

        def propagate(prop, op_schema):
            mode._propagating += 1
            try:
                return real(prop, op_schema)
            finally:
                mode._propagating -= 1
        cls._propagate_tensor_meta_non_cached = propagate
        try:
            yield
        finally:
            cls._propagate_tensor_meta_non_cached = real

    def __enter__(self):
        self._patch = self._skip_propagation()
        self._patch.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._patch.__exit__(*exc)
            self.stats.peak_holders = self._holders()

    def _holders(self) -> list:
        by = defaultdict(lambda: [0, 0])
        for _, n, made in self._at_peak.values():
            by[made][0] += n
            by[made][1] += 1
        top = sorted(by.items(), key=lambda kv: -kv[1][0])[:PEAK_HOLDERS]
        return [{"op": op, "shape": list(shape), "dtype": dtype, "bytes": n, "count": c}
                for (op, shape, dtype), (n, c) in top]

    # -- live storages ----------------------------------------------------
    def _track(self, out, args, func) -> None:
        seen = {id(t.untyped_storage()) for t in _tensors(args)}
        for t in _tensors(out):
            st = t.untyped_storage()
            key = id(st)
            if key in seen or key in self._live:
                continue
            n = st.nbytes()
            made = (str(func._overloadpacket), tuple(t.shape), str(t.dtype).removeprefix("torch."))
            self._live[key] = (weakref.ref(st, self._release(key)), n, made)
            self._live_bytes += n
            if self._live_bytes > self.stats.peak_live_bytes:
                self.stats.peak_live_bytes = self._live_bytes
                self._at_peak = dict(self._live)

    def _release(self, key):
        def release(_):
            entry = self._live.pop(key, None)
            if entry is not None:
                self._live_bytes -= entry[1]
        return release

    # -- the count --------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._propagating or any(issubclass(t, FakeTensor) for t in types):
            return out
        if func._opname in _FREE or func.is_view:
            return out
        ins = _tensors((args, kwargs))
        kind = _collective(func)
        if kind:
            self.stats.collective_bytes[kind] += sum(_nbytes(t) for t in ins)
            self.stats.collective_counts[kind] += 1
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            n = formula(*args, **kwargs, out_val=out)
            self.stats.flops += n
            self.stats.flops_by_op[str(func._overloadpacket)] += n
        self.stats.mem_bytes += sum(_nbytes(t) for t in ins) + sum(
            _nbytes(t) for t in _tensors(out))
        self._track(out, (args, kwargs), func)
        return out
