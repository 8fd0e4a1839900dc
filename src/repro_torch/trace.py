"""Spans at the program's layer boundaries, in ``torch.profiler``'s own timeline.

A span exists only while a ``torch.profiler`` records: each reads
``torch.autograd.profiler._is_profiler_enabled`` once. Then it is a
``record_function`` range named ``repro_torch.<name>``, whose start and
end sit in the profiler's CPU timeline (which kineto aligns with the
device's), nested in the spans around it. Otherwise it is that read and
a shared no-op context: nothing enters the autograd graph and nothing is
kept. There is no other switch and no store: a trace holds the spans.

The names, which the benchmark's readers match:

- ``train_step`` (``runtime/train.py::make_train_step``): one a step;
- ``loss_and_grad`` (``runtime/train.py::value_and_grad``): the forward
  and ``autograd.grad``;
- ``adamw`` (``optim/adamw.py::apply_updates``);
- ``block``: each layer's block in a forward or decode step (and the
  hybrid's shared block, a vlm's cross block);
- ``block.recompute``: a block that remat's checkpoint runs again in the
  backward (``transformer._maybe_remat``);
- ``head`` (``transformer._logits``: final norm, head product, softcap);
- ``ce`` (``transformer.lm_loss``);
- ``head.bwd``: the backward from the seeding of the loss's gradient to
  the gradient of the head's input ``h`` (``head_input`` / ``loss_seed``);
- ``prefill``, ``decode`` (``models/model_zoo.py::Model``).
"""
from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

PREFIX = "repro_torch."
_OFF = contextlib.nullcontext()
# the attribute by which ``_logits``'s output hands its ``head.bwd`` to the loss
_HEAD_BWD = "_repro_torch_head_bwd"


def span(name: str):
    """The span ``repro_torch.<name>`` while a profiler records, else nothing."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(PREFIX + name)


def recompute():
    """``span("block.recompute")`` where the caller runs inside a backward
    (remat's checkpoint running a block again), else nothing: the block's
    first run, in the forward, is inside its caller's ``block``."""
    if not _profiler._is_profiler_enabled or torch._C._current_graph_task_id() == -1:
        return _OFF
    return torch.profiler.record_function(PREFIX + "block.recompute")


class _Range:
    """One forward's ``head.bwd``: opened and closed on the backward's thread."""

    def __init__(self):
        self.rf = None

    def open(self):
        self.rf = torch.profiler.record_function(PREFIX + "head.bwd")
        self.rf.__enter__()

    def close(self):
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
            self.rf = None


class _Mark(torch.autograd.Function):
    """The identity; its backward calls ``act`` as the gradient passes."""

    @staticmethod
    def forward(ctx, x, act):
        ctx.act = act
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.act()
        return g, None


def head_input(h: torch.Tensor):
    """``(h, bwd)``. While a profiler records and ``h`` requires grad, ``h``
    passes through a mark whose backward closes ``head.bwd`` (``bwd``);
    else ``h`` itself and None. ``head_output`` hands ``bwd`` on."""
    if not (_profiler._is_profiler_enabled and h.requires_grad):
        return h, None
    bwd = _Range()
    return _Mark.apply(h, bwd.close), bwd


def head_output(logits, bwd):
    """``logits`` carrying ``bwd`` to ``loss_seed`` (a tensor only: logits in
    vocab pieces take no ``head.bwd``)."""
    if bwd is not None and isinstance(logits, torch.Tensor):
        setattr(logits, _HEAD_BWD, bwd)
    return logits


def loss_seed(loss: torch.Tensor, logits) -> torch.Tensor:
    """``loss``; where ``logits`` carry a ``head.bwd``, through a mark whose
    backward, the first to run, opens it."""
    bwd = getattr(logits, _HEAD_BWD, None) if _profiler._is_profiler_enabled else None
    return loss if bwd is None else _Mark.apply(loss, bwd.open)
