"""Operators the host dispatches a train step: the ``aten::`` events with
no ``aten::`` ancestor inside the program's span ``repro_torch.train_step``
(the forward's, and the backward's on the autograd engine's thread), in
the bare traced window. A count: the same on every seed."""
from podbench import spans


def read(view):
    return spans.host_ops(view, "train_step")
