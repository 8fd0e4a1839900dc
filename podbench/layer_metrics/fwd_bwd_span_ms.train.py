"""Device ms a train step spends inside the program's span
``repro_torch.loss_and_grad`` (``runtime.train.value_and_grad``: the
forward, remat's recompute and the backward), in the bare traced window:
the in-program counterpart of ``fwd_bwd_ms.train``, read with no
synchronised range."""
from podbench import spans


def read(view):
    return spans.device_ms(view, "loss_and_grad")
