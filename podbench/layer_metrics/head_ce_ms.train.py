"""Device ms a train step spends in the head and the CE: the program's
spans ``repro_torch.head`` (final norm, the 151,936-wide head product,
softcap), ``repro_torch.ce`` (the loss) and ``repro_torch.head.bwd`` (the
backward from the loss's seed to the gradient at the head's input), in
the bare traced window."""
from podbench import spans


def read(view):
    return spans.device_ms(view, "head", "ce", "head.bwd")
