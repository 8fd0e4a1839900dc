"""Device ms a train step spends in remat's recompute: the program's span
``repro_torch.block.recompute`` (each block that the checkpoint runs again
in the backward), in the bare traced window."""
from podbench import spans


def read(view):
    return spans.device_ms(view, "block.recompute")
