"""Device ms a train step spends inside the program's span
``repro_torch.adamw`` (``optim.adamw.apply_updates``), in the bare traced
window: the in-program counterpart of ``adamw_ms.train``."""
from podbench import spans


def read(view):
    return spans.device_ms(view, "adamw")
