"""Device ms a train step spends inside ``optim.adamw.apply_updates`` as
``runtime.train`` calls it: the union of the kernel intervals inside that
call's range, over the traced steps."""
RANGES = {"podbench.apply_updates": ("repro_torch.runtime.train", "apply_updates")}


def read(view):
    busy = view.busy_in("podbench.apply_updates")
    return busy * 1e3 / view.steps if busy > 0 else None
