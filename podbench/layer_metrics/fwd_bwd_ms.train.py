"""Device ms a train step spends inside ``runtime.train.value_and_grad``
(the forward, the backward and the recompute of remat): the union of the
kernel intervals inside that call's range, over the traced steps."""
RANGES = {"podbench.value_and_grad": ("repro_torch.runtime.train", "value_and_grad")}


def read(view):
    busy = view.busy_in("podbench.value_and_grad")
    return busy * 1e3 / view.steps if busy > 0 else None
