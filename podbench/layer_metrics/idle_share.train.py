"""The share of the traced train window in which no kernel ran on the
device: 1 - (union of kernel intervals) / (the window's span), in %."""


def read(view):
    if view.window_s <= 0 or not view.kernels:
        return None
    return 100.0 * (1.0 - view.busy_s / view.window_s)
