"""Device ms a train step spends under the autograd nodes of K1's
backward (``FlashAttentionFnBackward``: K1's backward kernels, the plain
tensor-op backward where the kernels take no such shape or dtype)."""


def read(view):
    device_s = view.kernel_s_under(view.node_events("FlashAttentionFnBackward"))
    return device_s * 1e3 / view.steps if device_s > 0 else None
