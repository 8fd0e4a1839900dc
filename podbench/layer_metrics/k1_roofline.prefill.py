"""K1's share of its roofline in the prefills: the summed
``yardstick.attention_bound`` of the window's K1 calls (each from the
recorded shapes of its operator, ``repro_torch::k1_fwd``) over the device
time of the kernels those calls launched, in %.

A call of the operator launches one kernel of ``csrc/flash_attention.cu``
(``flash_mma_kernel`` or ``flash_fwd_kernel``); the reader takes the
window's kernels named so and reads only when they are as many as the
operator's calls, so a K1 that launches under another name, or more than
one kernel a call, gets no reading rather than a wrong one. Not through
each call's launch records: on torch 2.11 the profiler loses some of them
under a full command buffer (two qwen2-1.5b prefills of 2 x 16k on an
H100: 0.23 of K1's 0.43 device s found that way)."""
from podbench import yardstick

SHAPES = True      # the traced run records the operators' input shapes
KERNELS = ("flash_mma_kernel", "flash_fwd_kernel")


def read(view):
    calls = view.op_events("repro_torch::k1_fwd")
    kernels = view.kernels_named(*KERNELS)
    if not calls or len(kernels) != len(calls):
        return None
    dtype = view.cell.config["serve"]["compute_dtype"]
    bound = 0.0
    for e in calls:
        (B, S, H, hd), (_, T, K, _) = e.input_shapes[0], e.input_shapes[1]
        causal, q_offset = e.concrete_inputs[3], e.concrete_inputs[4]
        bound += yardstick.attention_bound(B, S, T, H, K, hd, dtype, causal, q_offset)[0]
    return 100.0 * bound / (sum(e - s for _, s, e in kernels) / 1e6)
