"""The prefills' model FLOPs (the forward, the head at the last position
only) over the traced batches' time, against the bf16 peak of the data
sheet, in %."""
from podbench import yardstick


def read(view):
    cell = view.cell
    B, S = cell.mix["batch"], cell.mix["seq_len"]
    flops = yardstick.forward_flops(cell.arch, B, S, head_positions=1,
                                    run=cell.config["serve"])
    if view.window_s <= 0 or not view.kernels:
        return None
    return 100.0 * flops * view.steps / view.window_s / yardstick.PEAK_FLOP_PER_S["bfloat16"]
