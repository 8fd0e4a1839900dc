"""The train step's model FLOPs (3x the forward's, the head at every
position; remat's recompute not counted) over the traced steps' time,
against the bf16 peak of the data sheet, in %."""
from podbench import yardstick


def read(view):
    cell = view.cell
    B, S = cell.mix["batch"], cell.mix["seq_len"]
    flops = 3 * yardstick.forward_flops(cell.arch, B, S, head_positions=S,
                                        run=cell.config["train"])
    if view.window_s <= 0 or not view.kernels:
        return None
    return 100.0 * flops * view.steps / view.window_s / yardstick.PEAK_FLOP_PER_S["bfloat16"]
