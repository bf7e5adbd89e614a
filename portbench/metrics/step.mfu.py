"""step.mfu (%; layer: train step): the model FLOPs of the window's steps
(``modelflops.step_flops``: 6·N·T plus each mixer's term, no recompute) over
the window's wall time, as a share of 989 TFLOP/s, the H100's dense bf16
peak at 700 W.  Read only on the card: a CPU run has no such peak."""

from portbench.roofline import PEAK_BF16


def read(ctx):
    w = ctx.window
    if ctx.device_type != "cuda" or not w["steps"]:
        return None
    return 100.0 * ctx.cell.step_flops() * w["steps"] / w["seconds"] / PEAK_BF16
