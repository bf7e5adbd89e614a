"""kernels.device_ms (ms/step; layer: kernels): device time a profiled step
of the hand-written kernels, each attributed to its operation by the name
patterns of ``portbench/kernels/<op>.py``."""


def read(ctx):
    if ctx.trace is None:
        return None
    ran = ctx.trace.by_op(ctx.cell.ops())
    return sum(ran.values()) if ran else None
