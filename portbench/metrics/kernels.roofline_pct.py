"""kernels.roofline_pct (%; layer: kernels): the least time the card could
take for the step's hand-written-kernel calls, Σ calls · max(FLOPs / peak,
bytes / 3.35 TB/s) from the configuration's shapes and call counts
(``portbench/kernels/<op>.py``), over the device time of those kernels in a
profiled step.  Only operations whose kernels ran count, on both sides."""


def read(ctx):
    if ctx.trace is None:
        return None
    ran = {op: ms for op, ms in ctx.trace.by_op(ctx.cell.ops()).items() if ms > 0}
    if not ran:
        return None
    bounds = ctx.kernel_bounds()
    return 100.0 * sum(bounds[op] for op in ran) / sum(ran.values())
