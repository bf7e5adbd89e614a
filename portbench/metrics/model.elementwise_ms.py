"""model.elementwise_ms (ms/step; layer: model): device time a profiled step
of PyTorch's elementwise and reduction kernels, by name ("elementwise",
"reduce"), less any kernel that a kernel operation's patterns claim."""

PATTERNS = ("elementwise", "reduce")


def read(ctx):
    from portbench.devtrace import owner

    if ctx.trace is None or not ctx.trace.device:
        return None
    ops = ctx.cell.ops()
    return ctx.trace.ms_per_step(
        lambda n: owner(n, ops) is None and any(p in n for p in PATTERNS))
