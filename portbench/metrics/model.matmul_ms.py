"""model.matmul_ms (ms/step; layer: model): device time a profiled step of
cuBLAS's products, by name ("nvjet", "gemm", "cutlass", "gemv"), less any
kernel that a kernel operation's patterns claim."""

PATTERNS = ("nvjet", "gemm", "cutlass", "gemv")


def read(ctx):
    from portbench.devtrace import owner

    if ctx.trace is None or not ctx.trace.device:
        return None
    ops = ctx.cell.ops()
    return ctx.trace.ms_per_step(
        lambda n: owner(n, ops) is None and any(p in n for p in PATTERNS))
