"""kernels.span_ms (ms/step; layer: kernels): stream ms a profiled step of
the spans ``kernel.<entry point>`` that ``kernels.build.kernel_call`` opens
around each hand-written kernel's call, forward and backward: the kernel's
time whatever its name, with the wrapper's allocations and copies."""

from portbench.spanrecords import per_step, total


def read(ctx):
    return per_step(ctx, lambda r: total(r, lambda n: n.startswith("kernel."), "stream_ms"))
