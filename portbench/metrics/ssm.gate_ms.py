"""ssm.gate_ms (ms/step; layer: model): stream ms a profiled step of the
span ``ssm.gate`` (``models/ssm.py``: ``y · silu(z)`` and the gated norm),
forward, recompute and backward summed."""

from portbench.spanrecords import span_ms


def read(ctx):
    return span_ms(ctx, "ssm.gate")
