"""ssm.conv_ms (ms/step; layer: model): stream ms a profiled step of the
span ``ssm.conv`` (``models/ssm.py``: both causal convolutions in fp32, their
silu and casts), forward, recompute and backward summed."""

from portbench.spanrecords import span_ms


def read(ctx):
    return span_ms(ctx, "ssm.conv")
