"""ssm.scan_ms (ms/step; layer: model): stream ms a profiled step of the
span ``ssm.scan`` (``models/ssm.py``: the inter-chunk loop, the stacked
states entering each chunk, ``y_inter`` and ``y + D·x``), forward,
recompute and backward summed."""

from portbench.spanrecords import span_ms


def read(ctx):
    return span_ms(ctx, "ssm.scan")
