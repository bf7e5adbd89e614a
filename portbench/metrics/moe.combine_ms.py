"""moe.combine_ms (ms/step; layer: model): stream ms a profiled step of the
span ``moe.combine`` (``models/moe.py``: the gather of the experts' rows,
the gate product and the sum over K), every phase summed."""

from portbench.spanrecords import span_ms


def read(ctx):
    return span_ms(ctx, "moe.combine")
