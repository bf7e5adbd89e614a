"""moe.dispatch_ms (ms/step; layer: model): stream ms a profiled step of the
spans ``moe.route`` (the router, the top k and the aux loss) and
``moe.dispatch`` (the slots, the table's rows, the ``index_copy_``) of
``models/moe.py``, every phase summed."""

from portbench.spanrecords import span_ms


def read(ctx):
    return span_ms(ctx, "moe.route", "moe.dispatch")
