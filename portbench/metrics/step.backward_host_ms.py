"""step.backward_host_ms (ms/step; layer: train step): host ms a profiled
step of the span ``step.backward`` (``training/train_step.py``:
``torch.autograd.grad``, the recompute included), what the host takes to
launch its work."""

from portbench.spanrecords import span_ms


def read(ctx):
    return span_ms(ctx, "step.backward", key="host_ms")
