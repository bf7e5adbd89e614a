"""step.forward_host_ms (ms/step; layer: train step): host ms a profiled
step of the span ``step.forward`` (``training/train_step.py``: ``lm_loss``,
the model's forward and the loss head), what the host takes to launch its work."""

from portbench.spanrecords import span_ms


def read(ctx):
    return span_ms(ctx, "step.forward", key="host_ms")
