"""trainer.issue_ms (ms/step; layer: trainer): host time from the call of
``Trainer.step_fn`` until it returns, before the read of its metrics that
synchronises, the median over the window's steps (none profiled).  It is what
the host costs to issue a step: Python, the autograd engine, SAC's dispatch
under ``dots``.  Where it comes near the step's time, the host holds the card."""

import statistics


def read(ctx):
    issued = ctx.window["issue_s"]
    return statistics.median(issued) * 1e3 if issued else None
