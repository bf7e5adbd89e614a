"""remat.recompute_host_ms (ms/step; layer: remat policy): host ms a
profiled step of the stage spans of the recompute (phase ``rec``: the
forward that activation checkpointing runs again inside the backward), the
outermost stages only, so that nothing counts twice."""

from portbench.spanrecords import per_step, total


def read(ctx):
    return per_step(ctx, lambda r: total(r, lambda n: True, "top_host_ms", ("rec",)))
