"""remat.policy_ops (ops/step; layer: remat policy): the operators that
SAC's policy judged a profiled step, in the forward and the recompute
(``core/remat_policy.py``'s ``_contexts``); ``None`` without a SAC policy
(``remat="full"`` runs plain checkpointing)."""

from portbench.spanrecords import per_step


def read(ctx):
    return per_step(ctx, lambda r: r["policy_ops"])
