"""Model FLOPs of one training step, with no recompute: 6 · N · T for the
weight products (N the weights of products that a token uses: the experts
at top_k / n_experts; the embedding's gather is no product), plus each
layer's mixer term (``portbench/flops/<mixer>.py``)."""

from __future__ import annotations

import math

from portbench import roofline as rf


def matmul_params(model: dict, family) -> float:
    """N: the weights of products a token uses, from ``family.leaves``."""
    n = 0.0
    for shape, _, _, role in family.leaves(model).values():
        if role == "matmul":
            n += math.prod(shape)
        elif role == "expert":
            n += math.prod(shape) * model["moe"]["top_k"] / model["moe"]["n_experts"]
    return n


def step_flops(model: dict, job: dict, family, mixer_flops) -> float:
    """``mixer_flops(name)`` gives the module of a mixer's term."""
    B, S = job["batch"], job["seq"]
    mixers = sum(mixer_flops(m).flops(model, B, S) for m in rf.mixers(model))
    return 6.0 * matmul_params(model, family) * B * S + mixers
