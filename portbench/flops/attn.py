"""The model FLOPs of causal attention beyond its weight products, a layer a
step, forward and backward (three times the forward, no recompute): q·kᵀ
and p·v, 2·hd FLOPs each per visible score entry (the causal half)."""


def flops(model: dict, B: int, S: int) -> float:
    visible = B * model["n_heads"] * S * (S + 1) // 2
    return 3.0 * 2 * 2 * model["head_dim"] * visible
