"""flash_fwd: the attention forward, counted once a layer a step whatever
the remat policy.  The work: two products of 2·hd FLOPs per visible score
entry (q·kᵀ and p·v); q, k, v read and o written once, and lse written."""

import numpy as np

from portbench import roofline as rf

PATTERNS = ("fa::flash_fwd",)


def visible_entries(B, S, T, H, causal, window) -> int:
    """Score entries the mask leaves, over all batches and heads."""
    qpos = np.arange(S, dtype=np.int64) + (T - S)
    hi = np.minimum(qpos, T - 1) if causal else np.full(S, T - 1)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(S, np.int64)
    return int(B * H * np.maximum(hi - lo + 1, 0).sum())


def attention_layers(model) -> list:
    """(window or None) of each attention layer that takes flash."""
    return [model["window"] if m == "local" else None for m in rf.mixers(model)
            if m in ("attn", "local")]


def shapes(model, job):
    B, S = job["batch"], job["seq"]
    return B, S, S, model["n_heads"], model["n_kv_heads"], model["head_dim"]


def bound(B, S, T, H, Kv, hd, causal, window, itemsize, products=2, q_like=2, kv_like=2,
          row_vecs=1):
    """(FLOPs, bytes) of one call: ``products`` products per visible entry;
    ``q_like`` tensors of q's size, ``kv_like`` of k's, ``row_vecs`` fp32
    vectors a query row, each read or written once."""
    n = visible_entries(B, S, T, H, causal, window)
    qb, kb = B * S * H * hd * itemsize, B * T * Kv * hd * itemsize
    return products * 2 * hd * n, q_like * qb + kv_like * kb + row_vecs * B * H * S * 4


def work(model, job, family):
    if not model.get("use_flash") or job["seq"] % 128:
        return []
    it = rf.itemsize(model["compute_dtype"])
    return [(1, *bound(*shapes(model, job), True, w, it), rf.PEAK_BF16)
            for w in attention_layers(model)]
