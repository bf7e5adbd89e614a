"""flash_dkv: the attention backward's dk and dv, one call a layer a step.
The work: s, dp, pᵀ·do and dsᵀ·q, four products of 2·hd FLOPs per visible
entry; q, do read, k, v read and dk, dv written, lse and delta read."""

from portbench import roofline as rf
from portbench.kernels import flash_fwd as fwd

PATTERNS = ("fa::flash_dkv",)


def work(model, job, family):
    if not model.get("use_flash") or job["seq"] % 128:
        return []
    it = rf.itemsize(model["compute_dtype"])
    return [(1, *fwd.bound(*fwd.shapes(model, job), True, w, it, products=4, q_like=2,
                           kv_like=4, row_vecs=2), rf.PEAK_BF16)
            for w in fwd.attention_layers(model)]
