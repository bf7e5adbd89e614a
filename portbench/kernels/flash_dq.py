"""flash_dq: the attention backward's dq, one call a layer a step.  The
work: s, dp and ds·k, three products of 2·hd FLOPs per visible entry; q,
do, dq and k, v once each, lse and delta read."""

from portbench import roofline as rf
from portbench.kernels import flash_fwd as fwd

PATTERNS = ("fa::flash_dq",)


def work(model, job, family):
    if not model.get("use_flash") or job["seq"] % 128:
        return []
    it = rf.itemsize(model["compute_dtype"])
    return [(1, *fwd.bound(*fwd.shapes(model, job), True, w, it, products=3, q_like=3,
                           kv_like=2, row_vecs=2), rf.PEAK_BF16)
            for w in fwd.attention_layers(model)]
