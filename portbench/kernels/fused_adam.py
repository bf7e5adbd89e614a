"""fused_adam: AdamW over every leaf, one call a step (a launch per dtype
group).  The work of a leaf of n elements: p, m, v read and written once, g
read once (g in p's dtype, m and v in the state dtype); about 16 fp32
operations an element.  The leaves come from the model family's reference (``family.leaves``)."""

from portbench import roofline as rf

PATTERNS = ("adam::adam",)


def bound(n, p_bytes, g_bytes, s_bytes):
    return 16 * n, n * (2 * p_bytes + g_bytes + 4 * s_bytes)


def work(model, job, family):
    if job["optimizer"] != "adamw":
        return []
    flops = nbytes = 0
    for shape, dtype, _, _ in family.leaves(model).values():
        n = 1
        for s in shape:
            n *= s
        it = rf.itemsize(dtype)
        f, b = bound(n, it, it, rf.itemsize(model["state_dtype"]))
        flops, nbytes = flops + f, nbytes + b
    return [(1, flops, nbytes, rf.PEAK_FP32)]
