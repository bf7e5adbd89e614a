"""rmsnorm_bwd: the norm's backward (two device kernels a call: the rows,
then the fixed-order sum of dscale), one call a norm a step.  The work: x
and dy read and dx written once, the scale read and dscale written once;
about 10 fp32 operations an element."""

from portbench import roofline as rf
from portbench.kernels import rmsnorm as fwd

PATTERNS = ("rn::rmsnorm_bwd",)


def bound(rows, d, itemsize):
    return 10 * rows * d, 3 * rows * d * itemsize + 8 * d


def work(model, job, family):
    if not model.get("use_flash"):
        return []
    it, rows = rf.itemsize(model["compute_dtype"]), rf.tokens(job)
    widths = fwd.norms(model) + [model["d_model"]]
    return [(1, *bound(rows, d, it), rf.PEAK_FP32) for d in widths]
