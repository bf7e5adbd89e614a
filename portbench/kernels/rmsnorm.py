"""rmsnorm: the norm's forward kernel.  Each layer runs ln1, ln2 where it
has an MLP or a MoE layer, and a mamba mixer's gated norm at d_inner, each
counted once whatever the remat policy; then the final norm.  The work: x
read and y written once, the scale read once; sum of squares, mean, rsqrt
and two products, about 4 fp32 operations an element."""

from portbench import roofline as rf

PATTERNS = ("rn::rmsnorm",)


def norms(model) -> list[int]:
    """The width of each norm a layer's forward runs, over all layers."""
    out = []
    for mixer in rf.mixers(model):
        out.append(model["d_model"])
        if model.get("moe") or model["mlp"] != "none":
            out.append(model["d_model"])
        if mixer == "mamba":
            out.append(model["ssm"]["expand"] * model["d_model"])
    return out


def bound(rows, d, itemsize):
    return 4 * rows * d, 2 * rows * d * itemsize + 4 * d


def work(model, job, family):
    if not model.get("use_flash"):
        return []
    it, rows = rf.itemsize(model["compute_dtype"]), rf.tokens(job)
    out = [(1, *bound(rows, d, it), rf.PEAK_FP32) for d in norms(model)]
    return out + [(1, *bound(rows, model["d_model"], it), rf.PEAK_FP32)]
