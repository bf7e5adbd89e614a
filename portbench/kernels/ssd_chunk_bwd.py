"""ssd_chunk_bwd: the SSD chunk's backward (the slices' kernel, then the
sums over a group's heads, each head's last step and da), one call a mamba
layer a step.  The work: the causal half of s = C·Bᵀ once a group and of
dP = dy·uᵀ, du = Pᵀ·dy, dC = ds·B and dB = dsᵀ·C a head, and the two states
products, 2 FLOPs a multiply-add; x, dt, b, c, a, dy, dstates and dcum read
once, dx, ddt, db, dc and da written once."""

from portbench import roofline as rf
from portbench.kernels import ssd_chunk as fwd

PATTERNS = ("ssd::ssd_chunk_bwd", "ssd::bwd_")


def bound(Bt, nc, Q, H, hp, G, N, itemsize):
    tri = Q * (Q + 1) // 2
    flops = 2 * Bt * nc * (G * tri * N + H * (tri * (2 * N + 2 * hp) + 2 * Q * N * hp))
    rows = Bt * nc * Q
    nbytes = (rows * H * hp * itemsize * 3 + rows * H * 4 * 3 + rows * G * N * itemsize * 4
              + Bt * nc * H * N * hp * 4 + H * 4 * 2)
    return flops, nbytes


def work(model, job, family):
    if not model.get("use_flash") or not fwd.layers(model):
        return []
    b = bound(*fwd.geometry(model, job), rf.itemsize(model["compute_dtype"]))
    return [(fwd.layers(model), *b, rf.PEAK_BF16)]
