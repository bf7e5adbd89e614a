"""ssd_chunk: the SSD chunk's forward, counted once a mamba layer a step
whatever the remat policy.  The work: the causal half of C·Bᵀ once a group
(B and C are a group's), and of att·(x·dt) a head, and the states product,
2 FLOPs a multiply-add; x, dt, B, C (per group), a read once and y,
states, cum written once."""

from portbench import roofline as rf

PATTERNS = ("ssd::ssd_chunk",)


def geometry(model, job):
    s = model["ssm"]
    Q = min(s["chunk"], job["seq"])
    H = s["expand"] * model["d_model"] // s["headdim"]
    return job["batch"], job["seq"] // Q, Q, H, s["headdim"], s["n_groups"], s["d_state"]


def bound(Bt, nc, Q, H, hp, G, N, itemsize):
    tri = Q * (Q + 1) // 2
    flops = 2 * Bt * nc * (G * tri * N + H * (tri * hp + Q * N * hp))
    nbytes = (Bt * nc * Q * (2 * H * hp * itemsize + 2 * G * N * itemsize + 2 * H * 4)
              + Bt * nc * H * N * hp * 4 + H * 4)
    return flops, nbytes


def layers(model) -> int:
    return sum(m == "mamba" for m in rf.mixers(model))


def work(model, job, family):
    if not model.get("use_flash") or not layers(model):
        return []
    b = bound(*geometry(model, job), rf.itemsize(model["compute_dtype"]))
    return [(layers(model), *b, rf.PEAK_BF16)]
