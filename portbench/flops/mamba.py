"""The model FLOPs of a Mamba-2 mixer beyond its weight products, a layer a
step, forward and backward (three times the forward, no recompute): the
causal convolution (2·cw a channel and token), the SSD within chunks (the
causal half of C·Bᵀ once a group, of att·(x·dt) and the states product a
head) and the output from the entering states (C·h a head and token)."""


def flops(model: dict, B: int, S: int) -> float:
    s = model["ssm"]
    D, P, N, G = model["d_model"], s["headdim"], s["d_state"], s["n_groups"]
    H = s["expand"] * D // P
    Q = min(s["chunk"], S)
    nc, tri = S // Q, Q * (Q + 1) // 2
    conv = 2 * s["conv_width"] * B * S * (s["expand"] * D + 2 * G * N)
    intra = 2 * B * nc * (G * tri * N + H * (tri * P + Q * N * P))
    inter = 2 * B * S * H * N * P
    return 3.0 * (conv + intra + inter)
