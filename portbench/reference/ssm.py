"""fp32 reference of the ``ssm`` family: a Mamba-2 language model
(arXiv:2405.21060, section 6 and listing 1), as the port lays out its
parameters.

Each layer: ``x + W_o · norm(SSD(conv(x W_x), conv(x W_bc), dt) · silu(x W_z))``
with ``dt = softplus(x W_dt + dt_bias)``, ``A = −exp(A_log)``, a depthwise
causal convolution followed by SiLU, and the SSD computed chunk by chunk
(the quadratic form within a chunk, the state recurrence across chunks),
with the skip ``D · x``.  Then the final norm, the head and the loss.  Each
layer runs under ``checkpoint``, so only the layer inputs are kept between
the forward and the backward.

Departure from the paper's model, as in the system: no bias on the
convolution.  Imports ``torch`` and ``common`` only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference import common


def dims(model: dict) -> dict:
    s = model["ssm"]
    di = s["expand"] * model["d_model"]
    return {"di": di, "nh": di // s["headdim"], "hp": s["headdim"], "N": s["d_state"],
            "G": s["n_groups"], "cw": s["conv_width"], "Q": s["chunk"]}


def leaves(model: dict) -> dict:
    """Every parameter: path → (shape, dtype, init, role).  ``init`` is
    ``zeros``, ``ones``, ``small`` (std 0.02) or ``fan_in`` (std 1/√fan-in,
    the fan-in being the second-to-last dim); ``role`` is ``matmul`` for a
    weight of a product, ``embed`` for the table, ``other`` else."""
    D, V, L, pd = model["d_model"], model["vocab"], model["n_layers"], model["param_dtype"]
    k = dims(model)
    di, nh, gn, cw = k["di"], k["nh"], 2 * k["G"] * k["N"], k["cw"]
    mix = "scan/0/mixer/"
    out = {
        "embed/table": ((V, D), pd, "small", "embed"),
        "scan/0/ln1/scale": ((L, D), "float32", "zeros", "other"),
        mix + "wz": ((L, D, di), pd, "fan_in", "matmul"),
        mix + "wx": ((L, D, di), pd, "fan_in", "matmul"),
        mix + "wbc": ((L, D, gn), pd, "fan_in", "matmul"),
        mix + "wdt": ((L, D, nh), pd, "fan_in", "matmul"),
        mix + "conv_x": ((L, cw, di), "float32", "fan_in", "other"),
        mix + "conv_bc": ((L, cw, gn), "float32", "fan_in", "other"),
        mix + "A_log": ((L, nh), "float32", "zeros", "other"),
        mix + "dt_bias": ((L, nh), "float32", "zeros", "other"),
        mix + "D": ((L, nh), "float32", "ones", "other"),
        mix + "norm": ((L, di), "float32", "zeros", "other"),
        mix + "wo": ((L, di, D), pd, "fan_in", "matmul"),
        "final_norm/scale": ((D,), "float32", "zeros", "other"),
    }
    if not model["tie_embeddings"]:
        out["head/w"] = ((D, V), pd, "small", "matmul")
    return out


def causal_conv(u, w):
    """Depthwise causal convolution along the sequence: out[t] = Σ_i u[t−i] ·
    w[cw−1−i].  u: (B, S, C); w: (cw, C)."""
    cw, S = w.shape[0], u.shape[1]
    up = F.pad(u, (0, 0, cw - 1, 0))
    return sum(up[:, j:j + S] * w[j] for j in range(cw))


def ssd(x, dt, A, Bm, Cm, Q: int):
    """y_t = Σ_{s ≤ t} C_t·B_s · exp(Σ_{s<r≤t} dt_r A) · dt_s x_s, computed a
    chunk of Q at a time.  x: (B, S, H, P); dt: (B, S, H); A: (H,);
    Bm, Cm: (B, S, G, N) with head h reading group h // (H / G)."""
    Bt, S, H, P = x.shape
    G = Bm.shape[2]
    nc = S // Q
    rep = H // G
    X = (x * dt[..., None]).reshape(Bt, nc, Q, H, P)
    a = (dt * A).reshape(Bt, nc, Q, H)
    Bc = Bm.repeat_interleave(rep, dim=2).reshape(Bt, nc, Q, H, -1)
    Cc = Cm.repeat_interleave(rep, dim=2).reshape(Bt, nc, Q, H, -1)
    cum = torch.cumsum(a, dim=2)                                          # (B,nc,Q,H)
    causal = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]                   # (B,nc,Q,Q,H)
    decay = torch.exp(torch.where(causal[None, None, :, :, None], seg, float("-inf")))
    scores = torch.einsum("bcihn,bcjhn->bcijh", Cc, Bc) * decay
    y = torch.einsum("bcijh,bcjhp->bcihp", scores, X)
    # the state each chunk leaves, then the state entering each chunk
    last = cum[:, :, -1]                                                  # (B,nc,H)
    states = torch.einsum("bcjhn,bcjh,bcjhp->bchpn", Bc, torch.exp(last[:, :, None] - cum), X)
    h = torch.zeros_like(states[:, 0])
    entering = []
    for c in range(nc):
        entering.append(h)
        h = h * torch.exp(last[:, c])[:, :, None, None] + states[:, c]
    entering = torch.stack(entering, dim=1)                               # (B,nc,H,P,N)
    y = y + torch.einsum("bcihn,bchpn,bcih->bcihp", Cc, entering, torch.exp(cum))
    return y.reshape(Bt, S, H, P)


def layer(x, ln1, wz, wx, wbc, wdt, conv_x, conv_bc, A_log, dt_bias, Dskip, norm, wo, *,
          model, prec):
    k = dims(model)
    eps = model["norm_eps"]
    Bt, S, _ = x.shape
    h = common.rmsnorm(x, ln1, eps)
    z = common.mm(h, wz, prec)
    xin = F.silu(causal_conv(common.mm(h, wx, prec), conv_x))
    bc = F.silu(causal_conv(common.mm(h, wbc, prec), conv_bc))
    Bm, Cm = bc.reshape(Bt, S, 2 * k["G"], k["N"]).split(k["G"], dim=2)
    dt = F.softplus(common.mm(h, wdt, prec) + dt_bias)
    xh = xin.reshape(Bt, S, k["nh"], k["hp"])
    y = ssd(xh, dt, -torch.exp(A_log), Bm, Cm, min(k["Q"], S))
    y = (y + xh * Dskip[:, None]).reshape(Bt, S, k["di"])
    y = common.rmsnorm(y * F.silu(z), norm, eps)
    return x + common.mm(y, wo, prec)


LAYER_LEAVES = ("ln1/scale", "mixer/wz", "mixer/wx", "mixer/wbc", "mixer/wdt", "mixer/conv_x",
                "mixer/conv_bc", "mixer/A_log", "mixer/dt_bias", "mixer/D", "mixer/norm",
                "mixer/wo")


def loss(params: dict, model: dict, inputs, labels, prec: str):
    x = common.embed(params["embed/table"], inputs, model["d_model"])
    for i in range(model["n_layers"]):
        args = [params["scan/0/" + name][i] for name in LAYER_LEAVES]
        x = checkpoint(layer, x, *args, model=model, prec=prec, use_reentrant=False)
    x = common.rmsnorm(x, params["final_norm/scale"], model["norm_eps"])
    head = params["embed/table"].T if model["tie_embeddings"] else params["head/w"]
    return common.lm_loss(x, head, labels, 0.0, prec)
