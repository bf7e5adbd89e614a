"""fp32 reference of the ``moe`` family: a decoder whose every layer is
causal multi-head attention with rotary embeddings followed by a
Mixture-of-Experts layer (OLMoE, arXiv:2409.02060), as the port lays out its
parameters.

The MoE layer (Switch Transformer's routing with top-k, arXiv:2101.03961):
an fp32 router and softmax over the E experts; each token's k largest gates,
divided by their sum; each batch row a routing group in which an expert takes
at most C = max(8, ⌈int(capacity_factor · S · k / E) / 8⌉ · 8) entries, in
token order (token by token, its choices in order of rank), and drops the
rest; each expert a SwiGLU feed-forward; a token's output the gate-weighted
sum of its kept entries.  The load-balance term is E · Σ_e mean_gate_e ·
share_e, where share_e is the share of tokens whose first choice is e (no
gradient through it).

Departure from the published OLMoE, as in the system: no QK-norm.  Each
layer runs under ``checkpoint``.  Imports ``torch`` and ``common`` only.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference import common

#: query rows a block of the attention, so that one block's scores are formed
#: at a time
ATTN_BLOCK = 1024


def leaves(model: dict) -> dict:
    """Every parameter: path → (shape, dtype, init, role), as ``ssm.leaves``;
    ``expert`` marks a weight of the experts, of which each token uses k of E."""
    D, V, L, pd = model["d_model"], model["vocab"], model["n_layers"], model["param_dtype"]
    H, Kv, hd = model["n_heads"], model["n_kv_heads"], model["head_dim"]
    e = model["moe"]
    E, F_ = e["n_experts"], e["d_ff_expert"]
    out = {
        "embed/table": ((V, D), pd, "small", "embed"),
        "scan/0/ln1/scale": ((L, D), "float32", "zeros", "other"),
        "scan/0/attn/wq": ((L, D, H * hd), pd, "fan_in", "matmul"),
        "scan/0/attn/wk": ((L, D, Kv * hd), pd, "fan_in", "matmul"),
        "scan/0/attn/wv": ((L, D, Kv * hd), pd, "fan_in", "matmul"),
        "scan/0/attn/wo": ((L, H * hd, D), pd, "fan_in", "matmul"),
        "scan/0/ln2/scale": ((L, D), "float32", "zeros", "other"),
        "scan/0/moe/router": ((L, D, E), e["router_dtype"], "small", "matmul"),
        "scan/0/moe/wi": ((L, E, D, F_), pd, "fan_in", "expert"),
        "scan/0/moe/wg": ((L, E, D, F_), pd, "fan_in", "expert"),
        "scan/0/moe/wo": ((L, E, F_, D), pd, "fan_in", "expert"),
        "final_norm/scale": ((D,), "float32", "zeros", "other"),
    }
    if not model["tie_embeddings"]:
        out["head/w"] = ((D, V), pd, "small", "matmul")
    return out


def attention(x, wq, wk, wv, wo, model, prec):
    B, S, _ = x.shape
    H, Kv, hd = model["n_heads"], model["n_kv_heads"], model["head_dim"]
    q = common.rope(common.mm(x, wq, prec).reshape(B, S, H, hd), model["rope_theta"])
    k = common.rope(common.mm(x, wk, prec).reshape(B, S, Kv, hd), model["rope_theta"])
    v = common.mm(x, wv, prec).reshape(B, S, Kv, hd)
    k = k.repeat_interleave(H // Kv, dim=2)
    v = v.repeat_interleave(H // Kv, dim=2)
    out = []
    for q0 in range(0, S, ATTN_BLOCK):
        q1 = min(q0 + ATTN_BLOCK, S)
        s = torch.einsum("bshd,bthd->bhst", q[:, q0:q1], k[:, :q1]) / math.sqrt(hd)
        mask = (torch.arange(q1, device=x.device)[None, :]
                <= torch.arange(q0, q1, device=x.device)[:, None])
        p = torch.softmax(torch.where(mask, s, float("-inf")), dim=-1)
        out.append(torch.einsum("bhst,bthd->bshd", p, v[:, :q1]))
    return common.mm(torch.cat(out, dim=1).reshape(B, S, H * hd), wo, prec)


def capacity(S: int, e: dict) -> int:
    c = int(e["capacity_factor"] * S * e["top_k"] / e["n_experts"])
    return max(8, -(-c // 8) * 8)


def moe(x, router, wi, wg, wo, model, prec):
    """(y (B, S, D), load-balance term)."""
    e = model["moe"]
    B, S, D = x.shape
    E, K = e["n_experts"], e["top_k"]
    gates = torch.softmax(x @ router, dim=-1)                         # fp32 router
    top_gate, top_idx = torch.topk(gates, K, dim=-1)
    top_gate = top_gate / top_gate.sum(-1, keepdim=True).clamp_min(1e-9)
    share = F.one_hot(top_idx[..., 0], E).float().mean(dim=(0, 1))
    aux = E * torch.sum(gates.mean(dim=(0, 1)) * share)

    # each entry's rank among its expert's entries of the row, in token order
    flat = top_idx.reshape(B, S * K)
    onehot = F.one_hot(flat, E)
    rank = (torch.cumsum(onehot, dim=1) * onehot).sum(-1) - 1
    kept = (rank < capacity(S, e)).reshape(-1)
    row = torch.arange(B, device=x.device)[:, None].expand(B, S * K).reshape(-1)
    tok = row * S + torch.arange(S * K, device=x.device).repeat(B) // K
    expert = flat.reshape(-1)[kept]
    order = torch.argsort(expert, stable=True)
    tok, expert = tok[kept][order], expert[order]
    gate = top_gate.reshape(-1)[kept][order]
    counts = torch.bincount(expert, minlength=E).tolist()
    src = x.reshape(B * S, D)[tok]
    outs, start = [], 0
    for i, n in enumerate(counts):
        rows = src[start:start + n]
        hid = F.silu(common.mm(rows, wg[i], prec)) * common.mm(rows, wi[i], prec)
        outs.append(common.mm(hid, wo[i], prec))
        start += n
    vals = torch.cat(outs) * gate[:, None]
    y = torch.zeros(B * S, D, dtype=x.dtype, device=x.device).index_add(0, tok, vals)
    return y.reshape(B, S, D), aux


def layer(x, ln1, wq, wk, wv, wo, ln2, router, wi, wg, wo_e, *, model, prec):
    eps = model["norm_eps"]
    x = x + attention(common.rmsnorm(x, ln1, eps), wq, wk, wv, wo, model, prec)
    y, aux = moe(common.rmsnorm(x, ln2, eps), router, wi, wg, wo_e, model, prec)
    return x + y, aux


LAYER_LEAVES = ("ln1/scale", "attn/wq", "attn/wk", "attn/wv", "attn/wo", "ln2/scale",
                "moe/router", "moe/wi", "moe/wg", "moe/wo")


def loss(params: dict, model: dict, inputs, labels, prec: str):
    x = common.embed(params["embed/table"], inputs, model["d_model"])
    aux = 0.0
    for i in range(model["n_layers"]):
        args = [params["scan/0/" + name][i] for name in LAYER_LEAVES]
        x, a = checkpoint(layer, x, *args, model=model, prec=prec, use_reentrant=False)
        aux = aux + a
    x = common.rmsnorm(x, params["final_norm/scale"], model["norm_eps"])
    head = params["embed/table"].T if model["tie_embeddings"] else params["head/w"]
    return common.lm_loss(x, head, labels, aux, prec)
