"""Mixture-of-Experts layer: top-k routing with sort-based (gather/scatter)
capacity dispatch, Switch-style load-balance aux loss.

The same arithmetic as the reference, in static shapes and without a host
synchronisation: no ``.item()``, no ``nonzero``, no boolean indexing, no loop
over tokens.  Each batch row is a routing group.  Ties are broken as the
reference breaks them (trap T7): the top k come from a stable descending sort
of the gates (``jax.lax.top_k`` puts the lower index first among equal
values; ``torch.topk`` promises no order), and the dispatch order is a stable
sort of the chosen experts (``jnp.argsort(stable=True)``).

Deterministic on the GPU.  The combine gathers each token's K expert outputs
back into token order and sums them over K (a reduction: fp32 accumulation,
one cast to the activation dtype) instead of ``index_add_``, whose atomics
would add the K entries in another order from one run to the next.  The
reference scatter-adds them into bf16 zeros, so in bf16 the two round
differently (``docs/torch_port.md``, tolerances).  In the backward the index
ops add at most one nonzero value into each element (the dispatch's slots and
the combine's kept entries are distinct; a dropped entry's gradient is 0), so
their atomics cannot reorder a sum.

The experts' products are ``torch.bmm`` (cuBLAS) over an expert-major table
(E, B·C, D) of the dispatched rows: the reference computes them with
``jnp.einsum`` outside any kernel, over (B, E, C, D).  Its ``shard``
annotations wait for the distribution slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.remat_policy import checkpoint_name
from .layers import PSpec


def moe_specs(cfg) -> dict:
    e = cfg.moe
    d, f, E = cfg.d_model, e.d_ff_expert, e.n_experts
    specs = {
        "router": PSpec((d, E), ("embed", None), "float32", "small"),
        "wi": PSpec((E, d, f), ("experts", "embed", None)),
        "wo": PSpec((E, f, d), ("experts", None, "embed")),
    }
    if cfg.mlp in ("swiglu", "geglu"):
        specs["wg"] = PSpec((E, d, f), ("experts", "embed", None))
    return specs


def _capacity(tokens_per_group: int, cfg) -> int:
    e = cfg.moe
    c = int(e.capacity_factor * tokens_per_group * e.top_k / e.n_experts)
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


def _top_k(gates, K: int):
    """(values, indices) of the K largest gates along the last dim, largest
    first and the lower index first among equal values, as
    ``jax.lax.top_k``."""
    idx = torch.sort(gates, dim=-1, descending=True, stable=True).indices[..., :K]
    return gates.gather(-1, idx), idx


def _route(p, x, cfg):
    """fp32 router: (gates (B,S,E), top gates (B,S,K) renormalised by
    max(sum, 1e-9), their experts (B,S,K))."""
    gates = torch.softmax(x.float() @ p["router"].float(), dim=-1)
    top_gate, top_idx = _top_k(gates, cfg.moe.top_k)
    top_gate = top_gate / top_gate.sum(-1, keepdim=True).clamp_min(1e-9)
    return gates, top_gate, top_idx


def _aux_loss(gates, top_idx, E: int):
    """Switch: E · Σ_e me·ce, ``ce`` from the first choice only (no gradient
    through it)."""
    me = gates.mean(dim=(0, 1))
    ce = F.one_hot(top_idx[..., 0], E).float().mean(dim=(0, 1))
    return E * torch.sum(me * ce)


def _dispatch_slots(top_idx, E: int, C: int):
    """The slot ``e·C + rank`` of each token's K entries within its group, in
    token order (entry j = token j // K, choice j % K): the rank within the
    expert is taken over the stable sort of the entries by expert, and an
    entry of rank ≥ C is dropped to the overflow slot ``E·C``."""
    B, S, K = top_idx.shape
    flat_e = top_idx.reshape(B, S * K)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = flat_e.gather(1, order)
    experts = torch.arange(E, device=se.device, dtype=se.dtype).expand(B, E).contiguous()
    starts = torch.searchsorted(se, experts)                     # (B,E): first entry of e
    rank = torch.arange(S * K, device=se.device) - starts.gather(1, se)
    dest = torch.where(rank < C, se * C + rank, E * C)
    # back to token order through the inverse of the permutation ``order``
    return torch.empty_like(dest).scatter_(1, order, dest)


def _table_rows(slot, B: int, C: int):
    """Group b's slot e·C + r → row (e·B + b)·C + r of the expert-major
    (E·B·C, D) table that the expert products take as (E, B·C, D)."""
    b = torch.arange(B, device=slot.device)[:, None]
    return ((slot // C) * B + b) * C + slot % C


def _expert_ffn(p, disp, cfg):
    """disp (E, B·C, D) → (E, B·C, D), one batched product an expert matrix.
    GELU is the tanh approximation (T3)."""
    h = torch.bmm(disp, p["wi"])
    if cfg.mlp == "swiglu":
        h = F.silu(torch.bmm(disp, p["wg"])) * h
    elif cfg.mlp == "geglu":
        h = F.gelu(torch.bmm(disp, p["wg"]), approximate="tanh") * h
    else:
        h = F.gelu(h, approximate="tanh")
    h = checkpoint_name(h, "moe_hidden")
    return torch.bmm(h, p["wo"])


def moe_apply(p: dict, x, cfg):
    """x: (B, S, D) → (y (B, S, D), aux_loss fp32 scalar).  Each batch row
    is a routing group of S tokens with ``_capacity(S, cfg)`` slots an
    expert; entries past them are dropped (they add nothing to y)."""
    e = cfg.moe
    B, S, D = x.shape
    E, K = e.n_experts, e.top_k
    C = _capacity(S, cfg)

    gates, top_gate, top_idx = _route(p, x, cfg)
    aux_loss = _aux_loss(gates, top_idx, E)
    dest = _dispatch_slots(top_idx, E, C).reshape(B, S * K)
    keep = dest < E * C
    # a dropped entry reads the group's last slot (and is weighted by 0)
    row = _table_rows(dest.clamp_max(E * C - 1), B, C).reshape(-1)

    # dispatch: each entry's row of x to its slot; the overflow row E·B·C
    # takes the dropped ones and is cut off
    src = x[:, :, None, :].expand(B, S, K, D).reshape(B * S * K, D)
    disp = torch.zeros((E * B * C + 1, D), dtype=x.dtype, device=x.device)
    disp = disp.index_copy_(0, torch.where(keep.reshape(-1), row, E * B * C), src)
    out_e = _expert_ffn(p, disp[:-1].view(E, B * C, D), cfg)

    # combine in token order: the gate (times keep) cast to the activation
    # dtype before the product, then the K entries of a token summed
    vals = out_e.reshape(E * B * C, D).index_select(0, row)
    w = (top_gate.reshape(-1) * keep.reshape(-1)).to(vals.dtype)
    y = (vals * w[:, None]).reshape(B, S, K, D).sum(dim=2)
    return y, aux_loss
