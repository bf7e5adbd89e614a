"""Attention mixers: GQA self-attention, full or sliding-window, with three
branches — the flash kernels (``cfg.use_flash``), the online-softmax chunked
variant, and the dense one — and MLA (multi-head latent attention), plus
single-token decode steps against KV caches.

The decode steps write the new token's keys into the cache **in place** and
return the same tensors.  ``pos`` is a Python ``int``, the number of tokens
already in the cache; a write past the cache's end raises (the reference's
``dynamic_update_slice`` clamps it onto the last slot).  ``local`` layers
keep a ring of ``T`` slots and write slot ``pos % T``.
"""

from __future__ import annotations

import math

import torch

from ..core.remat_policy import checkpoint_name
from ..kernels.ref import NEG_INF
from .layers import PSpec, apply_rope, norm


def attn_specs(cfg) -> dict:
    d, hd = cfg.d_model, cfg.head_dim_
    H, Kv = cfg.n_heads, cfg.n_kv_heads
    return {
        "wq": PSpec((d, H * hd), ("embed", "heads")),
        "wk": PSpec((d, Kv * hd), ("embed", "kv_heads")),
        "wv": PSpec((d, Kv * hd), ("embed", "kv_heads")),
        "wo": PSpec((H * hd, d), ("heads", "embed")),
    }


def _qkv(p, x, cfg, positions):
    B, S, _ = x.shape
    H, Kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (x @ p["wk"]).reshape(B, S, Kv, hd)
    v = (x @ p["wv"]).reshape(B, S, Kv, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    q = checkpoint_name(q, "qkv")
    return q, k, v


def _causal_mask(S: int, T: int, window: int | None, q_offset: int = 0,
                 device=None):
    qi = torch.arange(S, device=device)[:, None] + q_offset
    ki = torch.arange(T, device=device)[None, :]
    m = ki <= qi
    if window is not None:
        m &= (qi - ki) < window
    return m


def gqa_attention(p, x, cfg, positions, window: int | None = None):
    """Training / prefill self-attention.  x: (B,S,D) → (B,S,D)."""
    B, S, D = x.shape
    H, Kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    G = H // Kv
    q, k, v = _qkv(p, x, cfg, positions)

    if cfg.use_flash and S % 128 == 0:
        # the hand-written kernels (plain version for CPU tensors)
        from ..kernels.ops import flash_attention
        ctx = flash_attention(q, k, v, True, window)
    elif cfg.attn_chunked and S > cfg.attn_chunk:
        ctx = _chunked_attention(q.reshape(B, S, Kv, G, hd), k, v,
                                 cfg.attn_chunk, window)
    else:
        # scores are scaled after the product; probabilities are cast to the
        # activation dtype before they meet v
        qg = q.reshape(B, S, Kv, G, hd)
        scale = 1.0 / math.sqrt(hd)
        scores = torch.einsum("bskgd,btkd->bkgst", qg, k) * scale
        mask = _causal_mask(S, S, window, device=x.device)
        scores = torch.where(mask[None, None, None], scores, NEG_INF)
        probs = torch.softmax(scores.float(), dim=-1).to(x.dtype)
        ctx = torch.einsum("bkgst,btkd->bskgd", probs, v)

    ctx = checkpoint_name(ctx.reshape(B, S, H * hd), "attn_out")
    return ctx @ p["wo"]


def _chunked_attention(q, k, v, chunk: int, window: int | None):
    """Online softmax over key chunks.  q: (B,S,Kv,G,hd); k/v: (B,T,Kv,hd)."""
    B, S, Kv, G, hd = q.shape
    T = k.shape[1]
    if T % chunk:
        raise ValueError(f"sequence length {T} is not a multiple of the chunk {chunk}")
    scale = 1.0 / math.sqrt(hd)
    m = torch.full((B, Kv, G, S), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Kv, G, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, S, Kv, G, hd), dtype=torch.float32, device=q.device)
    qi = torch.arange(S, device=q.device)[:, None]
    for ci in range(T // chunk):
        kb = k[:, ci * chunk:(ci + 1) * chunk]
        vb = v[:, ci * chunk:(ci + 1) * chunk]
        s = torch.einsum("bskgd,btkd->bkgst", q, kb).float() * scale
        ki = torch.arange(chunk, device=q.device)[None, :] + ci * chunk
        mask = ki <= qi
        if window is not None:
            mask &= (qi - ki) < window
        s = torch.where(mask[None, None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.max(dim=-1).values)
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bkgst,btkd->bskgd", p.to(vb.dtype), vb)
        acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv
        m = m_new
    out = acc / l.clamp_min(1e-30).permute(0, 3, 1, 2)[..., None]
    return out.to(q.dtype)


def _cache_slot(pos: int, T: int, window: int | None) -> int:
    """The cache slot the token at ``pos`` goes to: ``pos % T`` in a ring
    (``local``), else ``pos``, which must lie inside the cache."""
    if pos < 0:
        raise ValueError(f"decode position {pos} is negative")
    if window is not None:
        return pos % T
    if pos >= T:
        raise ValueError(f"decode position {pos} is past the cache's {T} slots")
    return pos


def _positions(x, pos: int):
    return torch.full((x.shape[0], 1), pos, dtype=torch.int32, device=x.device)


def attn_decode_step(p, x, k_cache, v_cache, pos: int, cfg, window: int | None = None):
    """One-token decode.  x: (B,1,D); caches: (B,T,Kv,hd), written in place;
    pos: the number of tokens already in the cache.  Returns
    (y, k_cache, v_cache)."""
    B = x.shape[0]
    H, Kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    G = H // Kv
    T = k_cache.shape[1]
    slot = _cache_slot(pos, T, window)
    q, k, v = _qkv(p, x, cfg, _positions(x, pos))
    k_cache[:, slot] = k[:, 0].to(k_cache.dtype)
    v_cache[:, slot] = v[:, 0].to(v_cache.dtype)

    # query heads grouped (Kv, G) as in the forward; scaled after the product
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, Kv, G, hd)
    scores = torch.einsum("bkgd,btkd->bkgt", qg, k_cache.to(q.dtype)) * scale
    if window is not None and pos >= T:
        valid = torch.ones(T, dtype=torch.bool, device=x.device)
    else:
        valid = torch.arange(T, device=x.device) <= slot
    scores = torch.where(valid[None, None, None], scores, NEG_INF)
    probs = torch.softmax(scores.float(), dim=-1).to(x.dtype)
    ctx = torch.einsum("bkgt,btkd->bkgd", probs, v_cache.to(x.dtype))
    return ctx.reshape(B, 1, H * hd) @ p["wo"], k_cache, v_cache


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention, MiniCPM3 / DeepSeek-V2)
# ---------------------------------------------------------------------------


def mla_specs(cfg) -> dict:
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    return {
        "wdq": PSpec((d, m.q_lora_rank), ("embed", None)),
        "q_ln": PSpec((m.q_lora_rank,), (None,), "float32", "zeros"),
        "wuq": PSpec((m.q_lora_rank, H * m.qk_head_dim), (None, "heads")),
        "wdkv": PSpec((d, m.kv_lora_rank), ("embed", None)),
        "kv_ln": PSpec((m.kv_lora_rank,), (None,), "float32", "zeros"),
        "wkr": PSpec((d, m.qk_rope_dim), ("embed", None)),
        "wun": PSpec((m.kv_lora_rank, H * m.qk_nope_dim), (None, "heads")),
        "wuv": PSpec((m.kv_lora_rank, H * m.v_head_dim), (None, "heads")),
        "wo": PSpec((H * m.v_head_dim, d), ("heads", "embed")),
    }


def _mla_query(p, x, cfg, positions):
    """(q_nope (B,S,H,nope), q_rope (B,S,H,rope) rotated)."""
    m = cfg.mla
    B, S, _ = x.shape
    cq = norm(x @ p["wdq"], p["q_ln"], cfg)
    q = (cq @ p["wuq"]).reshape(B, S, cfg.n_heads, m.qk_head_dim)
    q_nope, q_rope = q.split([m.qk_nope_dim, m.qk_rope_dim], dim=-1)
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_latent(p, x, cfg, positions):
    """(ckv (B,S,r) normalised, k_rope (B,S,rope) rotated): what the cache
    holds a token."""
    ckv = norm(x @ p["wdkv"], p["kv_ln"], cfg)
    k_rope = apply_rope((x @ p["wkr"])[:, :, None, :], positions, cfg.rope_theta)
    return ckv, k_rope[:, :, 0]


def mla_attention(p, x, cfg, positions):
    """Training / prefill MLA with K and V made explicit.  x: (B,S,D) →
    (B,S,D).  The two score products are added, then scaled; the
    probabilities are cast to the activation dtype before they meet v."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    q_nope, q_rope = _mla_query(p, x, cfg, positions)
    ckv, k_rope = _mla_latent(p, x, cfg, positions)
    k_nope = (ckv @ p["wun"]).reshape(B, S, H, m.qk_nope_dim)
    v = (ckv @ p["wuv"]).reshape(B, S, H, m.v_head_dim)

    scale = 1.0 / math.sqrt(m.qk_head_dim)
    scores = (torch.einsum("bshd,bthd->bhst", q_nope, k_nope)
              + torch.einsum("bshd,btd->bhst", q_rope, k_rope)) * scale
    mask = _causal_mask(S, S, None, device=x.device)
    scores = torch.where(mask[None, None], scores, NEG_INF)
    probs = torch.softmax(scores.float(), dim=-1).to(x.dtype)
    ctx = torch.einsum("bhst,bthd->bshd", probs, v).reshape(B, S, H * m.v_head_dim)
    ctx = checkpoint_name(ctx, "attn_out")
    return ctx @ p["wo"]


def mla_decode_step(p, x, ckv_cache, kr_cache, pos: int, cfg):
    """Absorbed-matrices MLA decode: attention runs in the latent space, so
    the cache holds ``kv_lora_rank + qk_rope_dim`` values a token.  x:
    (B,1,D); ckv_cache (B,T,r) and kr_cache (B,T,rope), written in place.
    Returns (y, ckv_cache, kr_cache)."""
    m = cfg.mla
    B = x.shape[0]
    H = cfg.n_heads
    T = ckv_cache.shape[1]
    slot = _cache_slot(pos, T, None)
    positions = _positions(x, pos)
    q_nope, q_rope = _mla_query(p, x, cfg, positions)
    ckv, k_rope = _mla_latent(p, x, cfg, positions)
    ckv_cache[:, slot] = ckv[:, 0].to(ckv_cache.dtype)
    kr_cache[:, slot] = k_rope[:, 0].to(kr_cache.dtype)

    # W_un absorbed into the query: q_lat (B,H,r)
    wun = p["wun"].reshape(m.kv_lora_rank, H, m.qk_nope_dim)
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0], wun)
    scale = 1.0 / math.sqrt(m.qk_head_dim)
    scores = (torch.einsum("bhr,btr->bht", q_lat, ckv_cache.to(x.dtype))
              + torch.einsum("bhd,btd->bht", q_rope[:, 0], kr_cache.to(x.dtype))) * scale
    valid = torch.arange(T, device=x.device) <= slot
    scores = torch.where(valid[None, None], scores, NEG_INF)
    probs = torch.softmax(scores.float(), dim=-1).to(x.dtype)
    ctx_lat = torch.einsum("bht,btr->bhr", probs, ckv_cache.to(x.dtype))
    wuv = p["wuv"].reshape(m.kv_lora_rank, H, m.v_head_dim)
    ctx = torch.einsum("bhr,rhd->bhd", ctx_lat, wuv).reshape(B, 1, H * m.v_head_dim)
    return ctx @ p["wo"], ckv_cache, kr_cache
