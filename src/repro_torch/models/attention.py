"""Attention mixer: GQA self-attention, full or sliding-window, with three
branches — the flash kernels (``cfg.use_flash``), the online-softmax chunked
variant, and the dense one.  Decode steps and MLA belong to later slices.
"""

from __future__ import annotations

import math

import torch

from ..kernels.ref import NEG_INF
from .layers import PSpec, apply_rope


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

    return ctx.reshape(B, S, H * hd) @ p["wo"]


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
