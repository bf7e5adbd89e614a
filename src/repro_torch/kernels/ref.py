"""Dense fp32 oracle for the flash-attention kernels (the allclose ground
truth; the S×T score matrix is materialised)."""

from __future__ import annotations

import math

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def attention_mask(S: int, T: int, causal: bool, window: int | None, device):
    """(S, T) bool: key ``k`` is visible from query ``q`` (at absolute
    position ``q + T - S``) if ``k <= q`` (causal) and ``q - k < window``."""
    qi = torch.arange(S, device=device)[:, None] + (T - S)
    ki = torch.arange(T, device=device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        mask &= ki <= qi
    if window is not None:
        mask &= (qi - ki) < window
    return mask


def flash_attention_ref(q, k, v, causal: bool = True,
                        window: int | None = None, scale: float | None = None):
    """q: (B,S,H,hd); k/v: (B,T,Kv,hd) with H = Kv·G.  fp32 softmax."""
    B, S, H, hd = q.shape
    T, Kv = k.shape[1], k.shape[2]
    G = H // Kv
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(B, S, Kv, G, hd)
    s = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) * scale
    mask = attention_mask(S, T, causal, window, q.device)
    s = torch.where(mask[None, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return o.reshape(B, S, H, hd).to(q.dtype)
