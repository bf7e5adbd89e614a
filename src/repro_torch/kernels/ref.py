"""Plain PyTorch oracles of the kernels (the allclose ground truth):
flash attention (the S×T score matrix is materialised), RMSNorm, one AdamW
step, and the Mamba-2 SSD chunk (the Q×Q decay matrix is materialised)."""

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


def rmsnorm_ref(x, scale, eps: float = 1e-6):
    """Per row of ``x`` (..., d): ``x·rsqrt(mean(x²) + eps)·(1 + scale)``,
    all in fp32 and cast once at the end — the kernels' rounding order, not
    the model's ``layers.rmsnorm`` (which casts before the product)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)


def fused_adam_ref(p, g, m, v, *, lr, b1=0.9, b2=0.95, eps=1e-8,
                   weight_decay=0.0, count=1):
    """One AdamW step: fp32 math, weight decay on the old ``p``, each result
    cast to its buffer's dtype.  ``count`` is the post-increment step (an int
    or an int32 tensor).  Returns new ``(p', m', v')``."""
    count = torch.as_tensor(count, dtype=torch.float32, device=p.device)
    g32 = g.float()
    m32 = b1 * m.float() + (1 - b1) * g32
    v32 = b2 * v.float() + (1 - b2) * torch.square(g32)
    c1 = 1.0 - b1 ** count
    c2 = 1.0 - b2 ** count
    upd = (m32 / c1) / (torch.sqrt(v32 / c2) + eps)
    p32 = p.float()
    p32 = p32 - lr * (upd + weight_decay * p32)
    return p32.to(p.dtype), m32.to(m.dtype), v32.to(v.dtype)


def ssd_intra(x, dt, b, c, a):
    """Mamba-2 SSD within each chunk, in the model's layout.

    x (Bt,nc,Q,H,hp); dt (Bt,nc,Q,H); b/c (Bt,nc,Q,G,N) with head ``h``
    reading group ``h // (H/G)``; a (H,) negative decay rates.  Returns
    ``(y, states, cum)``: y (Bt,nc,Q,H,hp) in x's dtype, states
    (Bt,nc,H,N,hp) fp32, cum (Bt,nc,Q,H) fp32, where

        cum     = cumsum(dt)·a
        L_ij    = exp(cum_i − cum_j) for i ≥ j, else 0
        y       = ((C Bᵀ) ⊙ L) @ (x·dt)
        states  = (B · exp(cum_Q − cum))ᵀ @ (x·dt)

    The exponent is masked *before* ``exp``: for i < j it is positive and
    overflows once a chunk decays by more than ~88, and the gradient of
    ``where(mask, exp(·), 0)`` is then 0·inf = NaN.  Masking first gives the
    same forward values and finite gradients."""
    Bt, nc, Q, H, hp = x.shape
    G, N = b.shape[3], b.shape[4]
    R = H // G
    xf = x.float().reshape(Bt, nc, Q, G, R, hp)
    dtf = dt.float().reshape(Bt, nc, Q, G, R)
    bf, cf = b.float(), c.float()
    cum = torch.cumsum(dtf, dim=2) * a.float().reshape(G, R)         # (Bt,nc,Q,G,R)
    mask = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    seg = cum[:, :, :, None] - cum[:, :, None, :]                     # (Bt,nc,Q,Q,G,R)
    decay = torch.exp(torch.where(mask[:, :, None, None], seg, float("-inf")))
    cb = torch.einsum("bcign,bcjgn->bcijg", cf, bf)                   # per group
    att = cb[..., None] * decay
    dtx = xf * dtf[..., None]
    y = torch.einsum("bcijgr,bcjgrp->bcigrp", att, dtx)
    sdecay = torch.exp(cum[:, :, -1:] - cum)                          # (Bt,nc,Q,G,R)
    states = torch.einsum("bcjgrn,bcjgrp->bcgrnp", bf[:, :, :, :, None] * sdecay[..., None],
                          dtx)
    return (y.reshape(Bt, nc, Q, H, hp).to(x.dtype),
            states.reshape(Bt, nc, H, N, hp), cum.reshape(Bt, nc, Q, H))


def ssd_chunk_ref(x, dt, b, c, a):
    """The reference's layout: x (BH,nc,Q,hp); dt (BH,nc,Q); b/c
    (BH,nc,Q,N); a (BH,).  Returns (y (BH,nc,Q,hp), states (BH,nc,N,hp)
    fp32, cum (BH,nc,Q) fp32)."""
    y, states, cum = ssd_intra(*to_heads(x, dt, b, c), a)
    return from_heads(y, states, cum)


def to_heads(x, dt, b, c):
    """(BH,nc,Q,·) → the model's layout with Bt = 1 and H = G = BH (views)."""
    return (x.permute(1, 2, 0, 3)[None], dt.permute(1, 2, 0)[None],
            b.permute(1, 2, 0, 3)[None], c.permute(1, 2, 0, 3)[None])


def from_heads(y, states, cum):
    """Inverse of ``to_heads`` for the three outputs (views)."""
    return y[0].permute(2, 0, 1, 3), states[0].permute(1, 0, 2, 3), cum[0].permute(2, 0, 1)
