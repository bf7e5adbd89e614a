"""Flash attention on the GPU: ctypes wrappers of the three hand-written CUDA
kernels (forward, dq, dk/dv; sources in ``csrc/``) and, beside each, the
plain PyTorch version of the same arithmetic.

Layouts are the model's: q/o/do/dq ``(B,S,H,hd)``, k/v/dk/dv ``(B,T,Kv,hd)``
with ``H = Kv·G`` (q-head ``h`` reads kv-head ``h // G``); ``lse`` and
``delta`` are ``(B,H,S)`` fp32.  Query row ``s`` sits at absolute position
``s + (T − S)``.  The kernels read these strides directly; nothing is
transposed or copied on the way in.

Each C entry point chooses its kernel by the input type, not as a fallback:
bf16 runs a kernel on ``wgmma`` fed by TMA (``flash_fwd_wg_kernel``,
``flash_dq_wg_kernel``, ``flash_dkv_wg_kernel``: p and ds rounded to bf16
before the second products), fp32 the IEEE fp32 FMA kernel.

The plain versions are the tile-free statement of what the kernels compute:
forward returns ``(o, lse)``; the backward ones are the explicit recompute
formulas (``p = exp(s − lse)``, ``ds = p·(do·vᵀ − delta)·scale``), not
autograd of the forward.  They run for CPU tensors and as the comparison on
the card; a CUDA tensor never reaches them through ``kernels.ops``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .build import launch
from .ref import NEG_INF, attention_mask

#: head dims the kernels are instantiated for
HEAD_DIMS = (16, 32, 64, 128, 256)
#: S and T must be multiples of this (the kernels' largest tile edge)
TILE = 64

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# (q, k, v, ..., B, S, T, H, Kv, hd, causal, window, scale, is_bf16[, stream])
_TAIL = [_I, _I, _I, _I, _I, _I, _I, _I, _F, _I]
_ARGTYPES = {
    "flash_fwd": [_VP] * 5 + _TAIL,           # q k v o lse
    "flash_dq": [_VP] * 7 + _TAIL,            # q k v do lse delta dq
    "flash_dkv": [_VP] * 8 + _TAIL,           # q k v do lse delta dk dv
}


def _scale(hd: int, scale) -> float:
    return float(scale) if scale is not None else 1.0 / math.sqrt(hd)


# ---------------------------------------------------------------------------
# launching
# ---------------------------------------------------------------------------


def _check(q, k, v, window, *more):
    """Raise on anything the kernels do not take; returns the dims."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (B,S,H,hd), k/v (B,T,Kv,hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, hd = q.shape
    T, Kv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or Kv == 0 or H % Kv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not match")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if S % TILE or T % TILE or T < S:
        raise ValueError(f"need S, T multiples of {TILE} and T >= S; got S={S}, T={T}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None; got {window}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dtype {q.dtype} not supported (float32 or bfloat16)")
    for t in (q, k, v):
        if t.dtype != q.dtype:
            raise TypeError("q, k, v must share one dtype")
        if not t.is_contiguous():
            raise ValueError("q, k, v must be contiguous")
    for t, shape, dtype in more:
        if tuple(t.shape) != shape or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"expected contiguous {dtype} {shape}; "
                             f"got {t.dtype} {tuple(t.shape)}")
    tensors = (q, k, v, *(t for t, _, _ in more))
    # the kernels read rows 16 bytes at a time (float4, cp.async)
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("every tensor must start on a 16-byte boundary")
    if any(t.device.type != "cuda" or t.device != q.device for t in tensors):
        raise ValueError("all tensors must lie on one CUDA device")
    return B, S, T, H, Kv, hd


def _launch(name: str, q, ptrs, dims, causal, window, scale):
    B, S, T, H, Kv, hd = dims
    launch(name, _ARGTYPES[name], q.device, *[t.data_ptr() for t in ptrs],
           B, S, T, H, Kv, hd, int(bool(causal)),
           int(window) if window is not None else 0, _scale(hd, scale),
           int(q.dtype == torch.bfloat16))


def flash_fwd_cuda(q, k, v, causal=True, window=None, scale=None):
    """Launch ``csrc/flash_fwd.cu``.  Returns ``(o, lse)``."""
    dims = _check(q, k, v, window)
    B, S, _, H, _, _ = dims
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    _launch("flash_fwd", q, (q, k, v, o, lse), dims, causal, window, scale)
    return o, lse


def flash_dq_cuda(q, k, v, do, lse, delta, causal=True, window=None, scale=None):
    """Launch ``csrc/flash_dq.cu``.  Returns ``dq``."""
    B, S, H = q.shape[0], q.shape[1], q.shape[2]
    dims = _check(q, k, v, window, (do, tuple(q.shape), q.dtype),
                  (lse, (B, H, S), torch.float32),
                  (delta, (B, H, S), torch.float32))
    dq = torch.empty_like(q)
    _launch("flash_dq", q, (q, k, v, do, lse, delta, dq), dims, causal, window,
            scale)
    return dq


def flash_dkv_cuda(q, k, v, do, lse, delta, causal=True, window=None, scale=None):
    """Launch ``csrc/flash_dkv.cu``.  Returns ``(dk, dv)``, already summed
    over the GQA group inside the kernel."""
    B, S, H = q.shape[0], q.shape[1], q.shape[2]
    dims = _check(q, k, v, window, (do, tuple(q.shape), q.dtype),
                  (lse, (B, H, S), torch.float32),
                  (delta, (B, H, S), torch.float32))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_dkv", q, (q, k, v, do, lse, delta, dk, dv), dims, causal,
            window, scale)
    return dk, dv


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------


def _scores(q, k, causal, window, scale):
    """Masked, scaled fp32 scores (B,Kv,G,S,T); masked entries = NEG_INF."""
    B, S, H, hd = q.shape
    T, Kv = k.shape[1], k.shape[2]
    qg = q.reshape(B, S, Kv, H // Kv, hd).float()
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * _scale(hd, scale)
    if causal or window is not None:
        mask = attention_mask(S, T, causal, window, q.device)
        s = torch.where(mask[None, None, None], s, NEG_INF)
    return s


def flash_fwd_plain(q, k, v, causal=True, window=None, scale=None):
    """``o = softmax(mask(q·kᵀ·scale))·v`` and ``lse = m + log l``."""
    B, S, H, hd = q.shape
    s = _scores(q, k, causal, window, scale)
    m = s.max(dim=-1).values
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1).clamp_min(1e-30)
    o = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    o = o / l.permute(0, 3, 1, 2)[..., None]
    lse = (m + torch.log(l)).reshape(B, H, S)
    return o.reshape(B, S, H, hd).to(q.dtype), lse


def _p_ds(q, k, v, do, lse, delta, causal, window, scale):
    """Recomputed probabilities and score gradients, (B,Kv,G,S,T) fp32."""
    B, S, H, hd = q.shape
    Kv = k.shape[2]
    G = H // Kv
    s = _scores(q, k, causal, window, scale)
    p = torch.exp(s - lse.reshape(B, Kv, G, S)[..., None])
    dog = do.reshape(B, S, Kv, G, hd).float()
    dp = torch.einsum("bskgd,btkd->bkgst", dog, v.float())
    ds = p * (dp - delta.reshape(B, Kv, G, S)[..., None]) * _scale(hd, scale)
    return p, ds, dog


def flash_dq_plain(q, k, v, do, lse, delta, causal=True, window=None, scale=None):
    """``dq = ds·k``."""
    _, ds, _ = _p_ds(q, k, v, do, lse, delta, causal, window, scale)
    dq = torch.einsum("bkgst,btkd->bskgd", ds, k.float())
    return dq.reshape(q.shape).to(q.dtype)


def flash_dkv_plain(q, k, v, do, lse, delta, causal=True, window=None, scale=None):
    """``dk = dsᵀ·q`` and ``dv = pᵀ·do``, summed over the GQA group."""
    B, S, H, hd = q.shape
    Kv = k.shape[2]
    p, ds, dog = _p_ds(q, k, v, do, lse, delta, causal, window, scale)
    qg = q.reshape(B, S, Kv, H // Kv, hd).float()
    dk = torch.einsum("bkgst,bskgd->btkd", ds, qg)
    dv = torch.einsum("bkgst,bskgd->btkd", p, dog)
    return dk.to(k.dtype), dv.to(v.dtype)
