"""Public wrappers of the kernels.

* dispatch is by the tensor's device: a CPU tensor takes the plain PyTorch
  version, a CUDA tensor launches the CUDA kernel or raises — there is no
  fallback from one to the other;
* ``flash_attention`` is one ``torch.autograd.Function`` wiring the recompute
  backward (dq kernel, then dk/dv kernel) from the saved ``(q,k,v,o,lse)``;
  ``rmsnorm`` is one whose backward is the rmsnorm backward kernel (the TPU
  kernel has none: JAX differentiates the reference); ``ssd_chunk``'s
  backward is autograd of the plain version (the TPU kernel has none);
* ``fused_adam_multi`` updates lists of leaves in place, one launch per
  dtype group (``fused_adam`` is a list of one);
* ``LAUNCHES`` counts the launches of every C entry point: the six kernels
  and the rmsnorm backward (``build.LAUNCHES``).
"""

from __future__ import annotations

import torch

from . import flash_attention as _fa
from . import fused_adam as _ad
from .build import LAUNCHES  # noqa: F401  (re-export)
from .ref import from_heads, to_heads
from .rmsnorm import RMSNorm
from .ssd_chunk import SSDChunk


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def flash_fwd(q, k, v, causal=True, window=None, scale=None):
    """(o, lse).  q: (B,S,H,hd); k/v: (B,T,Kv,hd); lse: (B,H,S) fp32."""
    if _on_cpu(q):
        return _fa.flash_fwd_plain(q, k, v, causal, window, scale)
    return _fa.flash_fwd_cuda(q, k, v, causal, window, scale)


def flash_dq(q, k, v, do, lse, delta, causal=True, window=None, scale=None):
    if _on_cpu(q):
        return _fa.flash_dq_plain(q, k, v, do, lse, delta, causal, window, scale)
    return _fa.flash_dq_cuda(q, k, v, do, lse, delta, causal, window, scale)


def flash_dkv(q, k, v, do, lse, delta, causal=True, window=None, scale=None):
    if _on_cpu(q):
        return _fa.flash_dkv_plain(q, k, v, do, lse, delta, causal, window, scale)
    return _fa.flash_dkv_cuda(q, k, v, do, lse, delta, causal, window, scale)


def attention_delta(o, do):
    """``delta = Σ_d do ⊙ o`` in fp32, laid out (B,H,S) like ``lse``.  Stays
    outside the kernels, as in the reference."""
    return (do.float() * o.float()).sum(dim=-1).transpose(1, 2).contiguous()


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = flash_fwd(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = attention_delta(o, do)
        args = (q, k, v, do, lse, delta, ctx.causal, ctx.window)
        dq = flash_dq(*args)
        dk, dv = flash_dkv(*args)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = True, window: int | None = None):
    """q: (B,S,H,hd); k/v: (B,T,Kv,hd).  Returns (B,S,H,hd)."""
    return _FlashAttention.apply(q, k, v, causal, window)


def rmsnorm(x, scale, eps: float = 1e-6):
    """x: (..., d); scale: (d,) fp32.  ``x·rsqrt(mean(x²)+eps)·(1+scale)`` in
    fp32, cast once to x's dtype."""
    return RMSNorm.apply(x, scale, eps)


def fused_adam_multi(ps, gs, ms, vs, count, lr, b1=0.9, b2=0.95, eps=1e-8,
                     weight_decay=0.0):
    """One AdamW step on lists of leaves of any shapes, **in place** on every
    ``p``, ``m`` and ``v``.  ``count``: the post-increment step, an int32
    tensor on the leaves' device.  The plain version when every leaf lies on
    the CPU; otherwise the kernel, which raises for a leaf off the device."""
    if all(_on_cpu(p) for p in ps):
        _ad.fused_adam_multi_plain(ps, gs, ms, vs, count, lr, b1, b2, eps, weight_decay)
    else:
        _ad.fused_adam_multi_cuda(ps, gs, ms, vs, count, lr, b1, b2, eps, weight_decay)


def fused_adam(p, g, m, v, count, lr, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0):
    """``fused_adam_multi`` on one leaf."""
    fused_adam_multi([p], [g], [m], [v], count, lr, b1, b2, eps, weight_decay)


def ssd_chunk_heads(x, dt, b, c, a):
    """SSD within chunks in the model's layout (see ``kernels/ssd_chunk.py``):
    x (Bt,nc,Q,H,hp), dt (Bt,nc,Q,H), b/c (Bt,nc,Q,G,N), a (H,).  Returns
    (y (Bt,nc,Q,H,hp), states (Bt,nc,H,N,hp) fp32, cum (Bt,nc,Q,H) fp32)."""
    return SSDChunk.apply(x, dt, b, c, a)


def ssd_chunk(x, dt, b, c, a):
    """The reference's signature and layout: x (BH,nc,Q,hp); dt (BH,nc,Q);
    b/c (BH,nc,Q,N); a (BH,).  Returns (y_intra (BH,nc,Q,hp), states
    (BH,nc,N,hp) fp32, cum (BH,nc,Q) fp32) — views into the model-layout
    outputs (Bt = 1, one group per head)."""
    return from_heads(*ssd_chunk_heads(*to_heads(x, dt, b, c), a))
