"""Public wrappers of the kernels.

* dispatch is by the tensor's device: a CPU tensor takes the plain PyTorch
  version, a CUDA tensor launches the CUDA kernel or raises — there is no
  fallback from one to the other;
* ``flash_attention`` is one ``torch.autograd.Function`` wiring the recompute
  backward (dq kernel, then dk/dv kernel) from the saved ``(q,k,v,o,lse)``;
* ``LAUNCHES`` counts kernel launches (see ``flash_attention.LAUNCHES``).
"""

from __future__ import annotations

import torch

from . import flash_attention as _fa
from .flash_attention import LAUNCHES  # noqa: F401  (re-export)


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
