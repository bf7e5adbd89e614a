"""Mamba-2 SSD within chunks on the GPU: the ctypes wrapper of
``csrc/ssd_chunk.cu``, its plain PyTorch version, and the
``torch.autograd.Function`` the model calls.

Everything here is in the model's layout: x (Bt,nc,Q,H,hp); dt (Bt,nc,Q,H)
fp32; b/c (Bt,nc,Q,G,N), head ``h`` reading group ``h // (H/G)``; a (H,) fp32.
Outputs: y (Bt,nc,Q,H,hp) in x's dtype, states (Bt,nc,H,N,hp) fp32 (note
``(N,hp)``: the model's recurrence keeps ``(hp,N)``, trap T5 in
ROADMAP.md), cum (Bt,nc,Q,H) fp32.  The kernel reads every input through its
strides — the chunked views of the model's activations and the group slices
of ``bc`` go in without a copy, and B/C are not repeated per head — and
writes outputs allocated here.  ``ops.ssd_chunk`` maps the reference's
``(B·H,nc,Q,·)`` layout onto this one with views.

The TPU kernel has no backward; neither does this one: the gradient is
autograd of the plain version, recomputed from the saved inputs.
"""

from __future__ import annotations

import ctypes

import torch

from .build import launch
from .ref import ssd_intra

#: head dims, state sizes and chunk lengths the kernel is instantiated for
HEAD_DIMS = (16, 32, 64)
STATE_DIMS = (16, 32, 64, 128)
MAX_CHUNK = 256

_VP = ctypes.c_void_p
_ARGTYPES = [_VP] * 9 + [ctypes.c_int] * 8

#: the plain version: the kernel's arithmetic, stated in PyTorch
ssd_chunk_plain = ssd_intra


def _strides(t, dims: int) -> list[int]:
    """The first ``dims`` strides; the one after them must be 1."""
    if t.dim() > dims and t.stride(dims) != 1:
        raise ValueError(f"ssd_chunk kernel: the last dimension of {tuple(t.shape)} "
                         f"must be contiguous; strides {t.stride()}")
    return list(t.stride()[:dims])


def ssd_chunk_cuda(x, dt, b, c, a):
    """Launch the kernel; returns ``(y, states, cum)`` (see the module).
    bf16 inputs run ``ssd_chunk_tc_kernel`` (tensor cores; the scores times
    decay and dt, and B times its states weight, rounded to bf16 before
    their products), fp32 inputs the IEEE fp32 FMA kernel."""
    if x.dim() != 5 or dt.dim() != 4 or b.dim() != 5 or c.shape != b.shape:
        raise ValueError("ssd_chunk kernel: expected x (Bt,nc,Q,H,hp), dt (Bt,nc,Q,H), "
                         "b/c (Bt,nc,Q,G,N)")
    Bt, nc, Q, H, hp = x.shape
    G, N = b.shape[3], b.shape[4]
    if dt.shape != (Bt, nc, Q, H) or b.shape[:3] != (Bt, nc, Q) or a.shape != (H,):
        raise ValueError(f"ssd_chunk kernel: shapes do not match: x {tuple(x.shape)}, "
                         f"dt {tuple(dt.shape)}, b {tuple(b.shape)}, a {tuple(a.shape)}")
    if G == 0 or H % G:
        raise ValueError(f"ssd_chunk kernel: {H} heads do not split into {G} groups")
    if hp not in HEAD_DIMS or N not in STATE_DIMS or not 1 <= Q <= MAX_CHUNK:
        raise ValueError(f"ssd_chunk kernel: needs hp in {HEAD_DIMS}, N in {STATE_DIMS}, "
                         f"1 <= Q <= {MAX_CHUNK}; got hp={hp}, N={N}, Q={Q}")
    if x.dtype not in (torch.float32, torch.bfloat16) or b.dtype != x.dtype \
            or c.dtype != x.dtype:
        raise TypeError(f"ssd_chunk kernel: x, b, c must share float32 or bfloat16; got "
                        f"{x.dtype}, {b.dtype}, {c.dtype}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError("ssd_chunk kernel: dt and a must be float32")
    # rows of x, b, c are read 16 bytes at a time (float4 loads in fp32,
    # cp.async in bf16): bases on 16-byte boundaries, strides multiples of 16
    # bytes (4 fp32 or 8 bf16 elements)
    elems = 16 // x.element_size()
    for t in (x, b, c):
        if t.data_ptr() % 16 or any(s % elems for s in t.stride()[:4]):
            raise ValueError(f"ssd_chunk kernel: rows of {tuple(t.shape)} (strides "
                             f"{t.stride()}) are not aligned to {elems} elements "
                             f"(16 bytes)")
    for t in (x, dt, b, c, a):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError("ssd_chunk kernel: all tensors must lie on one CUDA device")

    y = torch.empty((Bt, nc, Q, H, hp), dtype=x.dtype, device=x.device)
    states = torch.empty((Bt, nc, H, N, hp), dtype=torch.float32, device=x.device)
    cum = torch.empty((Bt, nc, Q, H), dtype=torch.float32, device=x.device)
    strides = (_strides(x, 4) + _strides(dt, 4) + _strides(b, 4) + _strides(c, 4)
               + _strides(y, 4) + _strides(cum, 4) + _strides(states, 4)
               + [a.stride(0)])
    arr = (ctypes.c_longlong * len(strides))(*strides)
    launch("ssd_chunk", _ARGTYPES, x.device, x.data_ptr(), dt.data_ptr(), b.data_ptr(),
           c.data_ptr(), a.data_ptr(), y.data_ptr(), states.data_ptr(), cum.data_ptr(),
           ctypes.addressof(arr), Bt, nc, Q, H, G, hp, N, int(x.dtype == torch.bfloat16))
    return y, states, cum


def ssd_chunk_fwd(x, dt, b, c, a):
    """The plain version for CPU tensors, the kernel for CUDA tensors."""
    if x.device.type == "cpu":
        return ssd_chunk_plain(x, dt, b, c, a)
    return ssd_chunk_cuda(x, dt, b, c, a)


class SSDChunk(torch.autograd.Function):
    """Forward: ``ssd_chunk_fwd``.  Backward: autograd of the plain version,
    recomputed from the saved inputs (no backward kernel exists, on the TPU
    either; ROADMAP.md lists one as later work)."""

    @staticmethod
    def forward(ctx, x, dt, b, c, a):
        ctx.save_for_backward(x, dt, b, c, a)
        return ssd_chunk_fwd(x, dt, b, c, a)

    @staticmethod
    def backward(ctx, dy, dstates, dcum):
        inputs = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need)
                      for t, need in zip(inputs, ctx.needs_input_grad, strict=True)]
            outs = ssd_chunk_plain(*leaves)
            pairs = [(o, d) for o, d in zip(outs, (dy, dstates, dcum), strict=True)
                     if d is not None]
            wrt = [t for t in leaves if t.requires_grad]
            grads = iter(torch.autograd.grad([o for o, _ in pairs], wrt,
                                             [d for _, d in pairs], allow_unused=True))
        return tuple(next(grads) if t.requires_grad else None for t in leaves)
