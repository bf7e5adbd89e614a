"""RMSNorm on the GPU: the ctypes wrapper of ``csrc/rmsnorm.cu``, its plain
PyTorch version, and the ``torch.autograd.Function`` the model calls.

``y = x·rsqrt(mean(x²) + eps)·(1 + scale)`` per row, statistics and both
products in fp32, one cast on store (trap T1 in ROADMAP.md: the model's
``layers.rmsnorm`` casts before the product, so the two agree in fp32 and to
bf16 rounding in bf16).  The TPU kernel has no backward; neither does this
one: the gradient is autograd of the plain version, recomputed from the
saved input.
"""

from __future__ import annotations

import ctypes

import torch

from .build import launch
from .ref import rmsnorm_ref

#: d must be a multiple of this (one 16-byte bf16 load) and at most MAX_D
VEC = 8
MAX_D = 256 * 8 * 8

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                                     ctypes.c_int]

#: the plain version: the kernel's arithmetic, stated in PyTorch
rmsnorm_plain = rmsnorm_ref


def rmsnorm_cuda(x, scale, eps: float = 1e-6):
    """Launch the kernel on x (..., d) and scale (d,) fp32."""
    d = x.shape[-1]
    if d % VEC or d > MAX_D:
        raise ValueError(f"rmsnorm kernel: d = {d} must be a multiple of {VEC} and <= {MAX_D}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"rmsnorm kernel: dtype {x.dtype} (float32 or bfloat16)")
    if scale.shape != (d,) or scale.dtype != torch.float32:
        raise ValueError(f"rmsnorm kernel: scale must be fp32 ({d},); got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    if x.device.type != "cuda" or scale.device != x.device:
        raise ValueError("rmsnorm kernel: x and scale must lie on one CUDA device")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm kernel: x and scale must be contiguous")
    if x.data_ptr() % 16 or scale.data_ptr() % 16:
        raise ValueError("rmsnorm kernel: x and scale must be 16-byte aligned")
    y = torch.empty_like(x)
    launch("rmsnorm", _ARGTYPES, x.device, x.data_ptr(), scale.data_ptr(), y.data_ptr(),
           x.numel() // d, d, float(eps), int(x.dtype == torch.bfloat16))
    return y


def rmsnorm_fwd(x, scale, eps: float = 1e-6):
    """The plain version for a CPU tensor, the kernel for a CUDA tensor."""
    if x.device.type == "cpu":
        return rmsnorm_plain(x, scale, eps)
    return rmsnorm_cuda(x, scale, eps)


class RMSNorm(torch.autograd.Function):
    """Forward: ``rmsnorm_fwd``.  Backward: autograd of the plain version,
    recomputed from the saved input (no backward kernel exists, on the TPU
    either)."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        x = x.contiguous()
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rmsnorm_fwd(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        with torch.enable_grad():
            x_ = x.detach().requires_grad_(ctx.needs_input_grad[0])
            s_ = scale.detach().requires_grad_(ctx.needs_input_grad[1])
            y = rmsnorm_plain(x_, s_, ctx.eps)
            wrt = [t for t in (x_, s_) if t.requires_grad]
            grads = iter(torch.autograd.grad(y, wrt, dy))
        dx = next(grads) if ctx.needs_input_grad[0] else None
        ds = next(grads) if ctx.needs_input_grad[1] else None
        return dx, ds, None
