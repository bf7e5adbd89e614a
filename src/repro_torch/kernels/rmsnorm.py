"""RMSNorm on the GPU: the ctypes wrappers of ``csrc/rmsnorm.cu`` (forward
and backward), their plain PyTorch versions, and the
``torch.autograd.Function`` the model calls.

``y = x·rsqrt(mean(x²) + eps)·(1 + scale)`` per row, statistics and both
products in fp32, one cast on store (trap T1 in ROADMAP.md: the model's
``layers.rmsnorm`` casts before the product, so the two agree in fp32 and to
bf16 rounding in bf16).  The TPU kernel has no backward (JAX differentiates
the reference); the port's backward is a kernel of its own, the gradient of
the same function recomputed from the saved input:
``dx = r·w·g − x·r³·mean(w·g·x)`` (one cast) and ``dscale = Σ_rows g·x·r``
(fp32), with ``r = rsqrt(mean(x²) + eps)``, ``w = 1 + scale``, ``g = dy``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import PLAIN_DEVICES, kernel_call, launch, load_library
from .ref import rmsnorm_ref

#: d must be a multiple of this (one 16-byte bf16 load) and at most MAX_D
VEC = 8
MAX_D = 256 * 8 * 8

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                                     ctypes.c_int]
_BWD_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                         ctypes.c_float, ctypes.c_int]

#: the plain version: the kernel's arithmetic, stated in PyTorch
rmsnorm_plain = rmsnorm_ref


def rmsnorm_bwd_plain(x, scale, dy, eps: float = 1e-6):
    """The backward kernel's arithmetic in PyTorch, in its order: (dx in x's
    dtype, dscale in scale's)."""
    d = x.shape[-1]
    xf, g = x.float(), dy.float()
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    gw = g * (1.0 + scale.float())
    c3 = (gw * xf).mean(dim=-1, keepdim=True) * (r * r * r)
    dx = (gw * r - xf * c3).to(x.dtype)
    dscale = (g * (xf * r)).reshape(-1, d).sum(dim=0)
    return dx, dscale.to(scale.dtype)


def _check(x, scale, what: str) -> None:
    d = x.shape[-1]
    if d % VEC or not 0 < d <= MAX_D:
        raise ValueError(f"{what}: d = {d} must be a positive multiple of {VEC} and <= {MAX_D}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: dtype {x.dtype} (float32 or bfloat16)")
    if scale.shape != (d,) or scale.dtype != torch.float32:
        raise ValueError(f"{what}: scale must be fp32 ({d},); got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    if x.device.type != "cuda" or scale.device != x.device:
        raise ValueError(f"{what}: x and scale must lie on one CUDA device")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError(f"{what}: x and scale must be contiguous")
    if x.data_ptr() % 16 or scale.data_ptr() % 16:
        raise ValueError(f"{what}: x and scale must be 16-byte aligned")


def rmsnorm_cuda(x, scale, eps: float = 1e-6):
    """Launch the kernel on x (..., d) and scale (d,) fp32."""
    _check(x, scale, "rmsnorm kernel")
    d = x.shape[-1]
    y = torch.empty_like(x)
    launch("rmsnorm", _ARGTYPES, x.device, x.data_ptr(), scale.data_ptr(), y.data_ptr(),
           x.numel() // d, d, float(eps), int(x.dtype == torch.bfloat16))
    return y


@functools.lru_cache(maxsize=64)
def grid(d: int, rows: int, bf16: bool, bwd: bool, device_index: int) -> dict:
    """The launch geometry ``csrc/rmsnorm.cu`` takes for ``rows`` rows of
    width ``d`` (``rmsnorm_grid``): blocks, resident blocks an SM, threads a
    block, rows a block holds at once, threads a row, and the 16-byte vectors
    a thread holds at most (the kernel template's ``MAXV``, which with the
    threads a row names the instantiation).  Block ``b`` takes rows
    ``b·rows_at_once + i + k·blocks·rows_at_once``."""
    fn = load_library("rmsnorm").rmsnorm_grid
    fn.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 6)()
    with torch.cuda.device(device_index):
        err = fn(d, rows, int(bf16), int(bwd), out)
    if err != 0:
        raise RuntimeError(f"rmsnorm_grid failed with error {err} for d = {d}, rows = {rows}")
    return dict(zip(("blocks", "blocks_per_sm", "threads", "rows_at_once", "threads_per_row",
                     "max_vectors_per_thread"), out, strict=True))


def rmsnorm_bwd_cuda(x, scale, dy, eps: float = 1e-6):
    """Launch the backward kernel: x and dy (..., d) of one dtype, scale (d,)
    fp32.  Returns (dx in x's dtype, dscale fp32).  The scratch of the
    blocks' partial sums of dscale is allocated here."""
    if dy.dtype != x.dtype:
        raise TypeError(f"rmsnorm_bwd kernel: dy has dtype {dy.dtype}, x {x.dtype}")
    if dy.shape != x.shape or dy.device != x.device:
        raise ValueError(f"rmsnorm_bwd kernel: dy must have x's shape {tuple(x.shape)} on "
                         f"{x.device}; got {tuple(dy.shape)} on {dy.device}")
    if not dy.is_contiguous() or dy.data_ptr() % 16:
        raise ValueError("rmsnorm_bwd kernel: dy must be contiguous and 16-byte aligned")
    _check(x, scale, "rmsnorm_bwd kernel")
    d = x.shape[-1]
    rows = x.numel() // d
    bf16 = x.dtype == torch.bfloat16
    parts = grid(d, rows, bf16, True, x.device.index)["blocks"]
    partial = torch.empty((max(parts, 1), d), dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dscale = torch.empty_like(scale)
    launch("rmsnorm_bwd", _BWD_ARGTYPES, x.device, x.data_ptr(), dy.data_ptr(),
           scale.data_ptr(), dx.data_ptr(), dscale.data_ptr(), partial.data_ptr(), parts, rows,
           d, float(eps), int(bf16))
    return dx, dscale


def rmsnorm_fwd(x, scale, eps: float = 1e-6):
    """The plain version for a CPU (or ``meta``) tensor, the kernel for a
    CUDA tensor."""
    run = rmsnorm_plain if x.device.type in PLAIN_DEVICES else rmsnorm_cuda
    return kernel_call("rmsnorm", rmsnorm_plain, run, x, scale, eps)


def rmsnorm_bwd(x, scale, dy, eps: float = 1e-6):
    """The plain backward for a CPU (or ``meta``) tensor, the kernel for a
    CUDA tensor."""
    run = rmsnorm_bwd_plain if x.device.type in PLAIN_DEVICES else rmsnorm_bwd_cuda
    return kernel_call("rmsnorm_bwd", rmsnorm_bwd_plain, run, x, scale, dy, eps)


class RMSNorm(torch.autograd.Function):
    """Forward: ``rmsnorm_fwd``.  Backward: ``rmsnorm_bwd``, from the saved
    input (r is recomputed, nothing else is saved)."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        x = x.contiguous()
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rmsnorm_fwd(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, ds = rmsnorm_bwd(x, scale, dy.contiguous(), ctx.eps)
        return (dx if ctx.needs_input_grad[0] else None,
                ds if ctx.needs_input_grad[1] else None, None)
