"""Causal depthwise convolution fused with its SiLU on the GPU: the ctypes
wrappers of ``csrc/causal_conv.cu`` (forward and backward), their plain
PyTorch versions, and the ``torch.autograd.Function`` the model calls.

For u (B,S,C) and w (cw,C) fp32: ``y = silu(conv(u, w))`` in u's dtype,
where ``conv(u, w)[s] = Σ_i w[cw-1-i]·u[s-i]`` (u is 0 before the sequence
starts), every product and sum in fp32 and one cast on store.  It is the
mamba mixer's convolution of x and of B/C (``models/ssm.py``); the TPU side
has no kernel for it (the reference's ``_causal_conv`` is jnp that XLA
fuses).  The backward is a kernel too, from the saved u and w alone (the
pre-activation is recomputed): ``du`` in u's dtype and ``dw`` in fp32, the
taps' sums over batch and positions added in a fixed order without atomics,
so the gradients repeat bit for bit from run to run.

The plain versions are the model's code: ``causal_conv_plain`` is
``F.silu(conv_local(u.float(), w)).to(u.dtype)``, and
``causal_conv_bwd_plain`` states autograd's backward of it operator for
operator (the taps' terms of du added in the order the engine adds them),
so that on the CPU the Function's values and gradients are those of the
plain code to the bit.  The kernels follow both orders, with separate
roundings: only ``expf`` and the order of dw's fp32 sum can differ.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .build import PLAIN_DEVICES, kernel_call, launch

#: the widest convolution the kernels are instantiated for
MAX_WIDTH = 4
#: C must be a multiple of this (16 bytes of bf16), and so must the row
#: strides of u
VEC = 8
#: a block of either kernel: WARPS runs of positions, each of ``run``
#: positions of one sequence, × LANES threads of CHANNELS channels
WARPS, LANES, CHANNELS = 8, 32, 4
#: the runs a geometry chooses from, longest first
RUNS = (64, 32, 16, 8)
#: blocks a streaming multiprocessor that the run is chosen to give at least
BLOCKS_PER_SM = 4

_VP, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_VP] * 3 + [_INT] * 4 + [_LL] * 2 + [_INT] * 2
_BWD_ARGTYPES = [_VP] * 6 + [_INT] * 5 + [_LL] * 2 + [_INT] * 2


def conv_local(u, w):
    """The depthwise causal conv along axis 1 in u's dtype: u (B,S,C), w
    (cw,C).  ``w[-1]·u[s]`` first, then ``+ w[-1-i]·u[s-i]`` over padded
    copies."""
    cw = w.shape[0]
    out = u * w[-1]
    for i in range(1, cw):
        shifted = F.pad(u, (0, 0, i, 0))[:, :u.shape[1]]
        out = out + shifted * w[-1 - i]
    return out


def causal_conv_plain(u, w):
    """The kernel's function in PyTorch: ``silu(conv(u, w))`` in fp32, cast
    once to u's dtype."""
    return F.silu(conv_local(u.float(), w)).to(u.dtype)


def causal_conv_bwd_plain(u, w, dy):
    """Autograd's backward of ``causal_conv_plain``, written out: (du in
    u's dtype, dw fp32).  ``g = silu_backward(dy, pre)``; each tap ``i``
    gives ``dw[-1-i] = Σ g·shift_i(u)`` and du the term ``g[s+i]·w[-1-i]``,
    the terms summed from the widest shift down to ``g·w[-1]``, as the
    engine adds them."""
    uf = u.float()
    g = torch.ops.aten.silu_backward(dy.float(), conv_local(uf, w))
    S, cw = u.shape[1], w.shape[0]
    dw = torch.zeros_like(w)
    du = None
    for i in range(cw - 1, 0, -1):
        shifted = F.pad(uf, (0, 0, i, 0))[:, :S]
        dw[-1 - i] = (g * shifted).sum(dim=(0, 1))
        term = F.pad(g * w[-1 - i], (0, 0, 0, i))[:, i:]
        du = term if du is None else du + term
    dw[-1] = (g * uf).sum(dim=(0, 1))
    term = g * w[-1]
    du = term if du is None else du + term
    return du.to(u.dtype), dw


def _check(u, w, what: str) -> None:
    """Raise unless u and w are inside the kernels' contract (before the
    device is looked at)."""
    if u.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what}: u has dtype {u.dtype} (bfloat16 or float32)")
    if w.dtype != torch.float32:
        raise TypeError(f"{what}: w has dtype {w.dtype} (float32)")
    if u.dim() != 3 or w.dim() != 2 or w.shape[1] != u.shape[2]:
        raise ValueError(f"{what}: expected u (B,S,C) and w (cw,C); got {tuple(u.shape)} and "
                         f"{tuple(w.shape)}")
    C, cw = u.shape[2], w.shape[0]
    if C % VEC or C == 0 or not 1 <= cw <= MAX_WIDTH:
        raise ValueError(f"{what}: C = {C} must be a positive multiple of {VEC} and cw = {cw} "
                         f"in 1..{MAX_WIDTH}")
    if u.stride(2) != 1 or u.stride(0) % VEC or u.stride(1) % VEC:
        raise ValueError(f"{what}: u's last dim must be contiguous and its other strides "
                         f"multiples of {VEC}; strides {u.stride()}")
    if not w.is_contiguous():
        raise ValueError(f"{what}: w must be contiguous")
    if u.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(f"{what}: u and w must start on a 16-byte boundary")
    if u.device.type != "cuda" or w.device != u.device:
        raise ValueError(f"{what}: u and w must lie on one CUDA device")


@functools.lru_cache(maxsize=8)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def geometry(B: int, S: int, C: int, sms: int) -> dict:
    """The launch of the forward and of the backward on ``sms``
    multiprocessors: the run of positions a warp walks (the longest of
    ``RUNS`` that gives ``BLOCKS_PER_SM`` blocks an SM, else the shortest),
    the grid (channel blocks, run blocks, sequences) and the backward's
    partials of dw (one a block of a column: B · run blocks)."""
    gx = -(-C // (LANES * CHANNELS))
    for run in RUNS:
        gy = -(-S // (WARPS * run))
        if gx * gy * B >= BLOCKS_PER_SM * sms:
            break
    return {"run": run, "grid": (gx, gy, B), "parts": B * gy}


def causal_conv_cuda(u, w):
    """Launch the forward on u (B,S,C) and w (cw,C) fp32."""
    _check(u, w, "causal_conv kernel")
    B, S, C = u.shape
    geo = geometry(B, S, C, _sm_count(u.device.index))
    y = torch.empty((B, S, C), dtype=u.dtype, device=u.device)
    launch("causal_conv", _ARGTYPES, u.device, u.data_ptr(), w.data_ptr(), y.data_ptr(), B, S,
           C, w.shape[0], u.stride(0), u.stride(1), geo["run"], int(u.dtype == torch.bfloat16))
    return y


def causal_conv_bwd_cuda(u, w, dy):
    """Launch the backward: dy (B,S,C) contiguous in u's dtype.  Returns (du
    in u's dtype, dw fp32).  The scratch of the blocks' partials of dw is
    allocated here."""
    if dy.dtype != u.dtype:
        raise TypeError(f"causal_conv_bwd kernel: dy has dtype {dy.dtype}, u {u.dtype}")
    if dy.shape != u.shape or dy.device != u.device:
        raise ValueError(f"causal_conv_bwd kernel: dy must have u's shape {tuple(u.shape)} on "
                         f"{u.device}; got {tuple(dy.shape)} on {dy.device}")
    if not dy.is_contiguous() or dy.data_ptr() % 16:
        raise ValueError("causal_conv_bwd kernel: dy must be contiguous and 16-byte aligned")
    _check(u, w, "causal_conv_bwd kernel")
    B, S, C = u.shape
    cw = w.shape[0]
    geo = geometry(B, S, C, _sm_count(u.device.index))
    partial = torch.empty((max(geo["parts"], 1), cw, C), dtype=torch.float32, device=u.device)
    du = torch.empty((B, S, C), dtype=u.dtype, device=u.device)
    dw = torch.empty_like(w)
    launch("causal_conv_bwd", _BWD_ARGTYPES, u.device, u.data_ptr(), w.data_ptr(),
           dy.data_ptr(), du.data_ptr(), dw.data_ptr(), partial.data_ptr(), geo["parts"], B, S,
           C, cw, u.stride(0), u.stride(1), geo["run"], int(u.dtype == torch.bfloat16))
    return du, dw


def causal_conv_fwd(u, w):
    """The plain version for a CPU (or ``meta``) tensor, the kernel for a
    CUDA tensor."""
    run = causal_conv_plain if u.device.type in PLAIN_DEVICES else causal_conv_cuda
    return kernel_call("causal_conv", causal_conv_plain, run, u, w)


def causal_conv_bwd(u, w, dy):
    """The plain backward for a CPU (or ``meta``) tensor, the kernel for a
    CUDA tensor."""
    run = causal_conv_bwd_plain if u.device.type in PLAIN_DEVICES else causal_conv_bwd_cuda
    return kernel_call("causal_conv_bwd", causal_conv_bwd_plain, run, u, w, dy)


class CausalConvSilu(torch.autograd.Function):
    """Forward: ``causal_conv_fwd``.  Backward: ``causal_conv_bwd`` from the
    saved u and w (neither the output nor the pre-activation is kept)."""

    @staticmethod
    def forward(ctx, u, w):
        ctx.save_for_backward(u, w)
        return causal_conv_fwd(u, w)

    @staticmethod
    def backward(ctx, dy):
        u, w = ctx.saved_tensors
        du, dw = causal_conv_bwd(u, w, dy.contiguous())
        return (du if ctx.needs_input_grad[0] else None,
                dw if ctx.needs_input_grad[1] else None)
