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
``(B·H,nc,Q,·)`` layout onto this one with views.  In bf16 a block of the
forward takes a slice of a group's heads (``ssd_fwd_geometry``): it holds
the chunk's B (and C) tiles once for them, and a y block forms the scores
``C·Bᵀ`` once for them.

The TPU kernel has no backward (JAX differentiates the reference's
einsums); the port's backward is a kernel of its own, entry point
``ssd_chunk_bwd`` in the same source: the gradient of the same function,
recomputed from the saved inputs x, dt, b, c, a (nothing the forward wrote is
kept), with ``ssd_chunk_bwd_plain`` its arithmetic in PyTorch.  dB and dC sum
over the heads of a group, and da over batch and chunks, in a fixed order and
without atomics (bf16: inside a block over a slice of heads, then over the
slices; fp32: per-head partials, then a sum in head order), so the gradients
are the same from run to run.
"""

from __future__ import annotations

import ctypes

import torch

from .build import PLAIN_DEVICES, kernel_call, launch
from .ref import ssd_intra

#: head dims, state sizes and chunk lengths the kernel is instantiated for
HEAD_DIMS = (16, 32, 64)
STATE_DIMS = (16, 32, 64, 128)
MAX_CHUNK = 256

#: rows of a tile of the bf16 kernels and of the fp32 backward
TILE = 64
#: at most this many heads of a group share one block of the bf16 kernels:
#: the forward holds the chunk's B and C (and forms the scores) once for
#: them, the backward sums their dB and dC before anything reaches device
#: memory
SLICE_HEADS = 16

_VP = ctypes.c_void_p
_ARGTYPES = [_VP] * 9 + [ctypes.c_int] * 9
_BWD_ARGTYPES = [_VP] * 18 + [ctypes.c_int] * 9

#: the plain version: the kernel's arithmetic, stated in PyTorch
ssd_chunk_plain = ssd_intra


def _strides(t, dims: int) -> list[int]:
    """The first ``dims`` strides; the one after them must be 1."""
    if t.dim() > dims and t.stride(dims) != 1:
        raise ValueError(f"ssd_chunk kernel: the last dimension of {tuple(t.shape)} "
                         f"must be contiguous; strides {t.stride()}")
    return list(t.stride()[:dims])


def _check(x, dt, b, c, a, what: str = "ssd_chunk kernel") -> None:
    """Raise unless the inputs are inside the kernels' contract."""
    if x.dim() != 5 or dt.dim() != 4 or b.dim() != 5 or c.shape != b.shape:
        raise ValueError(f"{what}: expected x (Bt,nc,Q,H,hp), dt (Bt,nc,Q,H), "
                         "b/c (Bt,nc,Q,G,N)")
    Bt, nc, Q, H, hp = x.shape
    G, N = b.shape[3], b.shape[4]
    if dt.shape != (Bt, nc, Q, H) or b.shape[:3] != (Bt, nc, Q) or a.shape != (H,):
        raise ValueError(f"{what}: shapes do not match: x {tuple(x.shape)}, "
                         f"dt {tuple(dt.shape)}, b {tuple(b.shape)}, a {tuple(a.shape)}")
    if G == 0 or H % G:
        raise ValueError(f"{what}: {H} heads do not split into {G} groups")
    if hp not in HEAD_DIMS or N not in STATE_DIMS or not 1 <= Q <= MAX_CHUNK:
        raise ValueError(f"{what}: needs hp in {HEAD_DIMS}, N in {STATE_DIMS}, "
                         f"1 <= Q <= {MAX_CHUNK}; got hp={hp}, N={N}, Q={Q}")
    if x.dtype not in (torch.float32, torch.bfloat16) or b.dtype != x.dtype \
            or c.dtype != x.dtype:
        raise TypeError(f"{what}: x, b, c must share float32 or bfloat16; got "
                        f"{x.dtype}, {b.dtype}, {c.dtype}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError(f"{what}: dt and a must be float32")
    # rows of x, b, c are read 16 bytes at a time (float4 loads in fp32,
    # cp.async in bf16): bases on 16-byte boundaries, strides multiples of 16
    # bytes (4 fp32 or 8 bf16 elements)
    elems = 16 // x.element_size()
    for t in (x, b, c):
        if t.data_ptr() % 16 or any(s % elems for s in t.stride()[:4]):
            raise ValueError(f"{what}: rows of {tuple(t.shape)} (strides "
                             f"{t.stride()}) are not aligned to {elems} elements "
                             f"(16 bytes)")
    for t in (x, dt, b, c, a):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{what}: all tensors must lie on one CUDA device")


def _slice_heads(rep: int) -> int:
    """Heads of a slice: the largest divisor of a group's ``rep`` heads up to
    ``SLICE_HEADS``."""
    return max(r for r in range(1, min(rep, SLICE_HEADS) + 1) if rep % r == 0)


def _check_dims(what, Q, H, G, hp, N) -> None:
    if G < 1 or H % G:
        raise ValueError(f"{what}: {H} heads do not split into {G} groups")
    if hp not in HEAD_DIMS or N not in STATE_DIMS or not 1 <= Q <= MAX_CHUNK:
        raise ValueError(f"{what}: needs hp in {HEAD_DIMS}, N in {STATE_DIMS}, "
                         f"1 <= Q <= {MAX_CHUNK}; got hp={hp}, N={N}, Q={Q}")


def ssd_fwd_geometry(Bt, nc, Q, H, G, hp, N) -> dict:
    """The bf16 forward's launch geometry: the heads of each group split into
    ``slices`` of ``slice_heads`` R consecutive heads (as the backward's,
    ``ssd_bwd_geometry``), and each slice into ``roles``: one block for its
    states and cum (role 0), and one for y of each row tile of ``TILE`` rows,
    the last row tile first (role r, row tile ``tiles − r``).  A block holds
    its chunk's B tiles (and a y block its C tile) for all the slice's heads;
    a y block forms the scores C_t·B_jᵀ once for them.  One block per (batch,
    chunk, group, slice, role), role fastest."""
    _check_dims("ssd_chunk", Q, H, G, hp, N)
    rep = H // G
    R = _slice_heads(rep)
    tiles = -(-Q // TILE)
    slices = [tuple(range(g * rep + s * R, g * rep + (s + 1) * R))
              for g in range(G) for s in range(rep // R)]
    roles = [("states", None)] + [("y", tiles - r) for r in range(1, tiles + 1)]
    return {"slice_heads": R, "slices": slices, "tiles": tiles, "roles": roles,
            "blocks": Bt * nc * len(slices) * len(roles)}


def ssd_chunk_cuda(x, dt, b, c, a):
    """Launch the kernel; returns ``(y, states, cum)`` (see the module).
    bf16 inputs run ``ssd_chunk_wg_kernel`` (``wgmma`` fed by TMA, a block a
    slice of heads and a role, ``ssd_fwd_geometry``; the scores times decay
    and dt, and B times its states weight, rounded to bf16 before their
    products), fp32 inputs the IEEE fp32 FMA kernel."""
    _check(x, dt, b, c, a)
    Bt, nc, Q, H, hp = x.shape
    G, N = b.shape[3], b.shape[4]
    R = _slice_heads(H // G)
    y = torch.empty((Bt, nc, Q, H, hp), dtype=x.dtype, device=x.device)
    states = torch.empty((Bt, nc, H, N, hp), dtype=torch.float32, device=x.device)
    cum = torch.empty((Bt, nc, Q, H), dtype=torch.float32, device=x.device)
    strides = (_strides(x, 4) + _strides(dt, 4) + _strides(b, 4) + _strides(c, 4)
               + _strides(y, 4) + _strides(cum, 4) + _strides(states, 4)
               + [a.stride(0)])
    arr = (ctypes.c_longlong * len(strides))(*strides)
    launch("ssd_chunk", _ARGTYPES, x.device, x.data_ptr(), dt.data_ptr(), b.data_ptr(),
           c.data_ptr(), a.data_ptr(), y.data_ptr(), states.data_ptr(), cum.data_ptr(),
           ctypes.addressof(arr), Bt, nc, Q, H, G, hp, N, R, int(x.dtype == torch.bfloat16))
    return y, states, cum


def ssd_chunk_fwd(x, dt, b, c, a):
    """The plain version for CPU (or ``meta``) tensors, the kernel for CUDA
    tensors."""
    run = ssd_chunk_plain if x.device.type in PLAIN_DEVICES else ssd_chunk_cuda
    return kernel_call("ssd_chunk", ssd_chunk_plain, run, x, dt, b, c, a)


def _grads_in(x, b, dy, dstates, dcum):
    """``(dy, dstates, dcum)`` with zeros of the outputs' shapes and dtypes
    for each ``None``."""
    Bt, nc, Q, H, hp = x.shape
    N = b.shape[4]
    zeros = lambda shape, dtype: torch.zeros(shape, dtype=dtype, device=x.device)
    return (zeros(x.shape, x.dtype) if dy is None else dy,
            zeros((Bt, nc, H, N, hp), torch.float32) if dstates is None else dstates,
            zeros((Bt, nc, Q, H), torch.float32) if dcum is None else dcum)


def ssd_chunk_bwd_plain(x, dt, b, c, a, dy, dstates, dcum):
    """The backward kernel's arithmetic written out in PyTorch (not
    autograd): returns ``(dx, ddt, db, dc, da)`` in the dtypes of
    ``(x, dt, b, c, a)``.  Its products are the kernel's; dcum's terms are
    added in the order autograd of ``ssd_intra`` adds them (incoming, − w's
    term, + the last row's, − columns, + rows), not the kernel's (incoming
    + rows − columns − w's term + the last row's), so that da, an fp32 sum
    over many rows, rounds as autograd's does; the kernel's da differs from
    it by that rounding alone.  With u = x·dt, L_ij = exp(cum_i − cum_j) for i ≥ j
    (the exponent masked before ``exp``), s = C·Bᵀ, P = s ⊙ L and
    w = exp(cum_{Q−1} − cum):

        du   = Pᵀ dy + w·(B dS),  dx = du·dt,  ddt ∋ ⟨du, x⟩
        dP   = dy uᵀ,  ds = dP ⊙ L,  dC = ds B,  dB = dsᵀ C + w·(u dSᵀ)
        dcum += rows(dP ⊙ P) − columns(dP ⊙ P); w's ⟨B, dS u⟩·w moves from
                row j to row Q−1
        ddt  += a·(reverse cumsum of dcum),  da = Σ dcum·cumsum(dt)

    dB and dC sum over the heads of each group, da over batch, chunks and
    rows.  ``None`` for an output gradient counts as zeros."""
    dy, dstates, dcum = _grads_in(x, b, dy, dstates, dcum)
    Bt, nc, Q, H, hp = x.shape
    G, N = b.shape[3], b.shape[4]
    R = H // G
    xf = x.float().reshape(Bt, nc, Q, G, R, hp)
    dtf = dt.float().reshape(Bt, nc, Q, G, R)
    bf, cf = b.float(), c.float()
    dyf = dy.float().reshape(Bt, nc, Q, G, R, hp)
    dS = dstates.float().reshape(Bt, nc, G, R, N, hp)
    cs = torch.cumsum(dtf, dim=2)                                     # (Bt,nc,Q,G,R)
    af = a.float().reshape(G, R)
    cum = cs * af
    mask = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    seg = cum[:, :, :, None] - cum[:, :, None, :]                     # (Bt,nc,Q,Q,G,R)
    L = torch.exp(torch.where(mask[:, :, None, None], seg, float("-inf")))
    s = torch.einsum("bcign,bcjgn->bcijg", cf, bf)
    P = s[..., None] * L
    u = xf * dtf[..., None]
    w = torch.exp(cum[:, :, -1:] - cum)                               # (Bt,nc,Q,G,R)
    q = torch.einsum("bcjgn,bcgrnp->bcjgrp", bf, dS) * w[..., None]   # w_j (B_j dS)
    du = torch.einsum("bcijgr,bcigrp->bcjgrp", P, dyf) + q
    dP = torch.einsum("bcigrp,bcjgrp->bcijgr", dyf, u)
    ds = dP * L
    dc = torch.einsum("bcijgr,bcjgn->bcign", ds, bf)
    db = (torch.einsum("bcijgr,bcign->bcjgn", ds, cf)
          + torch.einsum("bcjgrp,bcgrnp->bcjgn", u * w[..., None], dS))
    # dP ⊙ P as (dP ⊙ s) ⊙ L, and the terms of dcum added in the order autograd
    # of ``ssd_intra`` adds them, so that fp32 sums of many rows (da) round alike
    dseg = (dP * s[..., None]) * L
    dw = (q * u).sum(-1)                                              # ⟨B_j, dS u_j⟩·w_j
    last = torch.zeros_like(dw)
    last[:, :, -1] = dw.sum(2)
    dcum_t = dcum.float().reshape(Bt, nc, Q, G, R) - dw + last - dseg.sum(2) + dseg.sum(3)
    rev = torch.flip(torch.cumsum(torch.flip(dcum_t, (2,)), dim=2), (2,))
    ddt = (du * xf).sum(-1) + af * rev
    da = (dcum_t * cs).sum((0, 1, 2)).reshape(H)
    return ((du * dtf[..., None]).reshape(x.shape).to(x.dtype),
            ddt.reshape(dt.shape).to(dt.dtype), db.to(b.dtype).contiguous(),
            dc.to(c.dtype).contiguous(), da.to(a.dtype))


def ssd_bwd_geometry(Bt, nc, Q, H, G, hp, N, bf16: bool = True) -> dict:
    """The bf16 backward's launch geometry and the scratch its wrapper
    allocates (fp32 elements by name; ``bf16=False``: the fp32 kernel's).

    bf16: the heads of each group split into ``slices`` of ``slice_heads`` R
    consecutive heads (the largest divisor of H / G up to ``SLICE_HEADS``),
    one block per (batch, chunk, group, slice, row tile of ``TILE`` rows):
    ``pdb`` and ``pdc`` hold one (Q, N) partial a slice, ``pvec`` a head's
    ``tiles + 3`` vectors of Q, ``pda`` a head's share of da.  fp32: one
    block per (batch, chunk, head) and a partial a head."""
    _check_dims("ssd_chunk_bwd", Q, H, G, hp, N)
    rep = H // G
    tiles = -(-Q // TILE)
    if bf16:
        R = _slice_heads(rep)
        parts = Bt * nc * G * (rep // R)
        scratch = {"pdb": parts * Q * N, "pdc": parts * Q * N,
                   "pvec": Bt * nc * H * (tiles + 3) * Q, "pda": Bt * nc * H}
    else:
        R = 1
        scratch = {"pdb": Bt * nc * H * Q * N, "pdc": Bt * nc * H * Q * N, "pvec": 0,
                   "pda": Bt * nc * H}
    slices = [tuple(range(g * rep + s * R, g * rep + (s + 1) * R))
              for g in range(G) for s in range(rep // R)]
    return {"slice_heads": R, "slices": slices, "tiles": tiles,
            "blocks": Bt * nc * len(slices) * (tiles if bf16 else 1),
            "scratch": scratch, "scratch_bytes": 4 * sum(scratch.values())}


def ssd_chunk_bwd_cuda(x, dt, b, c, a, dy, dstates, dcum):
    """Launch the backward kernel; returns ``(dx, ddt, db, dc, da)``: dx in
    x's dtype, ddt and da fp32, db and dc new contiguous tensors in b's
    dtype.  ``None`` for an output gradient passes zeros.  dy is read like
    x (its rows copied into place first when they are not aligned so),
    dstates and dcum through any strides.  The partials that the fixed-order
    sums read (``ssd_bwd_geometry``: bf16, dB and dC a slice of heads) are
    allocated here, in one buffer."""
    what = "ssd_chunk_bwd kernel"
    dy, dstates, dcum = _grads_in(x, b, dy, dstates, dcum)
    Bt, nc, Q, H, hp = x.shape
    G, N = b.shape[3], b.shape[4]
    for name, t, shape, dtype in (("dy", dy, x.shape, x.dtype),
                                  ("dstates", dstates, (Bt, nc, H, N, hp), torch.float32),
                                  ("dcum", dcum, (Bt, nc, Q, H), torch.float32)):
        if t.dtype != dtype:
            raise TypeError(f"{what}: {name} must be {dtype}; got {t.dtype}")
        if t.shape != shape or t.device != x.device:
            raise ValueError(f"{what}: {name} must be {tuple(shape)} on {x.device}; got "
                             f"{tuple(t.shape)} on {t.device}")
    _check(x, dt, b, c, a, what)
    elems = 16 // x.element_size()
    if dy.stride(4) != 1 or dy.data_ptr() % 16 or any(s % elems for s in dy.stride()[:4]):
        dy = dy.clone(memory_format=torch.contiguous_format)
    dx = torch.empty((Bt, nc, Q, H, hp), dtype=x.dtype, device=x.device)
    ddt = torch.empty((Bt, nc, Q, H), dtype=torch.float32, device=x.device)
    db = torch.empty((Bt, nc, Q, G, N), dtype=b.dtype, device=x.device)
    dc = torch.empty_like(db)
    da = torch.empty((H,), dtype=torch.float32, device=x.device)
    bf16 = x.dtype == torch.bfloat16
    geo = ssd_bwd_geometry(Bt, nc, Q, H, G, hp, N, bf16)
    scratch = torch.empty(sum(geo["scratch"].values()), dtype=torch.float32, device=x.device)
    parts, at = {}, 0
    for name, n in geo["scratch"].items():
        parts[name] = scratch.data_ptr() + 4 * at if n else None
        at += n
    strides = (_strides(x, 4) + _strides(dt, 4) + _strides(b, 4) + _strides(c, 4)
               + _strides(dy, 4) + list(dstates.stride()) + _strides(dcum, 4)
               + _strides(dx, 4) + _strides(ddt, 4) + [a.stride(0)])
    arr = (ctypes.c_longlong * len(strides))(*strides)
    launch("ssd_chunk_bwd", _BWD_ARGTYPES, x.device, x.data_ptr(), dt.data_ptr(),
           b.data_ptr(), c.data_ptr(), a.data_ptr(), dy.data_ptr(), dstates.data_ptr(),
           dcum.data_ptr(), dx.data_ptr(), ddt.data_ptr(), db.data_ptr(), dc.data_ptr(),
           da.data_ptr(), parts["pdb"], parts["pdc"], parts["pvec"], parts["pda"],
           ctypes.addressof(arr), Bt, nc, Q, H, G, hp, N, geo["slice_heads"], int(bf16))
    return dx, ddt, db, dc, da


def ssd_chunk_bwd(x, dt, b, c, a, dy, dstates, dcum):
    """The plain backward for CPU (or ``meta``) tensors, the kernel for CUDA
    tensors."""
    run = ssd_chunk_bwd_plain if x.device.type in PLAIN_DEVICES else ssd_chunk_bwd_cuda
    return kernel_call("ssd_chunk_bwd", ssd_chunk_bwd_plain, run, x, dt, b, c, a, dy, dstates,
                       dcum)


class SSDChunk(torch.autograd.Function):
    """Forward: ``ssd_chunk_fwd``.  Backward: ``ssd_chunk_bwd``, from the
    saved inputs (the decay and the scores are recomputed, nothing else is
    saved)."""

    @staticmethod
    def forward(ctx, x, dt, b, c, a):
        ctx.save_for_backward(x, dt, b, c, a)
        return ssd_chunk_fwd(x, dt, b, c, a)

    @staticmethod
    def backward(ctx, dy, dstates, dcum):
        grads = ssd_chunk_bwd(*ctx.saved_tensors, dy, dstates, dcum)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad, strict=True))
