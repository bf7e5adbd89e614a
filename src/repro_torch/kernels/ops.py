"""Public wrappers of the kernels.

* dispatch is by the tensor's device: a CPU tensor takes the plain PyTorch
  version, a CUDA tensor launches the CUDA kernel or raises — there is no
  fallback from one to the other;
* a ``DTensor`` goes through ``local_map`` to the same wrapper on its local
  shard (so the kernel on CUDA, the plain version on the CPU), after a check
  that its placements allow it — flash: batch and heads sharded only;
  rmsnorm: the last dim replicated; ssd_chunk: batch and heads only;
  fused_adam: any placement, shared by p, g, m and v of a leaf.  Anything
  else raises with the offending placement: nothing is gathered in silence,
  but by ``causal_conv_silu``, which takes each rank's batch rows and
  channels with the whole sequence (``causal_conv_placements``: a sharded
  sequence is gathered, as the plain conv's ``local_map`` does).  The
  gradients of replicated operands come back ``Partial`` where another
  operand is sharded (``sharding.grad_placements``);
* a ``meta`` tensor takes the plain version too: its operators give outputs
  of the right shapes and dtypes on ``meta`` and compute nothing, and the
  dry-run's FLOP counters see them (``build.PLAIN_DEVICES``);
* ``flash_attention`` is one ``torch.autograd.Function`` wiring the recompute
  backward (dq kernel, then dk/dv kernel) from the saved ``(q,k,v,o,lse)``;
  ``rmsnorm`` is one whose backward is the rmsnorm backward kernel,
  ``ssd_chunk``'s is the SSD chunk's backward kernel (the TPU kernels have
  none: JAX differentiates the reference), and ``causal_conv_silu``'s the
  causal conv's backward kernel (a kernel with no TPU counterpart);
* ``fused_adam_multi`` updates lists of leaves in place, one launch per
  dtype group (``fused_adam`` is a list of one);
* ``LAUNCHES`` counts the launches of every C entry point: the seven kernels
  and the rmsnorm, SSD chunk and causal conv backwards (``build.LAUNCHES``);
* every wrapper makes its choice between kernel and plain version through
  ``build.kernel_call``, which an active trace (``core/trace.py``) records as
  one node a launch.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..distributed import sharding
from . import flash_attention as _fa
from . import fused_adam as _ad
from .build import LAUNCHES, PLAIN_DEVICES, kernel_call  # noqa: F401  (LAUNCHES: re-export)
from .causal_conv import CausalConvSilu
from .ref import from_heads, to_heads
from .rmsnorm import RMSNorm
from .ssd_chunk import SSDChunk


def _plain(t: torch.Tensor) -> bool:
    return t.device.type in PLAIN_DEVICES


# -- DTensor routes ---------------------------------------------------------


def check_placements(what: str, named, allowed) -> None:
    """Raise unless every placement of each ``(name, DTensor)`` in ``named``
    is ``Replicate()`` or ``Shard(d)`` with ``d`` in ``allowed[name]``."""
    for name, t in named:
        if not isinstance(t, DTensor):
            raise TypeError(f"{what}: {name} is not a DTensor, unlike the first operand")
        for i, pl in enumerate(t.placements):
            if pl.is_replicate() or (pl.is_shard() and pl.dim % t.dim() in allowed[name]):
                continue
            raise ValueError(
                f"{what}: {name} has placement {pl} on mesh dim {i} "
                f"({t.device_mesh.mesh_dim_names[i]!r}); the kernel takes "
                f"Replicate() or Shard(d) for d in {sorted(allowed[name])}")


def mesh_call(body, args, out_placements):
    """``body`` on the local shards of ``args`` (DTensors on one mesh, taken
    with the placements they have: nothing is redistributed), the gradients'
    placements by ``sharding.grad_placements``; ``out_placements`` holds one
    placement tuple an output."""
    pls = tuple(tuple(a.placements) for a in args)
    return sharding.local_map(body, out_placements, pls, args[0].device_mesh,
                              redistribute_inputs=False)(*args)


def kv_heads_for(h0: int, h_loc: int, group: int):
    """The kv heads that q heads ``h0 … h0 + h_loc − 1`` read (q head h reads
    kv head h // group), as an index of the whole kv head dim: a slice where
    the local heads keep whole groups in order (``h_loc / group`` kv heads, or
    all on one), else one kv head per q head (a gather, whose gradient
    autograd sums back)."""
    kv0, kv1 = h0 // group, (h0 + h_loc - 1) // group + 1
    n = kv1 - kv0
    if h_loc % n == 0 and all((h0 + j) // group - kv0 == j // (h_loc // n)
                              for j in range(h_loc)):
        return slice(kv0, kv1)
    return torch.arange(h0, h0 + h_loc) // group


def _flash_mesh(q, k, v, causal, window):
    """``flash_attention`` on DTensors: batch and heads sharded only.  Where
    q's heads are sharded and K/V's are not (``kv_heads`` that do not divide
    'model'), each rank takes the kv heads its q heads read
    (``kv_heads_for``); dk and dv come back ``Partial`` and are summed."""
    what = "flash_attention"
    check_placements(what, (("q", q), ("k", k), ("v", v)), {"q": {0, 2}, "k": {0, 2},
                                                             "v": {0, 2}})
    if tuple(k.placements) != tuple(v.placements):
        raise ValueError(f"{what}: k {k.placements} and v {v.placements} differ")
    q_heads = tuple(pl.is_shard(2) for pl in q.placements)
    kv_heads = tuple(pl.is_shard(2) for pl in k.placements)
    for i, (pq, pk) in enumerate(zip(q.placements, k.placements, strict=True)):
        if pq.is_shard(0) != pk.is_shard(0):
            raise ValueError(f"{what}: q {pq} and k {pk} on mesh dim {i} "
                             f"({q.device_mesh.mesh_dim_names[i]!r}) shard batch unlike")
    if any(kv_heads) and kv_heads != q_heads:
        raise ValueError(f"{what}: q {q.placements} and k {k.placements} shard heads over "
                         "different mesh dims")
    group = q.shape[2] // k.shape[2]
    regroup = any(q_heads) and not any(kv_heads)

    def body(ql, kl, vl):
        if regroup:
            h_loc = ql.shape[2]
            h0 = sharding.block_index(q.device_mesh, q.placements, 2) * h_loc
            idx = kv_heads_for(h0, h_loc, group)
            kl, vl = kl[:, :, idx], vl[:, :, idx]
        return _FlashAttention.apply(ql, kl, vl, causal, window)

    return mesh_call(body, (q, k, v), (tuple(q.placements),))


def _lse_placements(q) -> tuple:
    """q's (B,S,H,hd) placements as those of lse / delta (B,H,S)."""
    return tuple(Shard(1) if pl.is_shard(2) else pl for pl in q.placements)


def _check_same_heads(what, q, k, v, *more) -> None:
    """The low-level flash wrappers on DTensors: q, k and v (and do; lse and
    delta in their layout) must share one placement, batch and heads only
    (``flash_attention`` regroups GQA heads)."""
    check_placements(what, (("q", q), ("k", k), ("v", v)), {"q": {0, 2}, "k": {0, 2},
                                                             "v": {0, 2}})
    for name, t in (("k", k), ("v", v), *more):
        want = tuple(q.placements) if t.dim() == 4 else _lse_placements(q)
        if tuple(t.placements) != want:
            raise ValueError(f"{what}: {name} has placements {t.placements}, q "
                             f"{q.placements}: they must agree (flash_attention regroups "
                             "GQA heads)")


def flash_fwd(q, k, v, causal=True, window=None, scale=None):
    """(o, lse).  q: (B,S,H,hd); k/v: (B,T,Kv,hd); lse: (B,H,S) fp32."""
    if isinstance(q, DTensor):
        _check_same_heads("flash_fwd", q, k, v)
        return mesh_call(lambda *a: flash_fwd(*a, causal, window, scale), (q, k, v),
                         (tuple(q.placements), _lse_placements(q)))
    run = _fa.flash_fwd_plain if _plain(q) else _fa.flash_fwd_cuda
    return kernel_call("flash_fwd", _fa.flash_fwd_plain, run, q, k, v, causal, window, scale)


def flash_dq(q, k, v, do, lse, delta, causal=True, window=None, scale=None):
    if isinstance(q, DTensor):
        _check_same_heads("flash_dq", q, k, v, ("do", do), ("lse", lse), ("delta", delta))
        return mesh_call(lambda *a: flash_dq(*a, causal, window, scale),
                         (q, k, v, do, lse, delta), (tuple(q.placements),))
    run = _fa.flash_dq_plain if _plain(q) else _fa.flash_dq_cuda
    return kernel_call("flash_dq", _fa.flash_dq_plain, run, q, k, v, do, lse, delta, causal,
                       window, scale)


def flash_dkv(q, k, v, do, lse, delta, causal=True, window=None, scale=None):
    if isinstance(q, DTensor):
        _check_same_heads("flash_dkv", q, k, v, ("do", do), ("lse", lse), ("delta", delta))
        return mesh_call(lambda *a: flash_dkv(*a, causal, window, scale),
                         (q, k, v, do, lse, delta), (tuple(k.placements),) * 2)
    run = _fa.flash_dkv_plain if _plain(q) else _fa.flash_dkv_cuda
    return kernel_call("flash_dkv", _fa.flash_dkv_plain, run, q, k, v, do, lse, delta, causal,
                       window, scale)


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
    if isinstance(q, DTensor):
        return _flash_mesh(q, k, v, causal, window)
    return _FlashAttention.apply(q, k, v, causal, window)


def rmsnorm(x, scale, eps: float = 1e-6):
    """x: (..., d); scale: (d,) fp32.  ``x·rsqrt(mean(x²)+eps)·(1+scale)`` in
    fp32, cast once to x's dtype.  On DTensors the last dim must be
    replicated; ``dscale`` comes back ``Partial`` over the mesh dims that
    shard ``x``."""
    if isinstance(x, DTensor):
        check_placements("rmsnorm", (("x", x), ("scale", scale)),
                         {"x": set(range(x.dim() - 1)), "scale": set()})
        return mesh_call(lambda xl, sl: RMSNorm.apply(xl, sl, eps), (x, scale),
                         (tuple(x.placements),))
    return RMSNorm.apply(x, scale, eps)


def fused_adam_multi(ps, gs, ms, vs, count, lr, b1=0.9, b2=0.95, eps=1e-8,
                     weight_decay=0.0):
    """One AdamW step on lists of leaves of any shapes, **in place** on every
    ``p``, ``m`` and ``v``.  ``count``: the post-increment step, an int32
    tensor on the leaves' device.  The plain version when every leaf lies on
    the CPU (or on ``meta``); otherwise the kernel, which raises for a leaf off the device.
    DTensor leaves: p, g, m and v of a leaf must share one placement, and the
    update runs on the local shards."""
    if any(isinstance(t, DTensor) for t in (*ps, *gs, *ms, *vs)):
        for i, leaf in enumerate(zip(ps, gs, ms, vs, strict=True)):
            pls = [getattr(t, "placements", None) for t in leaf]
            if None in pls or len({tuple(pl) for pl in pls}) != 1:
                raise ValueError(f"fused_adam: leaf {i} has p, g, m, v placements {pls} "
                                 "(None: not a DTensor); they must share one")
        local = [[t.to_local() for t in ts] for ts in (ps, gs, ms, vs)]
        if isinstance(count, DTensor):
            count = count.to_local()
        fused_adam_multi(*local, count, lr, b1, b2, eps, weight_decay)
    else:
        # one call a launch group, so that a trace records one node a launch
        plain = _ad.fused_adam_multi_plain
        run = plain if all(_plain(p) for p in ps) else _ad.fused_adam_multi_cuda
        for idx in _ad.launch_groups(ps, gs, ms):
            leaves = [[ts[i] for i in idx] for ts in (ps, gs, ms, vs)]
            kernel_call("fused_adam", plain, run, *leaves, count, lr, b1, b2, eps, weight_decay,
                        written=(0, 2, 3))


def fused_adam(p, g, m, v, count, lr, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0):
    """``fused_adam_multi`` on one leaf."""
    fused_adam_multi([p], [g], [m], [v], count, lr, b1, b2, eps, weight_decay)


def ssd_chunk_heads(x, dt, b, c, a):
    """SSD within chunks in the model's layout (see ``kernels/ssd_chunk.py``):
    x (Bt,nc,Q,H,hp), dt (Bt,nc,Q,H), b/c (Bt,nc,Q,G,N), a (H,).  Returns
    (y (Bt,nc,Q,H,hp), states (Bt,nc,H,N,hp) fp32, cum (Bt,nc,Q,H) fp32).
    On DTensors: batch and heads sharded only; b and c shard their groups as
    x its heads, or hold one group replicated."""
    if isinstance(x, DTensor):
        return _ssd_mesh(x, dt, b, c, a)
    return SSDChunk.apply(x, dt, b, c, a)


def _ssd_mesh(x, dt, b, c, a):
    what = "ssd_chunk"
    check_placements(what, (("x", x), ("dt", dt), ("b", b), ("c", c), ("a", a)),
                     {"x": {0, 3}, "dt": {0, 3}, "b": {0, 3}, "c": {0, 3}, "a": {0}})
    heads = tuple(pl.is_shard(3) for pl in x.placements)
    batch = tuple(pl.is_shard(0) for pl in x.placements)
    for name, t, hd in (("dt", dt, 3), ("a", a, 0)):
        if tuple(pl.is_shard(hd) for pl in t.placements) != heads:
            raise ValueError(f"{what}: {name} {t.placements} must shard heads as x does "
                             f"{x.placements}")
    for name, t in (("dt", dt), ("b", b), ("c", c)):
        if tuple(pl.is_shard(0) for pl in t.placements) != batch:
            raise ValueError(f"{what}: {name} {t.placements} must shard batch as x does "
                             f"{x.placements}")
    for name, t in (("b", b), ("c", c)):
        groups = tuple(pl.is_shard(3) for pl in t.placements)
        if groups != heads and (any(groups) or t.shape[3] != 1):
            raise ValueError(f"{what}: {name} {t.placements} must shard its groups as x "
                             f"its heads {x.placements}, or hold one group replicated")
    states = tuple(Shard(2) if pl.is_shard(3) else pl for pl in x.placements)
    return mesh_call(SSDChunk.apply, (x, dt, b, c, a),
                     (tuple(x.placements), states, tuple(dt.placements)))


def ssd_chunk(x, dt, b, c, a):
    """The reference's signature and layout: x (BH,nc,Q,hp); dt (BH,nc,Q);
    b/c (BH,nc,Q,N); a (BH,).  Returns (y_intra (BH,nc,Q,hp), states
    (BH,nc,N,hp) fp32, cum (BH,nc,Q) fp32) — views into the model-layout
    outputs (Bt = 1, one group per head)."""
    return from_heads(*ssd_chunk_heads(*to_heads(x, dt, b, c), a))


def causal_conv_placements(u) -> tuple[tuple, tuple]:
    """The placements a causal conv's ``local_map`` body takes for u
    (B,S,C) and w (cw,C): u's batch and channel shards kept and its sequence
    replicated (the conv crosses positions, never batch rows or channels),
    w's channels sharded as u's."""
    u_pl = tuple(pl if pl.is_shard(0) or pl.is_shard(2) else Replicate()
                 for pl in u.placements)
    w_pl = tuple(Shard(1) if pl.is_shard(2) else Replicate() for pl in u_pl)
    return u_pl, w_pl


def causal_conv_silu(u, w):
    """``silu(conv(u, w))`` in u's dtype, the depthwise causal conv along
    axis 1 (see ``kernels/causal_conv.py``): u (B,S,C) bf16 or fp32, w
    (cw,C) fp32.  On DTensors, a ``local_map`` body over each rank's batch
    rows and channels with the whole sequence; a replicated w's gradient
    comes back ``Partial`` over the mesh dims that shard u's batch."""
    if isinstance(u, DTensor):
        u_pl, w_pl = causal_conv_placements(u)
        return sharding.local_map(CausalConvSilu.apply, (u_pl,), (u_pl, w_pl),
                                  u.device_mesh)(u, w)
    return CausalConvSilu.apply(u, w)
