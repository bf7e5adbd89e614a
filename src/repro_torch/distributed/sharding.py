"""Logical-axis sharding rules (MaxText-style) for the production mesh, on
PyTorch's ``DeviceMesh`` and ``DTensor``.

Physical mesh axes:
  * single-pod:  ('data', 'model')            — 16 × 16 = 256 ranks
  * multi-pod:   ('pod', 'data', 'model')     — 2 × 16 × 16 = 512 ranks

Logical axes used by models and optimizers map onto physical axes via
``RULES`` (the reference's table, copied).  Rules are resolved against the
actual mesh, silently dropping axes the mesh does not have, so the same model
code runs single- and multi-pod.

Parameter layout (ZeRO/FSDP hybrid):
  * weights:   embed-dim sharded over 'data' (FSDP), ff/heads/vocab over
    'model' (TP); replicated across 'pod' (grads all-reduced over 'pod').
  * optimizer states: additionally sharded over 'pod' (ZeRO-across-pods).
  * activations: batch over ('pod','data'), heads/ffn/vocab over 'model'.

``pspec`` returns a ``P``: one entry per tensor dim, ``None``, a bare axis
name, or a tuple of names (the reference's ``PartitionSpec`` structure, entry
for entry).  ``placements`` turns a spec into DTensor placements: for each
mesh dim, ``Shard(d)`` of the tensor dim that names it, else ``Replicate()``.
A tensor dim over several axes shards over each of their mesh dims, the
first named the major split, as in JAX; the axes must appear in the mesh's
order (every rule names them so).

The resolvers read only a mesh's ``mesh_dim_names`` and ``shape``: a
``DeviceMesh``, or any object with those two attributes (no process group
needed).
"""

from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

# logical axis -> tuple of physical mesh axes (first existing ones are used)
RULES: dict[str, tuple] = {
    "batch": ("pod", "data"),
    "seq": (),                      # replicated by default (no SP)
    "seq_sp": ("model",),           # Megatron-style sequence parallelism for
                                    # the residual stream between blocks
    "kv_seq": ("model",),           # KV-cache seq dim: TP axis by default
                                    # (kv_heads < model size cannot shard);
                                    # long_500k overrides to (pod,data,model)
    "embed": ("data",),             # FSDP shard dim of weights
    "embed_act": (),                # activation d_model dim: replicated
    "heads": ("model",),
    "kv_heads": ("model",),
    "ffn": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "expert_ffn": (),
    "zero": ("pod", "data"),        # optimizer-state extra sharding
    "conv": (),
    "state": (),
    None: (),
}


class P(tuple):
    """A partition spec: one entry per tensor dim (``None``, an axis name, or
    a tuple of axis names), compared as a tuple."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a mesh."""
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape), strict=True))


_ctx = threading.local()


def current_mesh():
    return getattr(_ctx, "mesh", None)


def current_rules() -> dict:
    return getattr(_ctx, "rules", RULES)


@contextlib.contextmanager
def rules_override(**overrides):
    """Per-launch logical-rule overrides, e.g. long_500k (global_batch=1):
    ``rules_override(batch=(), kv_seq=('pod', 'data', 'model'))`` moves the
    sharding from the (size-1) batch dim onto the KV sequence dim."""
    old = current_rules()
    new = dict(old)
    for k, v in overrides.items():
        if k not in RULES:
            raise KeyError(f"unknown logical axis {k!r}")
        new[k] = tuple(v)
    _ctx.rules = new
    try:
        yield
    finally:
        _ctx.rules = old


@contextlib.contextmanager
def use_mesh(mesh):
    """Activate a mesh for the logical-axis helpers (thread-local)."""
    old = current_mesh()
    _ctx.mesh = mesh
    try:
        yield mesh
    finally:
        _ctx.mesh = old


def resolve_axes(logical: str | None, mesh) -> tuple:
    rules = current_rules()
    phys = rules.get(logical, ())
    if logical is not None and logical not in rules:
        raise KeyError(f"unknown logical axis {logical!r}")
    return tuple(a for a in phys if a in mesh.mesh_dim_names)


def pspec(logical_axes, mesh=None) -> P:
    """Logical axes (one entry per tensor dim; None = replicated) → ``P``
    resolved against the mesh.  A logical axis whose rule names several
    physical axes resolves to a tuple entry (even when only one of them is on
    this mesh); a single-axis rule resolves to the bare name.  A physical
    axis is used at most once in a spec."""
    mesh = mesh or current_mesh()
    if mesh is None:
        return P()
    rules = current_rules()
    used: set = set()
    parts = []
    for ax_ in logical_axes:
        if ax_ is not None and ax_ not in rules:
            raise KeyError(f"unknown logical axis {ax_!r}")
        rule = rules.get(ax_, ())
        phys = tuple(a for a in rule if a in mesh.mesh_dim_names and a not in used)
        used.update(phys)
        if len(phys) == 0:
            parts.append(None)
        elif len(rule) > 1:
            parts.append(tuple(phys))
        else:
            parts.append(phys[0])
    return P(*parts)


def prune_pspec(shape: tuple, spec: P, mesh) -> P:
    """Drop physical axes that do not divide the dim size (e.g. kv_heads=1
    cannot shard over model=16 — it falls back to replicated)."""
    sizes = axis_sizes(mesh)
    parts = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, part in zip(shape, parts, strict=False):
        if part is None:
            out.append(None)
            continue
        axes = part if isinstance(part, tuple) else (part,)
        keep, size = [], 1
        for a in axes:
            m = sizes[a]
            if dim % (size * m) == 0:
                keep.append(a)
                size *= m
        out.append(tuple(keep) if len(keep) > 1 else (keep[0] if keep else None))
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def placements(spec: P, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    ``Shard(d)`` of the tensor dim whose entry names it, else ``Replicate()``
    (also over a mesh dim of size 1, where the one block is the whole: the
    same layout, and DTensor plans its redistributions faster).  Raises if a tensor dim names its axes out of the mesh's
    order (DTensor's default order splits by the earlier mesh dim first)."""
    names = list(mesh.mesh_dim_names)
    sizes = axis_sizes(mesh)
    out = [Replicate()] * len(names)
    for d, part in enumerate(spec):
        if part is None:
            continue
        axes = part if isinstance(part, tuple) else (part,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {part!r} names its axes out of the mesh's "
                             f"order {tuple(names)}")
        for i in idx:
            if sizes[names[i]] > 1:     # one block over a size-1 axis: replicated
                out[i] = Shard(d)
    return tuple(out)


def local_map(body, out_placements, in_placements, mesh, redistribute_inputs=True):
    """The counterpart of the reference's ``shard_map``: PyTorch's
    ``local_map`` — ``body`` on the local shards of its inputs, brought to
    ``in_placements`` (or checked against them, without
    ``redistribute_inputs``), its outputs wrapped with ``out_placements``
    (one placement tuple an output, ``None`` for a non-tensor).  The inputs'
    gradients get ``grad_placements(in_placements)``: a replicated operand
    used beside a sharded one has a partial gradient on each rank."""
    from torch.distributed.tensor.experimental import local_map as lm
    in_placements = tuple(tuple(p) for p in in_placements)
    watcher = getattr(_ctx, "body_watcher", None)
    if watcher is not None:
        body = watcher(body, in_placements, mesh)
    return lm(body, out_placements=out_placements, in_placements=in_placements,
              in_grad_placements=grad_placements(in_placements), device_mesh=mesh,
              redistribute_inputs=redistribute_inputs)


@contextlib.contextmanager
def watch_local_maps(watcher):
    """While active (on this thread), every ``local_map`` body is replaced by
    ``watcher(body, in_placements, mesh)``: the dry-run's FLOP count scales
    a body's operators by the blocks its work is split into."""
    old = getattr(_ctx, "body_watcher", None)
    _ctx.body_watcher = watcher
    try:
        yield
    finally:
        _ctx.body_watcher = old


def block_index(mesh, placements, dim: int) -> int:
    """This rank's block of tensor dim ``dim`` under ``placements``:
    row-major over the mesh dims that shard it, the first the major split."""
    coord, idx = mesh.get_coordinate(), 0
    for i, pl in enumerate(placements):
        if pl.is_shard(dim):
            idx = idx * mesh.size(i) + int(coord[i])
    return idx


def take_in_block(idx, off: int, n: int, take):
    """``take`` at the global indices ``idx`` of a dim whose block
    ``[off, off + n)`` this rank holds: the indices are clipped into the
    block, taken, and the result is zero where they fall outside it (another
    rank's block holds those; a ``Partial`` sum over the ranks completes
    it).  ``take(local_idx)`` indexes the block; its result has ``idx``'s
    shape, plus trailing dims."""
    idx = idx.long()
    x = take((idx - off).clamp(0, n - 1))
    ok = (idx >= off) & (idx < off + n)
    ok = ok.reshape(ok.shape + (1,) * (x.dim() - ok.dim()))
    return torch.where(ok, x, torch.zeros((), dtype=x.dtype, device=x.device))


def unflatten(t, dim: int, sizes):
    """``t`` with dim ``dim`` split into ``sizes``.  A DTensor whose dim is
    sharded into blocks that do not hold whole slices of ``sizes[0]`` (40
    MLA heads of a 40·hd dim on 'model' = 16, where 40·hd divides) is
    gathered on that dim first, as XLA reshards the reference's reshape."""
    d = dim % t.dim()
    if isinstance(t, DTensor):
        pls = tuple(t.placements)
        blocks = math.prod(t.device_mesh.size(i) for i, pl in enumerate(pls) if pl.is_shard(d))
        if sizes[0] % blocks:
            t = t.redistribute(t.device_mesh,
                               tuple(Replicate() if pl.is_shard(d) else pl for pl in pls))
    return t.reshape(*t.shape[:d], *sizes, *t.shape[d + 1:])


def shard(x, *logical_axes):
    """The reference's ``with_sharding_constraint`` by logical axes: a no-op
    without a mesh; otherwise ``x`` redistributed to the pruned spec's
    placements (a plain tensor is taken as replicated first).  Axes that do
    not divide the dim are dropped (replicated)."""
    mesh = current_mesh()
    if mesh is None:
        return x
    if x.dim() != len(logical_axes):
        raise ValueError(f"rank {x.dim()} vs axes {logical_axes}")
    spec = prune_pspec(tuple(x.shape), pspec(logical_axes, mesh), mesh)
    want = placements(spec, mesh)
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


# ---------------------------------------------------------------------------
# tree-of-logical-axes helpers (params / opt-state / batch shardings)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Ax:
    """A leaf annotation: logical axes for one tensor."""
    axes: tuple

    def __iter__(self):
        return iter(self.axes)


def ax(*axes) -> Ax:
    return Ax(tuple(axes))


def map_axes(fn, axes_tree, *rest):
    """Map over the ``Ax`` leaves of nested dicts (and matching trees)."""
    if isinstance(axes_tree, Ax):
        return fn(axes_tree, *rest)
    return {k: map_axes(fn, axes_tree[k], *(r[k] for r in rest)) for k in sorted(axes_tree)}


def shardings_for(abstract_tree, axes_tree, mesh=None):
    """Shape-aware placements: each leaf's spec pruned so every mesh axis
    divides its dim, as DTensor placements.  ``abstract_tree`` holds
    tensors (``meta`` or real) or anything with a ``shape``."""
    mesh = mesh or current_mesh()

    def f(a, t):
        return placements(prune_pspec(tuple(t.shape), pspec(a.axes, mesh), mesh), mesh)

    return map_axes(f, axes_tree, abstract_tree)


def zero_state_axes(param_axes: Ax) -> Ax:
    """Optimizer-state layout: params' layout with the FSDP dim upgraded to
    the ZeRO axes (pod,data) when the param is embed-sharded."""
    return Ax(tuple("zero" if a == "embed" else a for a in param_axes.axes))


def mesh_devices_summary(mesh) -> dict:
    sizes = axis_sizes(mesh)
    return {"axis_names": list(sizes), "shape": list(sizes.values()),
            "n_devices": int(math.prod(sizes.values()))}


def whole(t):
    """A DTensor as the whole tensor every rank holds (a collective: call it
    on every rank in the same order), else ``t``."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def distribute(t: torch.Tensor, mesh, place) -> DTensor:
    """A tensor every rank holds whole → a DTensor with ``place``: each rank
    keeps its own block (no collective; the ranks must agree on ``t``)."""
    full = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return full.redistribute(mesh, place)


def grad_like_value(x):
    """``x`` itself, but its gradient is brought to ``x``'s placements in the
    backward (a DTensor's gradient may come back sharded where ``x`` is not:
    (B, S, H·hd) sharded over 'model' cannot be unflattened into H = 4 heads
    on 16 ranks)."""
    if not isinstance(x, DTensor):
        return x
    return _GradLikeValue.apply(x)


class _GradLikeValue(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.placements = x.device_mesh, tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(ctx.mesh, ctx.placements)


def grad_placements(in_placements) -> tuple:
    """The placements of the gradients of a ``local_map`` body's inputs: an
    input keeps its own placement on a mesh dim where it is sharded; where it
    is replicated, its local gradient is a partial sum (``Partial()``) if any
    other input is sharded on that dim (each rank saw only its share: the
    rmsnorm ``scale`` under batch-sharded ``x``, K/V replicated under
    head-sharded q), else the whole gradient (``Replicate()``)."""
    in_placements = [tuple(p) for p in in_placements]
    n = len(in_placements[0])
    sharded = [any(pl[i].is_shard() for pl in in_placements) for i in range(n)]
    return tuple(tuple(Partial() if (pl[i].is_replicate() and sharded[i]) else pl[i]
                       for i in range(n)) for pl in in_placements)
