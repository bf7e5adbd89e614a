"""Optimizers on nested dicts of tensors.

API as in the reference: ``opt.init(params) -> state``;
``opt.update(grads, state, params, step) -> (new_params, new_state)``.
Unlike the reference's pure functions, ``update`` and
``clip_by_global_norm`` **work in place** (under ``torch.no_grad()``): the
returned trees hold the same tensors that came in, now updated, so a 1 B
parameter model does not hold two copies of its state.  Callers must not keep
the old values.

* ``adamw`` — the update is ``kernels.ops.fused_adam_multi``, one call a step
  over every leaf: the plain PyTorch version for CPU tensors, the CUDA kernel
  for CUDA tensors, one launch per dtype group (the same fp32 formula; the
  reference's optimizer computes it outside its kernel, the port goes through
  the kernel).
* ``sgd_momentum`` — the other optimizer MONET puts into the training graph
  (paper §III): fp32 velocity ``{"v"}``.
* ``adafactor`` — factored second moment, O(rows + cols) state: a leaf of two
  or more dimensions keeps ``{"r", "c"}`` over its last two axes (a stacked
  ``(n, d, f)`` leaf keeps ``r`` (n, d) and ``c`` (n, f)), a vector ``{"v"}``;
  the update's RMS clip is taken over the whole leaf, as the reference's.
* ``galore_adamw`` — GaLore-style Adam whose moments live in a rank-r space
  for 2-D leaves with ``min(shape) > 4·rank``: ``{"P", "m", "v"}`` with an
  orthonormal (d, r) ``P``, else ``{"m", "v"}``.

The last three are plain PyTorch (no kernel exists for them, on the TPU
either) and keep the reference's state trees leaf for leaf, so checkpoints
load both ways.  Their step counters are int32 tensors on the leaves' device
and their bias and decay terms fp32 tensors there: no host synchronisation.
"""

from __future__ import annotations

import math
from collections.abc import Callable
from dataclasses import dataclass

import torch

from .. import torch_dtype
from ..convert import tree_leaves, tree_map
from ..kernels import ops


@dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable
    update: Callable


def warmup_cosine(base_lr: float, warmup: int = 100, total: int = 10000,
                  min_frac: float = 0.1):
    """Linear warm-up then cosine decay, evaluated in fp32 like the
    reference's.  Returns a 0-dim fp32 CPU tensor."""
    def lr(step):
        step = torch.as_tensor(step, dtype=torch.float32).cpu()
        warm = base_lr * torch.clamp((step + 1) / max(warmup, 1), max=1.0)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, base_lr * cos)
    return lr


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(l.float()))
                          for l in tree_leaves(tree)))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """Scales the gradients in place; each keeps its dtype (the product is
    formed in fp32 and rounded once).  Returns (grads, norm before clipping)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in tree_leaves(grads):
        g.mul_(scale)
    return grads, norm


def adamw(lr=3e-4, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.01, state_dtype: str | None = "float32"
          ) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda s: lr)
    sd = torch_dtype(state_dtype) if state_dtype else None

    def init(params):
        z = lambda p: torch.zeros(p.shape, dtype=sd or p.dtype, device=p.device)
        dev = tree_leaves(params)[0].device
        return {"m": tree_map(z, params), "v": tree_map(z, params),
                "count": torch.zeros((), dtype=torch.int32, device=dev)}

    @torch.no_grad()
    def update(grads, state, params, step):
        count = state["count"] + 1
        lr_t = float(lr_fn(step))

        leaves = []
        tree_map(lambda *t: leaves.append(t), params, grads, state["m"], state["v"])
        # fp32 math; weight decay acts on the old p; in place
        ops.fused_adam_multi(*zip(*leaves, strict=True), count, lr_t, b1, b2, eps,
                             weight_decay)
        return params, {"m": state["m"], "v": state["v"], "count": count}

    return Optimizer("adamw", init, update)


def _count(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)


def _per_leaf(state_tree, params) -> list:
    """The per-leaf state dicts of ``state_tree``, in the order of
    ``tree_leaves(params)`` (the state tree is the parameter tree with a dict
    at each leaf)."""
    if isinstance(params, dict):
        return [s for k in sorted(params) for s in _per_leaf(state_tree[k], params[k])]
    return [state_tree]


def sgd_momentum(lr=1e-2, momentum: float = 0.9) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda s: lr)

    def init(params):
        return {"v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                    device=p.device), params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        lr_t = float(lr_fn(step))

        for p, g, v in zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state["v"]),
                           strict=True):
            v.copy_(momentum * v - lr_t * g.float())
            p.copy_(p.float() + v)
        return params, {"v": state["v"]}

    return Optimizer("sgd_momentum", init, update)


def adafactor(lr=3e-4, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0) -> Optimizer:
    """Factored second moment (Shazeer & Stern): O(rows + cols) state for
    matrices.  ``beta = 1 − count^(−decay)`` is 0 at the first step."""
    lr_fn = lr if callable(lr) else (lambda s: lr)

    def init(params):
        def z(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if p.dim() >= 2:
                return {"r": torch.zeros(p.shape[:-1], **f32),
                        "c": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
            return {"v": torch.zeros(p.shape, **f32)}
        return {"f": tree_map(z, params), "count": _count(params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        count = state["count"] + 1
        beta = 1.0 - count.float() ** (-decay)
        lr_t = float(lr_fn(step))

        def upd(p, g, f):
            g32 = g.float()
            g2 = g32.square() + eps
            if p.dim() >= 2:
                f["r"].copy_(beta * f["r"] + (1 - beta) * g2.mean(dim=-1))
                f["c"].copy_(beta * f["c"] + (1 - beta) * g2.mean(dim=-2))
                r, c = f["r"], f["c"]
                denom = (r[..., None] / torch.clamp(
                    r.mean(dim=-1, keepdim=True)[..., None], min=eps)) * c[..., None, :]
                u = g32 / torch.sqrt(torch.clamp(denom, min=eps))
            else:
                f["v"].copy_(beta * f["v"] + (1 - beta) * g2)
                u = g32 / torch.sqrt(torch.clamp(f["v"], min=eps))
            # over the whole leaf: across the layers of a stacked one
            rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            p.copy_(p.float() - lr_t * u)

        for p, g, f in zip(tree_leaves(params), tree_leaves(grads),
                           _per_leaf(state["f"], params), strict=True):
            upd(p, g, f)
        return params, {"f": state["f"], "count": count}

    return Optimizer("adafactor", init, update)


def galore_adamw(lr=3e-4, rank: int = 64, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, seed: int = 17) -> Optimizer:
    """Low-rank projected Adam (GaLore-flavoured): for 2-D params with
    min-dim > 4·rank, moments are kept in the rank-r projected space.

    ``P`` of the leaf at index ``i`` (sorted-key order) is the Q of a QR of a
    (d, rank) fp32 standard normal drawn on the CPU from
    ``torch.Generator().manual_seed(seed + i)``: orthonormal like the
    reference's, but not its numbers (those come from
    ``jax.random.PRNGKey(seed + i)``, which no torch generator reproduces).
    The products ``P.T @ g`` and ``P @ u`` are fp32."""
    lr_fn = lr if callable(lr) else (lambda s: lr)

    def _proj(p, i):
        if p.dim() != 2 or min(p.shape) <= 4 * rank:
            return None
        gen = torch.Generator().manual_seed(seed + i)
        q, _ = torch.linalg.qr(torch.randn((p.shape[0], rank), generator=gen,
                                           dtype=torch.float32))
        return q.to(p.device)          # (d, r) orthonormal

    def init(params):
        def z(shape, dev):
            return torch.zeros(shape, dtype=torch.float32, device=dev)

        leaves = tree_leaves(params)
        st = []
        for i, p in enumerate(leaves):
            P = _proj(p, i)
            if P is None:
                st.append({"m": z(p.shape, p.device), "v": z(p.shape, p.device)})
            else:
                shp = (rank, p.shape[1])
                st.append({"P": P, "m": z(shp, p.device), "v": z(shp, p.device)})
        it = iter(st)
        return {"s": tree_map(lambda _: next(it), params), "count": _count(params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        count = state["count"] + 1
        lr_t = float(lr_fn(step))
        c1 = 1.0 - b1 ** count.float()
        c2 = 1.0 - b2 ** count.float()

        def upd(p, g, s):
            g32 = g.float()
            low_rank = "P" in s
            gp = s["P"].T @ g32 if low_rank else g32     # (r, cols) compressed
            s["m"].copy_(b1 * s["m"] + (1 - b1) * gp)
            s["v"].copy_(b2 * s["v"] + (1 - b2) * torch.square(gp))
            u = (s["m"] / c1) / (torch.sqrt(s["v"] / c2) + eps)
            du = s["P"] @ u if low_rank else u
            p.copy_(p.float() - lr_t * du)

        for p, g, s in zip(tree_leaves(params), tree_leaves(grads),
                           _per_leaf(state["s"], params), strict=True):
            upd(p, g, s)
        return params, {"s": state["s"], "count": count}

    return Optimizer("galore_adamw", init, update)


OPTIMIZERS = {
    "sgd_momentum": sgd_momentum,
    "adamw": adamw,
    "adafactor": adafactor,
    "galore_adamw": galore_adamw,
}


def make_optimizer(name: str, lr=3e-4, state_dtype: str = "float32", **kw
                   ) -> Optimizer:
    if name == "adamw":
        return adamw(lr, state_dtype=state_dtype, **kw)
    return OPTIMIZERS[name](lr, **kw)


