"""Optimizers on nested dicts of tensors.

API as in the reference: ``opt.init(params) -> state``;
``opt.update(grads, state, params, step) -> (new_params, new_state)``.
Unlike the reference's pure functions, ``update`` and
``clip_by_global_norm`` **work in place** (under ``torch.no_grad()``): the
returned trees hold the same tensors that came in, now updated, so a 1 B
parameter model does not hold two copies of its state.  Callers must not keep
the old values.

This slice ports AdamW; the other optimizers of the reference raise until
their slice.  The update is ``kernels.ops.fused_adam``, one call per leaf:
the plain PyTorch version for CPU tensors, the CUDA kernel for CUDA tensors
(the same fp32 formula; the reference's optimizer computes it outside its
kernel, the port goes through the kernel).
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

        def upd(p, g, m, v):
            # fp32 math; weight decay acts on the old p; in place
            ops.fused_adam(p, g, m, v, count, lr_t, b1, b2, eps, weight_decay)

        tree_map(upd, params, grads, state["m"], state["v"])
        return params, {"m": state["m"], "v": state["v"], "count": count}

    return Optimizer("adamw", init, update)


def make_optimizer(name: str, lr=3e-4, state_dtype: str = "float32", **kw
                   ) -> Optimizer:
    if name == "adamw":
        return adamw(lr, state_dtype=state_dtype, **kw)
    if name in ("sgd_momentum", "adafactor", "galore_adamw"):
        raise NotImplementedError(
            f"optimizer {name!r} is not ported yet: it waits for the "
            "remaining-optimizers slice of the port")
    raise KeyError(f"unknown optimizer {name!r}")
