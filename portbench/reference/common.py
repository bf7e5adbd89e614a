"""Plain fp32 pieces that every model family's reference shares.

Written from the published equations and the training job's description
(``portbench/traffic/*.json`` and the constants below), with plain ``torch``
operations only: no
kernel, no cache, no import of the system under test.  TF32 is switched off
by ``no_tf32`` around every reference run, so an fp32 product is an fp32
product.

``prec`` selects how the products with the weights are computed:

* ``"fp32"``: the reference;
* ``"fp8"``: the control, fp8 training's recipe: both operands of each
  weight product rounded to float8 e4m3 in the forward, the gradient that
  reaches it rounded to e5m2 in the backward, each at one scale a tensor
  (its largest magnitude mapped to the format's largest), the products
  accumulated in fp32.  That is the precision a step below the
  configurations' bf16;
* ``"bf16"``: the same with bf16 operands (no scale): a witness of what the
  configurations' precision alone does to the readings.

The products inside the system's kernels (attention's, the SSD's) stay in
fp32 in all three.
"""

from __future__ import annotations

import contextlib
import math

import torch
from torch.utils.checkpoint import checkpoint

#: the training loss of the port's jobs: mean negative log-likelihood, plus
#: Z_LOSS · mean(lse²), plus AUX_LOSS · the MoE layers' load-balance terms
Z_LOSS = 1e-4
AUX_LOSS = 1e-2
#: rows of the sequence whose logits are formed at a time (each block's
#: logits are recomputed in the backward, so the (B, S, V) table never exists)
LOSS_BLOCK = 512
LOW = {"fp8": (torch.float8_e4m3fn, torch.float8_e5m2), "bf16": (torch.bfloat16,) * 2}
#: the optimizer, its schedule and the clip of every job: what the port's
#: ``Trainer`` builds when it is given only ``lr`` (``adamw()``'s and
#: ``warmup_cosine()``'s defaults in ``optim/optimizers.py``, the clip of
#: ``make_train_step``), which is all the benchmark gives it
ADAMW = {"b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.01}
WARMUP, TOTAL_STEPS, MIN_FRAC = 100, 10000, 0.1
CLIP_NORM = 1.0


@contextlib.contextmanager
def no_tf32():
    """fp32 products in fp32: TF32 off for matmuls and cuDNN, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def rounded(t, dtype):
    """``t`` rounded to ``dtype``, in fp32; an fp8 format at one scale for the
    tensor, its largest magnitude mapped to the format's largest."""
    if dtype == torch.bfloat16:
        return t.to(dtype).float()
    scale = torch.finfo(dtype).max / t.abs().amax().clamp_min(1e-30)
    return (t * scale).to(dtype).float() / scale


class LowMatmul(torch.autograd.Function):
    """``a @ w`` (w 2-D) with the operands rounded to ``fwd`` and the
    incoming gradient to ``bwd``, accumulated in fp32."""

    @staticmethod
    def forward(ctx, a, w, fwd, bwd):
        aq, wq = rounded(a, fwd), rounded(w, fwd)
        ctx.save_for_backward(aq, wq)
        ctx.bwd = bwd
        return aq @ wq

    @staticmethod
    def backward(ctx, grad):
        aq, wq = ctx.saved_tensors
        gq = rounded(grad, ctx.bwd)
        gw = aq.reshape(-1, aq.shape[-1]).T @ gq.reshape(-1, gq.shape[-1])
        return gq @ wq.T, gw, None, None


def mm(a, w, prec: str):
    """``a @ w`` for a product with a weight, at the precision ``prec``."""
    if prec == "fp32":
        return a @ w
    return LowMatmul.apply(a, w, *LOW[prec])


def rmsnorm(x, scale, eps: float):
    """``x · rsqrt(mean(x²) + eps) · (1 + scale)`` over the last dim."""
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * (1.0 + scale)


def embed(table, tokens, d_model: int):
    """The token's row, times √d_model."""
    return table[tokens] * math.sqrt(d_model)


def rope(x, theta: float):
    """Rotary embedding, split-half rotation, positions 0 … S−1.
    x: (B, S, H, hd)."""
    S, hd = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64, device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs.float()
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _block_loss(h, w, labels, prec):
    logits = mm(h, w, prec)
    lse = torch.logsumexp(logits, dim=-1)
    label_logit = torch.gather(logits, -1, labels[..., None])[..., 0]
    return (lse - label_logit).sum(), lse.square().sum()


def lm_loss(hidden, w_head, labels, aux, prec: str):
    """The job's loss from the final hidden states (B, S, D), the head
    (D, V) and next-token labels (B, S)."""
    S = hidden.shape[1]
    nll = z = 0.0
    for s0 in range(0, S, LOSS_BLOCK):
        sl = slice(s0, s0 + LOSS_BLOCK)
        dn, dz = checkpoint(_block_loss, hidden[:, sl], w_head, labels[:, sl], prec,
                            use_reentrant=False)
        nll, z = nll + dn, z + dz
    n = labels.numel()
    return nll / n + Z_LOSS * z / n + AUX_LOSS * aux


def warmup_cosine(step: int, lr: float) -> float:
    """The learning rate at ``step``: linear warm-up to ``lr`` over ``WARMUP``
    steps, then a cosine decay to ``MIN_FRAC · lr`` at ``TOTAL_STEPS``,
    evaluated in fp32."""
    warm, total, lo = WARMUP, TOTAL_STEPS, MIN_FRAC
    s = torch.tensor(float(step))
    if step < warm:
        return float(lr * torch.clamp((s + 1) / max(warm, 1), max=1.0))
    t = torch.clamp((s - warm) / max(total - warm, 1), 0.0, 1.0)
    return float(lr * (lo + (1 - lo) * 0.5 * (1 + torch.cos(math.pi * t))))


@torch.no_grad()
def clip_(grads: dict, max_norm: float) -> torch.Tensor:
    """Scales every gradient in place by min(1, max_norm / global norm)."""
    norm = torch.sqrt(sum(torch.sum(g.square()) for g in grads.values()))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in grads.values():
        g.mul_(scale)
    return norm


@torch.no_grad()
def adamw_(p, g, m, v, count: int, lr: float, store_dtype) -> None:
    """One AdamW step (``ADAMW``) in fp32, in place; weight decay acts on the
    old p, and p is then held in the configuration's parameter dtype."""
    b1, b2, eps, wd = ADAMW["b1"], ADAMW["b2"], ADAMW["eps"], ADAMW["weight_decay"]
    m.mul_(b1).add_(g, alpha=1 - b1)
    v.mul_(b2).add_(g.square(), alpha=1 - b2)
    upd = (m / (1 - b1 ** count)) / (torch.sqrt(v / (1 - b2 ** count)) + eps)
    p.sub_(lr * (upd + wd * p))
    p.copy_(p.to(store_dtype).float())


def train(family, model: dict, job: dict, params: dict, batches, steps: int, prec: str,
          initial, sample, take) -> dict:
    """``steps`` optimizer steps of the job from ``params`` (fp32 leaves by
    path, changed in place), one batch each.  ``initial(path)`` gives a leaf's
    starting value again, ``sample(path)`` the entries read one by one and
    ``take(t, entries)`` reads them.  Returns the readings the check compares:
    each step's loss; each leaf's gradient at the first step after the clip
    (what the optimizer gets), its norm and sampled entries; each leaf's
    norm of change after the last step."""
    if job["optimizer"] != "adamw":
        raise NotImplementedError(f"no reference for the optimizer {job['optimizer']!r}")
    dtypes = {path: spec[1] for path, spec in family.leaves(model).items()}
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    losses, grad_norms, grad_at = [], {}, {}
    with no_tf32():
        for step in range(steps):
            inputs, labels = batches(step)
            for p in params.values():
                p.requires_grad_(True)
            loss = family.loss(params, model, inputs, labels, prec)
            keys = list(params)
            grads = dict(zip(keys, torch.autograd.grad(loss, [params[k] for k in keys]),
                             strict=True))
            losses.append(float(loss.detach()))
            del loss
            clip_(grads, CLIP_NORM)
            if step == 0:
                grad_norms = {k: float(torch.linalg.vector_norm(g)) for k, g in grads.items()}
                grad_at = {k: take(g, sample(k)) for k, g in grads.items()}
            lr = warmup_cosine(step, job["lr"])
            for k in keys:
                params[k].requires_grad_(False)
                adamw_(params[k], grads.pop(k), m[k], v[k], step + 1, lr,
                       getattr(torch, dtypes[k]))
    del m, v
    change = {k: float(torch.linalg.vector_norm(p - initial(k).float()))
              for k, p in params.items()}
    return {"losses": losses, "grad_norms": grad_norms, "update_norms": change,
            "grad_samples": grad_at}
