"""train_step / eval_step / serve_step factories; the train step with
microbatched gradient accumulation.

``make_train_step`` returns
``(params, opt_state, batch, step) -> (params, opt_state, metrics)``; the
metrics hold the loss, the MoE aux loss (a microbatches' mean under
accumulation) and the grad norm.
Gradients come from ``torch.autograd.grad`` over the leaves of the parameter
tree; the optimizer then updates those leaves **in place**, so the returned
trees hold the tensors that came in.

On a mesh (DTensor parameters and batch, under ``sharding.use_mesh``) the
step runs under ``implicit_replication`` (the tensors the model makes itself,
masks and positions, are taken as replicated), the loss is made whole before
the backward, and each gradient is redistributed to its parameter's placement
(the reduce-scatter: DTensor's autograd may return a ``Partial`` one) before
``clip_by_global_norm`` and the update.  ``make_serve_step`` returns
``(params, cache, inputs, pos, generator=None) -> (next_tokens, cache)``;
the cache, too, is updated in place.
"""

from __future__ import annotations

import contextlib

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from .. import torch_dtype
from ..convert import tree_leaves, tree_map
from ..core import spans
from ..distributed.sharding import whole
from ..optim.optimizers import Optimizer, clip_by_global_norm
from .loss import lm_loss


def _unflatten_like(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _is_mesh_tree(tree) -> bool:
    leaves = tree_leaves(tree)
    return bool(leaves) and isinstance(leaves[0], DTensor)


def on_mesh(tree):
    """``implicit_replication`` when the tree's leaves are DTensors."""
    if _is_mesh_tree(tree):
        return implicit_replication()
    return contextlib.nullcontext()


def no_autograd(tree):
    """``torch.no_grad()`` for DTensor leaves, else ``torch.inference_mode()``."""
    if _is_mesh_tree(tree):
        return torch.no_grad()
    return torch.inference_mode()


def make_train_step(cfg, optimizer: Optimizer, grad_accum: int = 1,
                    clip_norm: float = 1.0, accum_dtype: str = "float32"):
    def grad_fn(params, inputs, labels):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        with on_mesh(params):
            with spans.span("step.forward"):
                loss, metrics = lm_loss(params, cfg, inputs, labels)
            with spans.span("step.backward"):
                grads = torch.autograd.grad(whole(loss), leaves)
            grads = [g.redistribute(p.device_mesh, p.placements)
                     if isinstance(g, DTensor) else g for p, g in zip(leaves, grads, strict=True)]
            metrics = {k: whole(v).detach() for k, v in metrics.items()}
        return metrics, _unflatten_like(params, grads)

    def train_step(params, opt_state, batch, step):
        with spans.step(batch["inputs"].device):
            return _train_step(params, opt_state, batch, step)

    def _train_step(params, opt_state, batch, step):
        inputs, labels = batch["inputs"], batch["labels"]
        if grad_accum == 1:
            metrics, grads = grad_fn(params, inputs, labels)
        else:
            mb = inputs.shape[0] // grad_accum
            adt = torch_dtype(accum_dtype)
            g_acc = tree_map(lambda p: torch.zeros_like(p, dtype=adt), params)
            loss_sum = torch.zeros((), dtype=torch.float32, device=inputs.device)
            aux_sum = torch.zeros((), dtype=torch.float32, device=inputs.device)
            for a in range(grad_accum):
                sl = slice(a * mb, (a + 1) * mb)
                m, g = grad_fn(params, inputs[sl], labels[sl])
                tree_map(lambda acc, b: acc.add_(b.to(adt)), g_acc, g)
                loss_sum = loss_sum + m["loss"]
                aux_sum = aux_sum + m["aux_loss"]
            grads = tree_map(lambda g: g.float() / grad_accum, g_acc)
            metrics = {"loss": loss_sum / grad_accum, "aux_loss": aux_sum / grad_accum}

        with spans.span("step.optimizer"):
            grads, gnorm = clip_by_global_norm(grads, clip_norm)
            with on_mesh(params):
                params, opt_state = optimizer.update(grads, opt_state, params, step)
        metrics = dict(metrics)
        metrics["grad_norm"] = gnorm
        metrics["lr_step"] = torch.tensor(int(step), dtype=torch.int32)
        return params, opt_state, metrics

    return train_step


def make_eval_step(cfg):
    @torch.no_grad()
    def eval_step(params, batch):
        _, metrics = lm_loss(params, cfg, batch["inputs"], batch["labels"])
        return metrics
    return eval_step


def make_serve_step(cfg, sample: str = "greedy", temperature: float = 1.0):
    """Returns ``(params, cache, inputs, pos, generator=None) -> (next_tokens
    int32 (B,), cache)``, run under ``torch.inference_mode()``.  On a mesh
    (DTensor parameters and cache, under ``use_mesh``) the logits are made
    whole before the choice, which every rank makes alike, and the step runs
    under ``torch.no_grad()`` (a DTensor view of the stacked cache cannot be
    made under inference mode).  inputs: (B,1)
    tokens or (B,1,D) embeddings; pos: the cache's fill count, a Python
    ``int``.  Greedy takes the first maximum of the logits (as
    ``jnp.argmax``); otherwise a token is drawn from the categorical
    distribution of ``logits / temperature`` with ``generator``, which the
    caller must pass (no generator reproduces ``jax.random``'s draws)."""
    from ..models.transformer import decode_step

    def serve_step(params, cache, inputs, pos, generator=None):
        with no_autograd(params), on_mesh(params):
            logits, cache = decode_step(params, cache, cfg, inputs, pos)
            logits = whole(logits[:, -1])
        if sample == "greedy":
            nxt = logits.argmax(dim=-1)
        else:
            if generator is None:
                raise ValueError("categorical sampling needs a torch.Generator")
            probs = torch.softmax((logits / temperature).float(), dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
        return nxt.to(torch.int32), cache

    return serve_step
