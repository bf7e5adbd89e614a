"""train_step / eval_step / serve_step factories; the train step with
microbatched gradient accumulation.

``make_train_step`` returns
``(params, opt_state, batch, step) -> (params, opt_state, metrics)``.
Gradients come from ``torch.autograd.grad`` over the leaves of the parameter
tree; the optimizer then updates those leaves **in place**, so the returned
trees hold the tensors that came in.  ``make_serve_step`` returns
``(params, cache, inputs, pos, generator=None) -> (next_tokens, cache)``;
the cache, too, is updated in place.
"""

from __future__ import annotations

import torch

from .. import torch_dtype
from ..convert import tree_leaves, tree_map
from ..optim.optimizers import Optimizer, clip_by_global_norm
from .loss import lm_loss


def _unflatten_like(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def make_train_step(cfg, optimizer: Optimizer, grad_accum: int = 1,
                    clip_norm: float = 1.0, accum_dtype: str = "float32"):
    def grad_fn(params, inputs, labels):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss, metrics = lm_loss(params, cfg, inputs, labels)
        grads = torch.autograd.grad(loss, leaves)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return metrics, _unflatten_like(params, grads)

    def train_step(params, opt_state, batch, step):
        inputs, labels = batch["inputs"], batch["labels"]
        if grad_accum == 1:
            metrics, grads = grad_fn(params, inputs, labels)
        else:
            mb = inputs.shape[0] // grad_accum
            adt = torch_dtype(accum_dtype)
            g_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=adt,
                                                   device=p.device), params)
            loss_sum = torch.zeros((), dtype=torch.float32, device=inputs.device)
            for a in range(grad_accum):
                sl = slice(a * mb, (a + 1) * mb)
                m, g = grad_fn(params, inputs[sl], labels[sl])
                tree_map(lambda acc, b: acc.add_(b.to(adt)), g_acc, g)
                loss_sum = loss_sum + m["loss"]
            grads = tree_map(lambda g: g.float() / grad_accum, g_acc)
            metrics = {"loss": loss_sum / grad_accum}

        grads, gnorm = clip_by_global_norm(grads, clip_norm)
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
    int32 (B,), cache)``, run under ``torch.inference_mode()``.  inputs: (B,1)
    tokens or (B,1,D) embeddings; pos: the cache's fill count, a Python
    ``int``.  Greedy takes the first maximum of the logits (as
    ``jnp.argmax``); otherwise a token is drawn from the categorical
    distribution of ``logits / temperature`` with ``generator``, which the
    caller must pass (no generator reproduces ``jax.random``'s draws)."""
    from ..models.transformer import decode_step

    @torch.inference_mode()
    def serve_step(params, cache, inputs, pos, generator=None):
        logits, cache = decode_step(params, cache, cfg, inputs, pos)
        logits = logits[:, -1]
        if sample == "greedy":
            nxt = logits.argmax(dim=-1)
        else:
            if generator is None:
                raise ValueError("categorical sampling needs a torch.Generator")
            probs = torch.softmax((logits / temperature).float(), dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
        return nxt.to(torch.int32), cache

    return serve_step
