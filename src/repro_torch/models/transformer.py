"""The composable decoder-only model, assembled from a ModelConfig.

Mixers ``attn``, ``local`` (GQA attention) and ``mamba`` (Mamba-2 SSD), with
an MLP or none; ``mla`` and MoE layers wait for their slices.  With
``cfg.use_flash`` every RMSNorm (``ln1``, ``ln2``, ``final_norm``) is the
hand-written kernel (``kernels.ops.rmsnorm``: fp32 product, one cast);
without it, ``layers.rmsnorm`` (the reference model's rounding order).

The layer stack follows the reference's parameter layout — the smallest
repeating block pattern (``cfg.scan_period()``) with parameters stacked along
a leading dimension, plus a remainder for patterns that don't divide
``n_layers`` — but walks it with a Python loop instead of a scan.

Activation checkpointing: ``cfg.remat == "none"`` keeps everything; any other
policy recomputes the whole period body in the backward pass
(``torch.utils.checkpoint``).  That is numerically identical to the
reference's selective policies, which only choose what to keep.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .. import resolve_device, torch_dtype
from ..kernels import ops
from .attention import attn_specs, gqa_attention
from .layers import (PSpec, embed_lookup, materialize, mlp_apply, mlp_specs,
                     rmsnorm, rmsnorm_spec, stack_specs)
from .ssm import ssd_apply, ssm_specs

_LATER = {"mla": "MLA"}


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------


def block_specs(cfg, spec) -> dict:
    out = {"ln1": rmsnorm_spec(cfg.d_model)}
    if spec.mixer in ("attn", "local"):
        out["attn"] = attn_specs(cfg)
    elif spec.mixer == "mamba":
        out["mixer"] = ssm_specs(cfg)
    elif spec.mixer in _LATER:
        raise NotImplementedError(
            f"mixer {spec.mixer!r} is not ported yet: it waits for the "
            f"{_LATER[spec.mixer]} slice of the port")
    else:
        raise ValueError(f"unknown mixer {spec.mixer!r}")
    if spec.moe:
        raise NotImplementedError(
            "MoE layers are not ported yet: they wait for the MoE slice of the port")
    if cfg.mlp != "none":
        out["ln2"] = rmsnorm_spec(cfg.d_model)
        out["mlp"] = mlp_specs(cfg)
    return out


def param_specs(cfg) -> dict:
    specs = cfg.layer_specs()
    period = cfg.scan_period()
    n_full = cfg.n_layers // period
    rem = cfg.n_layers - n_full * period

    tree: dict = {}
    if cfg.input_mode == "tokens":
        tree["embed"] = {"table": PSpec((cfg.vocab, cfg.d_model),
                                        ("vocab", "embed"), cfg.param_dtype,
                                        "small")}
    tree["scan"] = {str(i): stack_specs(block_specs(cfg, specs[i]), n_full)
                    for i in range(period)}
    tree["rem"] = {str(j): block_specs(cfg, specs[n_full * period + j])
                   for j in range(rem)}
    tree["final_norm"] = rmsnorm_spec(cfg.d_model)
    if not cfg.tie_embeddings:
        tree["head"] = {"w": PSpec((cfg.d_model, cfg.vocab),
                                   ("embed", "vocab"), cfg.param_dtype,
                                   "small")}
    return tree


def init_params(cfg, seed: int, device="cuda"):
    """Random parameters on ``device``, drawn from a generator seeded with
    ``seed`` that lives on that device."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    return materialize(param_specs(cfg), gen, dev)


# ---------------------------------------------------------------------------
# forward (training / prefill)
# ---------------------------------------------------------------------------


def _norm(x, scale, cfg):
    if cfg.use_flash:
        return ops.rmsnorm(x, scale, cfg.norm_eps)
    return rmsnorm(x, scale, cfg.norm_eps)


def _apply_layer(prm, x, cfg, spec, positions):
    h = _norm(x, prm["ln1"]["scale"], cfg)
    if spec.mixer == "attn":
        mix = gqa_attention(prm["attn"], h, cfg, positions, window=None)
    elif spec.mixer == "local":
        mix = gqa_attention(prm["attn"], h, cfg, positions, window=cfg.window)
    elif spec.mixer == "mamba":
        mix = ssd_apply(prm["mixer"], h, cfg)
    else:
        raise NotImplementedError(f"mixer {spec.mixer!r} waits for a later slice")
    x = x + mix
    if cfg.mlp != "none":
        h2 = _norm(x, prm["ln2"]["scale"], cfg)
        x = x + mlp_apply(prm["mlp"], h2, cfg)
    return x


def _unstack(tree, n: int) -> list:
    """A tree of (n, ...) leaves → n trees of (...) leaves.  ``unbind`` gives
    one backward node per leaf that stacks the n gradients at once."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return list(tree.unbind(0))


def forward_hidden(params, cfg, inputs, positions=None):
    """inputs: tokens (B,S) int32, or embeddings (B,S,D) for stub-frontend
    archs.  Returns (hidden (B,S,D), aux_loss).  ``aux_loss`` is the MoE
    load-balancing term: zero until the MoE slice."""
    specs = cfg.layer_specs()
    period = cfg.scan_period()
    n_full = cfg.n_layers // period

    if cfg.input_mode == "tokens":
        x = embed_lookup(params["embed"]["table"], inputs)
        # the scale is rounded to the activation dtype first
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
    else:
        x = inputs.to(torch_dtype(cfg.compute_dtype))
    B, S = x.shape[0], x.shape[1]
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)

    def period_body(x, per_params):
        for i in range(period):
            x = _apply_layer(per_params[str(i)], x, cfg, specs[i], positions)
        return x

    use_remat = cfg.remat != "none" and torch.is_grad_enabled()
    if n_full > 0:
        for per_params in _unstack(params["scan"], n_full):
            if use_remat:
                x = checkpoint(period_body, x, per_params, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = period_body(x, per_params)
    for j, prm in sorted(params.get("rem", {}).items(), key=lambda kv: int(kv[0])):
        x = _apply_layer(prm, x, cfg, specs[n_full * period + int(j)], positions)

    x = _norm(x, params["final_norm"]["scale"], cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux


def unembed_weight(params, cfg):
    if cfg.tie_embeddings:
        return params["embed"]["table"].T
    return params["head"]["w"]


def logits_fn(params, cfg, inputs):
    h, aux = forward_hidden(params, cfg, inputs)
    return h @ unembed_weight(params, cfg), aux
