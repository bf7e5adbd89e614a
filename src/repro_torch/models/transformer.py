"""The composable decoder-only model, assembled from a ModelConfig.

Mixers ``attn``, ``local`` (GQA attention), ``mla`` (multi-head latent
attention) and ``mamba`` (Mamba-2 SSD), each followed by an MLP, a
Mixture-of-Experts layer (``spec.moe``, ``models.moe``; its load-balance loss
is summed over the layers as ``aux_loss``) or neither.  With
``cfg.use_flash`` every RMSNorm (``ln1``, ``ln2``, ``final_norm`` and the
mixers' own) is the hand-written kernel (``kernels.ops.rmsnorm``: fp32
product, one cast); without it, ``layers.rmsnorm`` (the reference model's
rounding order).  Decode takes the same norms as the forward, so decode ≡
forward holds within the port wherever the forward drops no MoE entry (a
decode step routes one token a group, and its capacity of at least 8 slots
an expert never drops).

The layer stack follows the reference's parameter layout — the smallest
repeating block pattern (``cfg.scan_period()``) with parameters stacked along
a leading dimension, plus a remainder for patterns that don't divide
``n_layers`` — but walks it with a Python loop instead of a scan.

Activation checkpointing of each scanned period, chosen by ``cfg.remat``
through ``core.remat_policy.resolve_remat`` as in the reference: ``"none"``
(or ``None``) keeps everything, ``"full"`` recomputes the whole period in the
backward, ``"dots"`` / ``"dots_no_batch"`` keep the matrix products' outputs
and ``"save:a,b"`` the values tagged with those site names
(``checkpoint_name``: ``attn_in``, ``qkv``, ``attn_out``, ``mlp_hidden``,
``moe_hidden``, ``ssm_state``, ``block_out``); an unknown name raises.  A
policy only chooses what is kept, so every policy computes the same values.

Decode: ``cache_specs`` / ``init_cache`` lay the caches out like the
parameters (``scan`` stacked, ``rem``); ``decode_step`` runs one token
through every layer, writing each layer's cache in place.
"""

from __future__ import annotations

import operator

import torch

from .. import resolve_device, torch_dtype
from ..core.remat_policy import checkpoint_name, checkpointed, resolve_remat
from .attention import (attn_decode_step, attn_specs, gqa_attention,
                        mla_attention, mla_decode_step, mla_specs)
from .layers import (PSpec, embed_lookup, map_specs, materialize, mlp_apply,
                     mlp_specs, norm, rmsnorm_spec, stack_specs)
from .moe import moe_apply, moe_specs
from .ssm import ssd_apply, ssd_decode_step, ssm_specs


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------


def block_specs(cfg, spec) -> dict:
    out = {"ln1": rmsnorm_spec(cfg.d_model)}
    if spec.mixer in ("attn", "local"):
        out["attn"] = attn_specs(cfg)
    elif spec.mixer == "mla":
        out["attn"] = mla_specs(cfg)
    elif spec.mixer == "mamba":
        out["mixer"] = ssm_specs(cfg)
    else:
        raise ValueError(f"unknown mixer {spec.mixer!r}")
    if spec.moe:
        out["ln2"] = rmsnorm_spec(cfg.d_model)
        out["moe"] = moe_specs(cfg)
    elif cfg.mlp != "none":
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


def _apply_layer(prm, x, cfg, spec, positions):
    """One block: (x, the MoE layer's aux loss, or a zero)."""
    h = checkpoint_name(norm(x, prm["ln1"]["scale"], cfg), "attn_in")
    if spec.mixer == "attn":
        mix = gqa_attention(prm["attn"], h, cfg, positions, window=None)
    elif spec.mixer == "local":
        mix = gqa_attention(prm["attn"], h, cfg, positions, window=cfg.window)
    elif spec.mixer == "mla":
        mix = mla_attention(prm["attn"], h, cfg, positions)
    else:
        mix = ssd_apply(prm["mixer"], h, cfg)
    x = x + mix
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if spec.moe:
        h2 = norm(x, prm["ln2"]["scale"], cfg)
        y, aux = moe_apply(prm["moe"], h2, cfg)
        x = x + y
    elif cfg.mlp != "none":
        h2 = norm(x, prm["ln2"]["scale"], cfg)
        x = x + mlp_apply(prm["mlp"], h2, cfg)
    return checkpoint_name(x, "block_out"), aux


def _unstack(tree, n: int) -> list:
    """A tree of (n, ...) leaves → n trees of (...) leaves.  ``unbind`` gives
    one backward node per leaf that stacks the n gradients at once."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return list(tree.unbind(0))


def _embed(params, cfg, inputs):
    if cfg.input_mode == "tokens":
        x = embed_lookup(params["embed"]["table"], inputs)
        # the scale is rounded to the activation dtype first
        return x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
    return inputs.to(torch_dtype(cfg.compute_dtype))


def forward_hidden(params, cfg, inputs, positions=None):
    """inputs: tokens (B,S) int32, or embeddings (B,S,D) for stub-frontend
    archs.  Returns (hidden (B,S,D), aux_loss).  ``aux_loss`` is the MoE
    load-balancing term summed over the layers (each period's sum, then the
    remainder's layers, in the reference's order): zero without MoE."""
    specs = cfg.layer_specs()
    period = cfg.scan_period()
    n_full = cfg.n_layers // period

    x = _embed(params, cfg, inputs)
    B, S = x.shape[0], x.shape[1]
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)

    def period_body(x, per_params):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(period):
            x, a = _apply_layer(per_params[str(i)], x, cfg, specs[i], positions)
            aux = aux + a
        return x, aux

    use_remat, policy = resolve_remat(cfg.remat)
    if use_remat and torch.is_grad_enabled():
        period_body = checkpointed(period_body, policy)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if n_full > 0:
        for per_params in _unstack(params["scan"], n_full):
            x, a = period_body(x, per_params)
            aux = aux + a
    for j, prm in sorted(params.get("rem", {}).items(), key=lambda kv: int(kv[0])):
        x, a = _apply_layer(prm, x, cfg, specs[n_full * period + int(j)], positions)
        aux = aux + a

    x = norm(x, params["final_norm"]["scale"], cfg)
    return x, aux


def unembed_weight(params, cfg):
    if cfg.tie_embeddings:
        return params["embed"]["table"].T
    return params["head"]["w"]


def logits_fn(params, cfg, inputs):
    h, aux = forward_hidden(params, cfg, inputs)
    return h @ unembed_weight(params, cfg), aux


# ---------------------------------------------------------------------------
# KV / SSM caches + decode
# ---------------------------------------------------------------------------


def _cache_entry_specs(cfg, spec, batch: int, max_seq: int) -> dict:
    hd, Kv = cfg.head_dim_, cfg.n_kv_heads
    if spec.mixer in ("attn", "local"):
        # a local layer keeps a ring of min(window, max_seq) slots
        T = max_seq if spec.mixer == "attn" else min(cfg.window, max_seq)
        shp, axes = (batch, T, Kv, hd), ("batch", "kv_seq", "kv_heads", None)
        return {"k": PSpec(shp, axes, cfg.compute_dtype, "zeros"),
                "v": PSpec(shp, axes, cfg.compute_dtype, "zeros")}
    if spec.mixer == "mla":
        m = cfg.mla
        axes = ("batch", "kv_seq", None)
        return {"ckv": PSpec((batch, max_seq, m.kv_lora_rank), axes,
                             cfg.compute_dtype, "zeros"),
                "kr": PSpec((batch, max_seq, m.qk_rope_dim), axes,
                            cfg.compute_dtype, "zeros")}
    if spec.mixer == "mamba":
        s = cfg.ssm
        ch = cfg.d_inner + 2 * s.n_groups * s.d_state
        return {"conv": PSpec((batch, s.conv_width - 1, ch),
                              ("batch", None, None), "float32", "zeros"),
                "state": PSpec((batch, cfg.ssm_heads, s.headdim, s.d_state),
                               ("batch", "ffn", None, None), "float32", "zeros")}
    raise ValueError(f"unknown mixer {spec.mixer!r}")


def cache_specs(cfg, batch: int, max_seq: int) -> dict:
    specs = cfg.layer_specs()
    period = cfg.scan_period()
    n_full = cfg.n_layers // period
    rem = cfg.n_layers - n_full * period
    return {
        "scan": {str(i): stack_specs(
            _cache_entry_specs(cfg, specs[i], batch, max_seq), n_full)
            for i in range(period)},
        "rem": {str(j): _cache_entry_specs(cfg, specs[n_full * period + j],
                                           batch, max_seq)
                for j in range(rem)},
    }


def init_cache(cfg, batch: int, max_seq: int, device="cuda"):
    """Zeroed caches on ``device`` for ``batch`` sequences of up to
    ``max_seq`` tokens."""
    dev = resolve_device(device)
    return map_specs(lambda s: torch.zeros(s.shape, dtype=torch_dtype(s.dtype),
                                           device=dev),
                     cache_specs(cfg, batch, max_seq))


def _decode_layer(prm, cache, x, pos, cfg, spec):
    h = norm(x, prm["ln1"]["scale"], cfg)
    if spec.mixer in ("attn", "local"):
        window = cfg.window if spec.mixer == "local" else None
        mix, _, _ = attn_decode_step(prm["attn"], h, cache["k"], cache["v"],
                                     pos, cfg, window=window)
    elif spec.mixer == "mla":
        mix, _, _ = mla_decode_step(prm["attn"], h, cache["ckv"], cache["kr"],
                                    pos, cfg)
    else:
        mix, _, _ = ssd_decode_step(prm["mixer"], h, cache["conv"],
                                    cache["state"], cfg)
    x = x + mix
    if spec.moe:
        # one token a group: capacity max(8, ·) ≥ top_k, nothing is dropped
        h2 = norm(x, prm["ln2"]["scale"], cfg)
        y, _ = moe_apply(prm["moe"], h2, cfg)
        x = x + y
    elif cfg.mlp != "none":
        h2 = norm(x, prm["ln2"]["scale"], cfg)
        x = x + mlp_apply(prm["mlp"], h2, cfg)
    return x


def _select(tree, i: int):
    """Entry ``i`` of every stacked leaf: views, so writes reach the stack."""
    if isinstance(tree, dict):
        return {k: _select(v, i) for k, v in tree.items()}
    return tree[i]


def decode_step(params, cache, cfg, inputs, pos: int):
    """One-token decode.  inputs: (B,1) tokens or (B,1,D) embeddings; pos:
    the cache's fill count, a Python ``int``.  Writes every layer's cache in
    place and returns (logits (B,1,V), cache) — the same cache tree."""
    pos = operator.index(pos)
    specs = cfg.layer_specs()
    period = cfg.scan_period()
    n_full = cfg.n_layers // period

    x = _embed(params, cfg, inputs)
    for n in range(n_full):
        per_params, per_cache = _select(params["scan"], n), _select(cache["scan"], n)
        for i in range(period):
            x = _decode_layer(per_params[str(i)], per_cache[str(i)], x, pos, cfg,
                              specs[i])
    for j, prm in sorted(params.get("rem", {}).items(), key=lambda kv: int(kv[0])):
        x = _decode_layer(prm, cache["rem"][j], x, pos, cfg,
                          specs[n_full * period + int(j)])

    x = norm(x, params["final_norm"]["scale"], cfg)
    return x @ unembed_weight(params, cfg), cache
