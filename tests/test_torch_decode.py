"""The port's decode path (``init_cache``, ``decode_step``, ``make_serve_step``)
against the JAX package's, from shared weights, on the CPU.

Weights are made by the reference (``materialize`` of its specs) and handed
over through ``from_reference``; the norm scales and the SSM's zero-initialised
vectors get random values first, so that the kernel route's norm (fp32
product, one cast) and the plain one (cast, then the product: trap T1)
round differently in bf16 instead of multiplying by exactly 1.  Inputs come
from numpy with a seed.  The reference's ``decode_step`` is jitted once per
config (``pos`` traced), so every step reuses one compilation.

gemma3 runs with ``window`` 8 on both sides, so its ``local`` layers' ring of
8 slots wraps twice in 24 steps.

Tolerances: 2e-5 for fp32 logits (two fp32 summation orders through at most
six layers); 5e-2 for bf16 logits, the bf16 logits tolerance of
``test_torch_model.py``: every matmul output is rounded to 8 bits of mantissa,
and on the kernel route every norm rounds once after its fp32 product where
the reference rounds before it (T1); the largest difference seen was 2.5e-2
on logits of magnitude 0.7.  Port decode ≡ port forward in fp32: 2e-5.
jamba's caches in fp32: 2e-5 of the leaf's largest entry where that is above
1 (its SSM states reach 12 after 24 steps through 8 layers; the largest
difference seen was 5.2e-5 there, logits within 3e-6).

MoE in bf16: a rounding difference upstream of a router (the kernel route's
norm, the port's fp32 sum of a token's expert outputs) flips the choice
between two nearly equal gates, and a flipped choice changes that token's
output by a whole expert's share.  The smoke routers' init (std 0.02 over 64
inputs) gives 4 gates of 0.25 ± 0.04, so flips are common: 1–4 % of the bf16
logits differ by up to 0.24.  Neither side is at fault, so the bf16 case
draws the MoE routers at std 1 (gates well apart, no flip) and holds the rest
of the arithmetic at 5e-2; the fp32 cases keep the init.  jamba is held in
fp32 only: its smallest config is one period of 8 layers, and at that depth
bf16 rounding drifts past 5e-2 whatever the MoE does (0.055 / 0.069 on the
plain / kernel route with its MoE layers removed, as mamba2 at 8 layers reads
0.032 / 0.056).
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro_torch.configs as configs
from repro.models import layers as ref_layers
from repro.models import transformer as ref_transformer
from repro.training.train_step import make_serve_step as ref_make_serve_step
from repro_torch.convert import from_reference, to_reference, tree_flatten_with_path
from repro_torch.models import attention, transformer
from repro_torch.training.train_step import make_serve_step

FP32 = dict(param_dtype="float32", compute_dtype="float32")
ROUTES = {"plain": dict(use_flash=False), "kernel": dict(use_flash=True)}
#: every arch: mixers attn, local, mamba, mla, MoE layers (jamba: mamba and
#: attn with MoE every second layer); both input modes
ARCHS = ["gemma3-1b", "mamba2-1.3b", "minicpm3-4b", "phi3-medium-14b", "nemotron-4-340b",
         "olmoe-1b-7b", "moonshot-v1-16b-a3b", "jamba-1.5-large-398b", "internvl2-26b",
         "musicgen-medium"]
TOKEN_ARCHS = ARCHS[:8]
BF16_ARCHS = [a for a in ARCHS if a != "jamba-1.5-large-398b"]
STEPS = 24


def small(arch, **kw):
    """(port config, reference config) with the same overrides; gemma3 with
    a window of 8."""
    if arch == "gemma3-1b":
        kw.setdefault("window", 8)
    return (replace(configs.smoke_config(arch), **kw),
            replace(ref_configs.smoke_config(arch), **kw))


def shared_params(ref_cfg, fp32=True, seed=0, router_scale=1.0):
    """(jax tree, torch tree) holding the same numbers; fp32 leaves that
    the init leaves at zero (norm scales, ``A_log``, ``dt_bias``) get values
    of scale 0.2; MoE routers are multiplied by ``router_scale``."""
    jp = ref_layers.materialize(ref_transformer.param_specs(ref_cfg),
                                jax.random.PRNGKey(seed))
    if router_scale != 1.0:
        jp = jax.tree_util.tree_map_with_path(
            lambda path, a: a * router_scale if path[-1].key == "router" else a, jp)
    if fp32:
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    rng = np.random.default_rng(seed + 5)
    leaves, treedef = jax.tree.flatten(jp)
    leaves = [a + jnp.asarray(0.2 * rng.standard_normal(a.shape), a.dtype)
              if a.dtype == jnp.float32 and a.ndim <= 2 and not np.any(np.asarray(a)) else a
              for a in leaves]
    jp = jax.tree.unflatten(treedef, leaves)
    return jp, from_reference(jax.tree.map(np.asarray, jp), "cpu")


def make_inputs(cfg, B, S, seed=0):
    """Tokens (B,S) int32, or embeddings (B,S,D) fp32 for the stub-frontend
    archs."""
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "tokens":
        return rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    return rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def ref_stepper(ref_cfg):
    return jax.jit(lambda p, c, x, pos: ref_transformer.decode_step(p, c, ref_cfg, x, pos))


def decode_both(cfg, ref_cfg, jp, tp, x, max_seq, start=0, caches=None):
    """Decode x[:, start:] token by token on both sides from their caches
    (fresh ones unless given); returns (reference logits, port logits, the
    two caches), logits (B, steps, V)."""
    B, S = x.shape[:2]
    step = ref_stepper(ref_cfg)
    if caches is None:
        caches = (ref_transformer.init_cache(ref_cfg, B, max_seq),
                  transformer.init_cache(cfg, B, max_seq, "cpu"))
    rc, tc = caches
    want, got = [], []
    for t in range(start, S):
        lg, rc = step(jp, rc, jnp.asarray(x[:, t:t + 1]), jnp.int32(t))
        want.append(f32(lg))
        lg, tc = transformer.decode_step(tp, tc, cfg, torch.from_numpy(x[:, t:t + 1]), t)
        got.append(f32(lg))
    return np.concatenate(want, 1), np.concatenate(got, 1), (rc, tc)


# -- caches -------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("max_seq", [16, 5])
def test_cache_tree_matches_reference(arch, max_seq):
    """Keys, shapes and dtypes of ``init_cache`` equal the reference's; a
    ``local`` layer's ring holds min(window, max_seq) slots (window 8)."""
    cfg, ref_cfg = small(arch)
    mine = tree_flatten_with_path(transformer.init_cache(cfg, 3, max_seq, "cpu"))
    ref = tree_flatten_with_path(jax.tree.map(
        np.asarray, ref_transformer.init_cache(ref_cfg, 3, max_seq)))
    assert list(mine) == list(ref)
    for k in mine:
        assert tuple(mine[k].shape) == ref[k].shape, k
        assert str(mine[k].dtype)[6:] == str(ref[k].dtype), k
        assert not mine[k].any(), k
    if arch == "gemma3-1b":
        assert mine["scan/0/k"].shape[2] == min(8, max_seq)
        assert mine["scan/5/k"].shape[2] == max_seq


# -- decode_step against the reference -----------------------------------------------


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference_fp32(arch, route):
    cfg, ref_cfg = small(arch, **FP32, **ROUTES[route])
    jp, tp = shared_params(ref_cfg)
    x = make_inputs(cfg, 2, STEPS)
    want, got, (rc, tc) = decode_both(cfg, ref_cfg, jp, tp, x, STEPS)
    assert got.shape == (2, STEPS, cfg.vocab)
    np.testing.assert_allclose(got, want, atol=2e-5)
    # the caches the steps wrote, too
    ref = tree_flatten_with_path(jax.tree.map(np.asarray, rc))
    for k, t in tree_flatten_with_path(to_reference(tc)).items():
        scale = max(1.0, float(np.abs(ref[k]).max())) if arch == "jamba-1.5-large-398b" else 1.0
        np.testing.assert_allclose(t, ref[k], atol=2e-5 * scale, err_msg=k)


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("arch", BF16_ARCHS)
def test_decode_step_matches_reference_bf16(arch, route):
    """The configured dtypes: bf16 weights, activations and KV caches (fp32
    SSM caches).  5e-2, MoE routers at std 1 (see the module docstring)."""
    cfg, ref_cfg = small(arch, **ROUTES[route])
    jp, tp = shared_params(ref_cfg, fp32=False, router_scale=50.0)
    x = make_inputs(cfg, 2, STEPS)
    want, got, _ = decode_both(cfg, ref_cfg, jp, tp, x, STEPS)
    np.testing.assert_allclose(got, want, atol=5e-2)


@pytest.mark.parametrize("arch", ["gemma3-1b", "mamba2-1.3b", "minicpm3-4b"])
def test_cache_carried_across_from_the_reference(arch):
    """The reference decodes 12 tokens; its cache crosses to the port
    through ``from_reference`` mid-sequence and both sides continue for 12
    more (the gemma3 ring wraps on the port's side)."""
    cfg, ref_cfg = small(arch, **FP32)
    jp, tp = shared_params(ref_cfg)
    x = make_inputs(cfg, 2, STEPS, seed=3)
    step = ref_stepper(ref_cfg)
    rc = ref_transformer.init_cache(ref_cfg, 2, STEPS)
    for t in range(12):
        _, rc = step(jp, rc, jnp.asarray(x[:, t:t + 1]), jnp.int32(t))
    tc = from_reference(jax.tree.map(np.asarray, rc), "cpu")
    want, got, _ = decode_both(cfg, ref_cfg, jp, tp, x, STEPS, start=12, caches=(rc, tc))
    np.testing.assert_allclose(got, want, atol=2e-5)


# -- make_serve_step ------------------------------------------------------------------


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("arch", TOKEN_ARCHS)
def test_greedy_tokens_equal_reference_fp32(arch, route):
    """A 4-token prompt, then 20 greedy tokens fed back on each side: the
    same tokens, step for step."""
    cfg, ref_cfg = small(arch, **FP32, **ROUTES[route])
    jp, tp = shared_params(ref_cfg)
    prompt = make_inputs(cfg, 3, 4, seed=1)
    ref_serve = jax.jit(ref_make_serve_step(ref_cfg))
    serve = make_serve_step(cfg)
    rc = ref_transformer.init_cache(ref_cfg, 3, STEPS)
    tc = transformer.init_cache(cfg, 3, STEPS, "cpu")
    rin, tin = jnp.asarray(prompt[:, :1]), torch.from_numpy(prompt[:, :1])
    for t in range(STEPS):
        rn, rc = ref_serve(jp, rc, rin, jnp.int32(t))
        tn, tc = serve(tp, tc, tin, t)
        assert tn.dtype == torch.int32 and tuple(tn.shape) == (3,)
        if t + 1 < prompt.shape[1]:
            rin, tin = jnp.asarray(prompt[:, t + 1:t + 2]), torch.from_numpy(prompt[:, t + 1:t + 2])
        else:
            np.testing.assert_array_equal(tn.numpy(), np.asarray(rn), err_msg=f"step {t}")
            rin, tin = rn[:, None], tn[:, None]


def test_greedy_takes_the_first_maximum(monkeypatch):
    """Ties go to the lowest index, as with ``jnp.argmax`` (bf16 logits over a
    large vocabulary tie)."""
    logits = torch.tensor([[[0.0, 3.0, 1.0, 3.0]], [[2.0, 2.0, 2.0, 2.0]]], dtype=torch.bfloat16)
    monkeypatch.setattr(transformer, "decode_step", lambda p, c, cfg, x, pos: (logits, c))
    serve = make_serve_step(configs.smoke_config("phi3-medium-14b"))
    assert serve({}, {}, None, 0)[0].tolist() == [1, 0]
    assert np.asarray(jnp.argmax(jnp.asarray(logits.float().numpy()[:, -1]), axis=-1)
                      ).tolist() == [1, 0]


def test_categorical_draws_follow_the_distribution():
    """``sample="categorical"`` draws from softmax(logits / temperature): 4096
    rows with the same input, each token's share within five standard
    deviations of its probability; the same generator seed gives the same
    draws, and no generator raises."""
    cfg, ref_cfg = small("phi3-medium-14b", **FP32)
    jp, tp = shared_params(ref_cfg)
    B, temp = 4096, 0.05
    x = torch.full((B, 1), 7, dtype=torch.int32)
    logits, _ = ref_transformer.decode_step(jp, ref_transformer.init_cache(ref_cfg, 1, 4),
                                            ref_cfg, jnp.full((1, 1), 7, jnp.int32),
                                            jnp.int32(0))
    p = np.asarray(jax.nn.softmax(logits[0, -1] / temp), np.float64)
    assert p.max() < 0.9 and (p > 0.01).sum() >= 3      # a distribution worth testing
    serve = make_serve_step(cfg, sample="categorical", temperature=temp)

    def draw(seed):
        cache = transformer.init_cache(cfg, B, 4, "cpu")
        return serve(tp, cache, x, 0, torch.Generator().manual_seed(seed))[0]

    toks = draw(0)
    share = np.bincount(toks.numpy(), minlength=cfg.vocab) / B
    sd = np.sqrt(p * (1 - p) / B)
    assert np.all(np.abs(share - p) <= 5 * sd + 1.0 / B), np.abs(share - p).max()
    assert torch.equal(toks, draw(0)) and not torch.equal(toks, draw(1))
    with pytest.raises(ValueError, match="Generator"):
        serve(tp, transformer.init_cache(cfg, 1, 4, "cpu"), x[:1], 0)


# -- decode against the port's own forward ---------------------------------------------


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward_fp32(arch, route):
    """Decode over 24 positions ≡ the teacher-forced forward's logits at
    those positions, within the port (fp32, 2e-5).  A MoE forward runs with
    capacity_factor = E/K (C = S), so that it drops nothing: decode routes a
    token a group and never drops (``test_torch_moe.py`` shows the two
    differ where the forward drops)."""
    cfg, ref_cfg = small(arch, **FP32, **ROUTES[route])
    _, tp = shared_params(ref_cfg)
    x = torch.from_numpy(make_inputs(cfg, 2, STEPS, seed=2))
    cache = transformer.init_cache(cfg, 2, STEPS, "cpu")
    got = []
    for t in range(STEPS):
        lg, cache = transformer.decode_step(tp, cache, cfg, x[:, t:t + 1], t)
        got.append(f32(lg))
    if cfg.moe:
        cfg = replace(cfg, moe=replace(cfg.moe, capacity_factor=cfg.moe.n_experts
                                       / cfg.moe.top_k))
    want, _ = transformer.logits_fn(tp, cfg, x)
    np.testing.assert_allclose(np.concatenate(got, 1), f32(want), atol=2e-5)


# -- out of range ----------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["phi3-medium-14b", "minicpm3-4b", "gemma3-1b"])
def test_a_write_past_the_cache_raises(arch):
    """``attn`` and ``mla`` layers refuse pos >= max_seq (the reference's
    ``dynamic_update_slice`` clamps it onto the last slot); gemma3's global
    layer refuses too, though its ``local`` layers would wrap."""
    cfg, ref_cfg = small(arch, **FP32)
    _, tp = shared_params(ref_cfg)
    cache = transformer.init_cache(cfg, 1, 4, "cpu")
    x = torch.zeros((1, 1), dtype=torch.int32)
    for t in range(4):
        transformer.decode_step(tp, cache, cfg, x, t)
    with pytest.raises(ValueError, match="past the cache"):
        transformer.decode_step(tp, cache, cfg, x, 4)
    with pytest.raises(ValueError, match="negative"):
        transformer.decode_step(tp, cache, cfg, x, -1)


def test_reference_clamps_a_write_past_the_cache():
    """What the port refuses: the reference writes position 7 of a
    4-slot cache into slot 3."""
    cache = jnp.zeros((1, 4, 1), jnp.float32)
    out = jax.lax.dynamic_update_slice(cache, jnp.ones((1, 1, 1)), (0, 7, 0))
    assert np.asarray(out)[0, :, 0].tolist() == [0.0, 0.0, 0.0, 1.0]


def test_local_ring_and_ssm_state_keep_going_past_max_seq():
    """A ``local`` layer writes slot pos % T and a mamba layer has no
    position: both decode past max_seq."""
    cfg, ref_cfg = small("mamba2-1.3b", **FP32)
    _, tp = shared_params(ref_cfg)
    cache = transformer.init_cache(cfg, 1, 2, "cpu")
    for t in range(5):
        lg, cache = transformer.decode_step(tp, cache, cfg,
                                            torch.zeros((1, 1), dtype=torch.int32), t)
    assert torch.isfinite(lg).all()
    cfg, ref_cfg = small("gemma3-1b", **FP32)
    _, tp = shared_params(ref_cfg)
    layer = {k: v[0] for k, v in tp["scan"]["0"]["attn"].items()}
    k = torch.zeros((1, 8, cfg.n_kv_heads, cfg.head_dim_))
    v = torch.zeros_like(k)
    for t in range(11):
        x = torch.randn(1, 1, cfg.d_model)
        _, k2, v2 = attention.attn_decode_step(layer, x, k, v, t, cfg, window=8)
        assert k2 is k and v2 is v
        assert k[0, t % 8].abs().sum() > 0
