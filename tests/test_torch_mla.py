"""The port's MLA (multi-head latent attention) and the minicpm3 model against
the JAX package, from shared weights, on the CPU.

Weights are made by the reference (``materialize`` of its specs) and handed
over through ``from_reference``; the ``q_ln`` / ``kv_ln`` scales (zeros at
init) get random values first, so that the two norm routes round
differently in bf16.  Inputs come from numpy with a seed.  Both routes of the
port are held against the reference: the plain norms (``use_flash=False``)
and the kernel route (``use_flash=True``: the rmsnorm kernel's plain version
for ``q_ln``, ``kv_ln`` and the block norms; the reference never routes MLA
through the flash kernels, nor does the port).

Tolerances: 2e-5 for fp32 values and 5e-5 for fp32 gradients (two fp32
summation orders), 1e-4 over five train steps; 5e-2 for bf16 logits (every
matmul output rounded to 8 bits of mantissa, and on the kernel route one more
rounding per norm, trap T1).
"""

import math
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro_torch.configs as configs
from repro.data.pipeline import make_batch as ref_make_batch
from repro.models import attention as ref_attention
from repro.models import layers as ref_layers
from repro.models import transformer as ref_transformer
from repro.optim import optimizers as ref_optim
from repro.training import loss as ref_loss
from repro.training.train_step import make_train_step as ref_make_train_step
from repro_torch.convert import from_reference, tree_flatten_with_path
from repro_torch.data.pipeline import make_batch
from repro_torch.models import attention, transformer
from repro_torch.models.layers import map_specs
from repro_torch.optim import optimizers as optim
from repro_torch.training import loss
from repro_torch.training.train_step import make_train_step

ARCH = "minicpm3-4b"
FP32 = dict(param_dtype="float32", compute_dtype="float32")
ROUTES = {"plain": dict(use_flash=False), "kernel": dict(use_flash=True)}


def small(**kw):
    """(port config, reference config): the minicpm3 smoke config (2 layers,
    q_lora_rank 32, kv_lora_rank 16, nope 8, rope 8, v 8) with the same
    overrides."""
    return (replace(configs.smoke_config(ARCH), **kw),
            replace(ref_configs.smoke_config(ARCH), **kw))


def shared(spec_tree, fp32=True, seed=0):
    """(jax tree, torch tree) holding the same numbers; fp32 leaves left at
    zero by the init (the norm scales) get values of scale 0.2."""
    jp = ref_layers.materialize(spec_tree, jax.random.PRNGKey(seed))
    if fp32:
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    rng = np.random.default_rng(seed + 5)
    leaves, treedef = jax.tree.flatten(jp)
    leaves = [a + jnp.asarray(0.2 * rng.standard_normal(a.shape), a.dtype)
              if a.dtype == jnp.float32 and a.ndim <= 2 and not np.any(np.asarray(a)) else a
              for a in leaves]
    jp = jax.tree.unflatten(treedef, leaves)
    return jp, from_reference(jax.tree.map(np.asarray, jp), "cpu")


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def tokens(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
            rng.integers(0, cfg.vocab, (B, S)).astype(np.int32))


def positions(B, S):
    return np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()


# -- parameters -----------------------------------------------------------------------


def test_param_tree_matches_reference():
    """Key for key, shape for shape, dtype for dtype; the stacked scan
    dimension holds both layers."""
    cfg, ref_cfg = small()
    mine = tree_flatten_with_path(transformer.init_params(cfg, 0, "cpu"))
    ref = tree_flatten_with_path(jax.tree.map(
        np.asarray, ref_transformer.init_params(ref_cfg, jax.random.PRNGKey(0))))
    assert list(mine) == list(ref)
    for k in mine:
        assert tuple(mine[k].shape) == ref[k].shape, k
        assert str(mine[k].dtype)[6:] == str(ref[k].dtype), k
    assert mine["scan/0/attn/wun"].shape == (2, 16, cfg.n_heads * 8)
    assert "scan/0/attn/q_ln" in mine and "scan/0/attn/kv_ln" in mine


def test_full_config_param_count_from_the_specs():
    """Summed over the specs, nothing allocated: 4,261,902,848, the
    reference's count from its own specs."""
    def count(tree):
        return sum(math.prod(a.shape) for a in jax.tree.leaves(tree))

    ref = count(ref_transformer.abstract_params(ref_configs.get_config(ARCH)))
    total = []
    map_specs(lambda s: total.append(math.prod(s.shape)),
              transformer.param_specs(configs.get_config(ARCH)))
    assert sum(total) == ref == 4_261_902_848


# -- the mixer --------------------------------------------------------------------------


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("S", [16, 128])
def test_mla_attention_matches_reference(route, S):
    cfg, ref_cfg = small(**FP32, **ROUTES[route])
    jp, tp = shared(ref_attention.mla_specs(ref_cfg))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    pos = positions(2, S)
    want = ref_attention.mla_attention(jp, jnp.asarray(x), ref_cfg, jnp.asarray(pos))
    got = attention.mla_attention(tp, torch.from_numpy(x), cfg, torch.from_numpy(pos))
    np.testing.assert_allclose(f32(got), f32(want), atol=2e-5)


def test_mla_attention_takes_no_flash_kernel():
    """S = 128 with use_flash: MLA's qk head is 16 wide and v 8 (96 and 64
    at full size), and neither side routes it through the flash kernels."""
    from repro_torch.kernels import ops
    cfg, ref_cfg = small(**FP32, use_flash=True)
    _, tp = shared(ref_attention.mla_specs(ref_cfg))
    calls = []
    orig = ops.flash_attention
    ops.flash_attention = lambda *a, **k: calls.append(1) or orig(*a, **k)
    try:
        attention.mla_attention(tp, torch.randn(1, 128, cfg.d_model), cfg,
                                torch.arange(128, dtype=torch.int32)[None])
    finally:
        ops.flash_attention = orig
    assert not calls


@pytest.mark.parametrize("route", list(ROUTES))
def test_mla_decode_step_matches_reference(route):
    """The absorbed-matrices decode, 12 steps, caches written in place and
    equal to the reference's."""
    cfg, ref_cfg = small(**FP32, **ROUTES[route])
    jp, tp = shared(ref_attention.mla_specs(ref_cfg))
    rng = np.random.default_rng(4)
    B, T = 2, 12
    m = cfg.mla
    x = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
    jc = (jnp.zeros((B, T, m.kv_lora_rank)), jnp.zeros((B, T, m.qk_rope_dim)))
    tc = (torch.zeros((B, T, m.kv_lora_rank)), torch.zeros((B, T, m.qk_rope_dim)))
    step = jax.jit(lambda p, xx, c0, c1, pos: ref_attention.mla_decode_step(
        p, xx, c0, c1, pos, ref_cfg))
    for t in range(T):
        want, *jc = step(jp, jnp.asarray(x[:, t:t + 1]), *jc, jnp.int32(t))
        got, c0, c1 = attention.mla_decode_step(tp, torch.from_numpy(x[:, t:t + 1]), *tc, t,
                                                cfg)
        assert c0 is tc[0] and c1 is tc[1]
        np.testing.assert_allclose(f32(got), f32(want), atol=2e-5, err_msg=f"step {t}")
    for mine, ref in zip(tc, jc, strict=True):
        np.testing.assert_allclose(f32(mine), f32(ref), atol=2e-5)


# -- the whole model --------------------------------------------------------------------


@pytest.mark.parametrize("route", list(ROUTES))
def test_logits_fn(route):
    cfg, ref_cfg = small(**FP32, **ROUTES[route])
    jp, tp = shared(ref_transformer.param_specs(ref_cfg))
    x, _ = tokens(cfg, 2, 64)
    want, _ = ref_transformer.logits_fn(jp, ref_cfg, jnp.asarray(x))
    got, aux = transformer.logits_fn(tp, cfg, torch.from_numpy(x))
    assert got.shape == (2, 64, cfg.vocab) and float(aux) == 0.0
    np.testing.assert_allclose(f32(got), f32(want), atol=2e-5)


@pytest.mark.parametrize("route", list(ROUTES))
def test_logits_fn_bf16(route):
    """The configured dtypes (bf16 weights and activations)."""
    cfg, ref_cfg = small(**ROUTES[route])
    jp, tp = shared(ref_transformer.param_specs(ref_cfg), fp32=False)
    x, _ = tokens(cfg, 2, 64)
    want, _ = ref_transformer.logits_fn(jp, ref_cfg, jnp.asarray(x))
    got, _ = transformer.logits_fn(tp, cfg, torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(got), f32(want), atol=5e-2)


@pytest.mark.parametrize("route", list(ROUTES))
def test_lm_loss_and_grads(route):
    """Loss to 2e-5 and every gradient leaf to 5e-5 against ``jax.grad``,
    the q_ln / kv_ln scales and the absorbed matrices included; labels
    partly masked."""
    cfg, ref_cfg = small(**FP32, **ROUTES[route])
    jp, tp = shared(ref_transformer.param_specs(ref_cfg))
    x, y = tokens(cfg, 2, 64, seed=1)
    y[:, 50:] = -1

    def f(p):
        return ref_loss.lm_loss(p, ref_cfg, jnp.asarray(x), jnp.asarray(y))

    (want, _), want_g = jax.value_and_grad(f, has_aux=True)(jp)
    leaves = tree_flatten_with_path(tp)
    for t in leaves.values():
        t.requires_grad_(True)
    got, _ = loss.lm_loss(tp, cfg, torch.from_numpy(x), torch.from_numpy(y))
    grads = torch.autograd.grad(got, list(leaves.values()))
    np.testing.assert_allclose(float(got.detach()), float(want), atol=2e-5)
    ref_leaves = tree_flatten_with_path(jax.tree.map(np.asarray, want_g))
    assert list(leaves) == list(ref_leaves)
    for (k, g), gr in zip(zip(leaves, grads, strict=True), ref_leaves.values(), strict=True):
        np.testing.assert_allclose(f32(g), gr, atol=5e-5, err_msg=k)


def test_five_train_steps_match_reference():
    """From the same weights and batches, five whole steps (forward through
    the kernel route, backward, clipping, AdamW) in both packages, fp32, with
    remat (``dots``: the products' outputs kept).  Loss and grad norm per
    step and final parameters to 1e-4."""
    cfg, ref_cfg = small(use_flash=True, remat="dots", **FP32)
    shape = configs.ShapeConfig("t", seq_len=64, global_batch=2, kind="train")
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      ref_transformer.init_params(ref_cfg, jax.random.PRNGKey(0)))
    tp = from_reference(jax.tree.map(np.asarray, jp), "cpu")
    ref_opt = ref_optim.adamw(ref_optim.warmup_cosine(1e-3))
    opt = optim.adamw(optim.warmup_cosine(1e-3))
    js, ts = ref_opt.init(jp), opt.init(tp)
    ref_step = jax.jit(ref_make_train_step(ref_cfg, ref_opt))
    step_fn = make_train_step(cfg, opt)
    for step in range(5):
        jp, js, jm = ref_step(jp, js, ref_make_batch(ref_cfg, shape, step), jnp.int32(step))
        tp, ts, tm = step_fn(tp, ts, make_batch(cfg, shape, step, device="cpu"), step)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), atol=1e-4)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    for a, (k, b) in zip(tree_flatten_with_path(tp).values(),
                         tree_flatten_with_path(jax.tree.map(np.asarray, jp)).items(),
                         strict=True):
        np.testing.assert_allclose(f32(a), f32(b), atol=1e-4, err_msg=k)


def test_launch_main_trains_minicpm3_on_cpu(tmp_path, capsys):
    """``Trainer.fit`` through the CLI: three steps and a checkpoint."""
    from repro_torch.ckpt import store
    from repro_torch.launch.train import main
    main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "3",
          "--seq", "64", "--batch", "2", "--ckpt-dir", str(tmp_path / "ck")])
    assert "steps=3 loss" in capsys.readouterr().out
    assert store.latest_step(str(tmp_path / "ck")) == 3
