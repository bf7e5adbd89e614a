"""Module-by-module parity of the port's model with the JAX package, from
shared weights, on the CPU.

Weights are made by ``repro.models.init_params`` / ``materialize`` (JAX),
turned into numpy and handed to the port through ``from_reference``; inputs
come from numpy with a seed.  fp32 runs cast every weight to fp32 on both
sides (the specs give the matrices bf16 whatever the config says).

Tolerances: 2e-5 for fp32 values and 5e-5 for fp32 gradients — two orders of
fp32 summation (XLA's and ATen's matmuls) through at most 8 layers; 5e-2 for
bf16 logits, whose every matmul output is rounded to 8 bits of mantissa.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro_torch.configs as configs
from repro.models import attention as ref_attention
from repro.models import layers as ref_layers
from repro.models import transformer as ref_transformer
from repro.training import loss as ref_loss
from repro_torch.convert import from_reference, numpy_to_tensor, tree_flatten_with_path
from repro_torch.kernels import ref as kernel_ref
from repro_torch.models import attention, layers, transformer
from repro_torch.training import loss

FP32 = dict(param_dtype="float32", compute_dtype="float32")


def small(arch, **kw):
    """(port config, reference config) with the same overrides."""
    return (replace(configs.smoke_config(arch), **kw),
            replace(ref_configs.smoke_config(arch), **kw))


def shared_params(ref_cfg, fp32=True, spec_fn=ref_transformer.param_specs, seed=0):
    """(jax tree, torch tree) holding the same numbers."""
    jp = ref_layers.materialize(spec_fn(ref_cfg), jax.random.PRNGKey(seed))
    if fp32:
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    return jp, from_reference(jax.tree.map(np.asarray, jp), "cpu")


def pair(a, dtype=None):
    a = np.asarray(a)
    return jnp.asarray(a, dtype), numpy_to_tensor(np.asarray(jnp.asarray(a, dtype)))


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def tokens(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
            rng.integers(0, cfg.vocab, (B, S)).astype(np.int32))


# -- layers ---------------------------------------------------------------------


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-6), ("bfloat16", 0.0)])
def test_rmsnorm(dtype, tol):
    """fp32 statistics, cast, then (1 + scale) in the input dtype.  In bf16
    both sides round at the same two places, so the results are identical."""
    rng = np.random.default_rng(0)
    jx, tx = pair(rng.standard_normal((2, 9, 64)).astype(np.float32), dtype)
    js, ts = pair((rng.standard_normal(64) * 0.1).astype(np.float32))
    want = ref_layers.rmsnorm(jx, js, 1e-6)
    got = layers.rmsnorm(tx, ts, 1e-6)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(f32(got), f32(want), atol=tol, rtol=tol)
    if dtype == "bfloat16":
        # the model's rounding order is not the kernel oracle's fp32 product
        xf = tx.float()
        fused = (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + 1e-6)
                 * (1.0 + ts)).to(torch.bfloat16)
        assert not torch.equal(got, fused)


@pytest.mark.parametrize("theta,hd", [(10000.0, 16), (1000000.0, 64)])
def test_apply_rope(theta, hd):
    rng = np.random.default_rng(1)
    jx, tx = pair(rng.standard_normal((2, 33, 3, hd)).astype(np.float32))
    pos = np.broadcast_to(np.arange(100, 133, dtype=np.int32), (2, 33))
    want = ref_layers.apply_rope(jx, jnp.asarray(pos), theta)
    got = layers.apply_rope(tx, torch.from_numpy(pos.copy()), theta)
    # angles up to 133 rad in fp32: cos/sin of the two libraries differ by ulps
    np.testing.assert_allclose(f32(got), f32(want), atol=2e-5)
    np.testing.assert_array_equal(layers.rope_freqs(hd, theta),
                                  ref_layers.rope_freqs(hd, theta))
    # split-half, not interleaved: position 0 is the identity
    zero = layers.apply_rope(tx, torch.zeros((2, 33), dtype=torch.int32), theta)
    assert torch.equal(zero, tx)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu", "squared_relu"])
def test_mlp_apply(kind):
    cfg, ref_cfg = small("phi3-medium-14b", mlp=kind)
    jp, tp = shared_params(ref_cfg, spec_fn=ref_layers.mlp_specs)
    assert set(tp) == set(layers.mlp_specs(cfg))
    rng = np.random.default_rng(2)
    jx, tx = pair(rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32))
    np.testing.assert_allclose(f32(layers.mlp_apply(tp, tx, cfg)),
                               f32(ref_layers.mlp_apply(jp, jx, ref_cfg)), atol=2e-5)


def test_gelu_is_the_tanh_approximation():
    x = torch.linspace(-3, 3, 101)
    want = f32(jax.nn.gelu(jnp.asarray(x.numpy())))
    got = torch.nn.functional.gelu(x, approximate="tanh")
    np.testing.assert_allclose(f32(got), want, atol=1e-6)
    assert np.abs(f32(torch.nn.functional.gelu(x)) - want).max() > 1e-4


# -- attention --------------------------------------------------------------------


@pytest.mark.parametrize("branch", ["flash", "chunked", "dense"])
@pytest.mark.parametrize("arch,window", [("gemma3-1b", 32), ("gemma3-1b", None),
                                         ("phi3-medium-14b", None)])
def test_gqa_attention(branch, arch, window):
    kw = {"flash": dict(use_flash=True),
          "chunked": dict(attn_chunked=True, attn_chunk=32),
          "dense": dict(attn_chunked=False)}[branch]
    cfg, ref_cfg = small(arch, **kw)
    jp, tp = shared_params(ref_cfg, spec_fn=ref_attention.attn_specs)
    rng = np.random.default_rng(3)
    B, S = 2, 128
    jx, tx = pair(rng.standard_normal((B, S, cfg.d_model)).astype(np.float32))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    want = ref_attention.gqa_attention(jp, jx, ref_cfg, jnp.asarray(pos), window=window)
    got = attention.gqa_attention(tp, tx, cfg, torch.from_numpy(pos), window=window)
    np.testing.assert_allclose(f32(got), f32(want), atol=2e-5)


def test_flash_gate_needs_seq_multiple_of_128():
    """S = 64 with use_flash takes the dense branch, as in the reference."""
    from repro_torch.kernels import ops
    cfg, _ = small("phi3-medium-14b", use_flash=True)
    _, tp = shared_params(ref_configs.smoke_config("phi3-medium-14b"),
                          spec_fn=ref_attention.attn_specs)
    x = torch.randn(1, 64, cfg.d_model)
    pos = torch.arange(64, dtype=torch.int32)[None]
    calls = []
    orig = ops.flash_attention
    ops.flash_attention = lambda *a, **k: calls.append(1) or orig(*a, **k)
    try:
        attention.gqa_attention(tp, x, cfg, pos)
        assert not calls
        attention.gqa_attention(tp, torch.randn(1, 128, cfg.d_model), cfg,
                                torch.arange(128, dtype=torch.int32)[None])
        assert calls == [1]
    finally:
        ops.flash_attention = orig


def test_causal_mask_matches_reference():
    for S, T, w, off in [(8, 8, None, 0), (8, 16, 3, 8), (5, 5, 1, 0)]:
        want = np.asarray(ref_attention._causal_mask(S, T, w, off))
        np.testing.assert_array_equal(attention._causal_mask(S, T, w, off).numpy(), want)
        # the kernels' mask is the same rule with q_offset = T - S
        np.testing.assert_array_equal(
            kernel_ref.attention_mask(S, T, True, w, "cpu").numpy(),
            np.asarray(ref_attention._causal_mask(S, T, w, T - S)))


# -- the whole model ----------------------------------------------------------------


def model_case(name):
    if name == "gemma3-8L":      # one scanned period of 6 + a remainder of 2
        return small("gemma3-1b", n_layers=8, **FP32)
    if name == "gemma3-8L-flash":
        return small("gemma3-1b", n_layers=8, use_flash=True, **FP32)
    if name == "gemma3-12L-remat":   # two scanned periods, recomputed in backward
        return small("gemma3-1b", n_layers=12, remat="dots", **FP32)
    return small("phi3-medium-14b", **FP32)


@pytest.mark.parametrize("name", ["gemma3-8L", "gemma3-8L-flash", "phi3"])
def test_param_tree_matches_reference(name):
    cfg, ref_cfg = model_case(name)
    mine = transformer.init_params(cfg, 0, "cpu")
    ref = jax.tree.map(np.asarray, ref_transformer.init_params(ref_cfg,
                                                               jax.random.PRNGKey(0)))
    a, b = tree_flatten_with_path(mine), tree_flatten_with_path(ref)
    assert list(a) == list(b)
    for k in a:
        assert tuple(a[k].shape) == b[k].shape and str(a[k].dtype)[6:] == str(b[k].dtype), k
    if name.startswith("gemma3-8L"):
        assert mine["scan"]["0"]["attn"]["wq"].shape[0] == 1 and set(mine["rem"]) == {"0", "1"}
    # same init distributions: zeros for norm scales, std 0.02 for the table,
    # 1/sqrt(fan_in) for the matrices
    assert float(mine["final_norm"]["scale"].abs().max()) == 0.0
    assert abs(float(mine["embed"]["table"].float().std()) - 0.02) < 2e-3
    wq = mine["scan"]["0"]["attn"]["wq"].float()
    assert abs(float(wq.std()) * cfg.d_model ** 0.5 - 1.0) < 0.1


@pytest.mark.parametrize("name", ["gemma3-8L", "gemma3-8L-flash", "phi3"])
def test_logits_fn(name):
    cfg, ref_cfg = model_case(name)
    jp, tp = shared_params(ref_cfg)
    x, _ = tokens(cfg, 2, 128)
    want, _ = ref_transformer.logits_fn(jp, ref_cfg, jnp.asarray(x))
    got, aux = transformer.logits_fn(tp, cfg, torch.from_numpy(x))
    assert got.shape == (2, 128, cfg.vocab) and float(aux) == 0.0
    np.testing.assert_allclose(f32(got), f32(want), atol=2e-5)


def test_logits_fn_bf16():
    """The configured dtypes (bf16 weights and activations)."""
    cfg, ref_cfg = small("gemma3-1b", n_layers=8)
    jp, tp = shared_params(ref_cfg, fp32=False)
    assert tp["embed"]["table"].dtype == torch.bfloat16
    x, _ = tokens(cfg, 2, 64)
    want, _ = ref_transformer.logits_fn(jp, ref_cfg, jnp.asarray(x))
    got, _ = transformer.logits_fn(tp, cfg, torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(got), f32(want), atol=5e-2)


def test_embedding_scale_is_rounded_to_the_activation_dtype():
    cfg, _ = small("gemma3-1b", d_model=48, n_heads=3, n_layers=6)
    p = transformer.init_params(cfg, 0, "cpu")
    x = torch.zeros((1, 4), dtype=torch.int32)
    row = p["embed"]["table"][0]
    want = row * torch.tensor(48 ** 0.5, dtype=torch.bfloat16)
    assert float(torch.tensor(48 ** 0.5, dtype=torch.bfloat16)) != 48 ** 0.5
    seen = {}
    orig = transformer._apply_layer

    def spy(prm, h, *a):
        seen.setdefault("x", h)
        return orig(prm, h, *a)

    transformer._apply_layer = spy
    try:
        transformer.forward_hidden(p, cfg, x)
    finally:
        transformer._apply_layer = orig
    assert torch.equal(seen["x"][0, 0], want)


@pytest.mark.parametrize("name", ["gemma3-8L", "gemma3-8L-flash", "gemma3-12L-remat", "phi3"])
@pytest.mark.parametrize("chunk", [None, 32])
def test_lm_loss_and_grads(name, chunk):
    """Loss and metrics to 2e-5, every gradient leaf to 5e-5 (vs jax.grad).
    Labels are partly masked (-1); tied embeddings sum both uses of the table."""
    cfg, ref_cfg = model_case(name)
    jp, tp = shared_params(ref_cfg)
    x, y = tokens(cfg, 2, 128, seed=1)
    y[:, 100:] = -1

    def f(p):
        return ref_loss.lm_loss(p, ref_cfg, jnp.asarray(x), jnp.asarray(y), loss_chunk=chunk)

    (want, want_m), want_g = jax.value_and_grad(f, has_aux=True)(jp)
    leaves = tree_flatten_with_path(tp)
    for t in leaves.values():
        t.requires_grad_(True)
    got, got_m = loss.lm_loss(tp, cfg, torch.from_numpy(x), torch.from_numpy(y),
                              loss_chunk=chunk)
    grads = torch.autograd.grad(got, list(leaves.values()))
    np.testing.assert_allclose(float(got.detach()), float(want), atol=2e-5)
    assert float(got_m["tokens"]) == float(want_m["tokens"]) == 200.0
    np.testing.assert_allclose(float(got_m["nll"].detach()), float(want_m["nll"]), atol=2e-5)
    ref_leaves = tree_flatten_with_path(jax.tree.map(np.asarray, want_g))
    for (k, g), (kr, gr) in zip(zip(leaves, grads, strict=True), ref_leaves.items(),
                                strict=True):
        assert k == kr
        np.testing.assert_allclose(f32(g), gr, atol=5e-5, err_msg=k)


def test_loss_constants_and_auto_chunk_rule():
    assert (loss.Z_LOSS, loss.AUX_LOSS) == (ref_loss.Z_LOSS, ref_loss.AUX_LOSS)
    # gemma3-1b at S=4096: 4096 * 262144 > 2^28 -> chunks of S/8, as in the reference
    cfg = configs.get_config("gemma3-1b")
    assert 4096 * cfg.vocab > (1 << 28) and cfg.loss_chunk == 0
    # the small model is below the threshold: chunked and unchunked must agree anyway
    scfg, ref_cfg = small("gemma3-1b", **FP32)
    _, tp = shared_params(ref_cfg)
    x, y = tokens(scfg, 2, 64)
    a, _ = loss.lm_loss(tp, scfg, torch.from_numpy(x), torch.from_numpy(y))
    b, _ = loss.lm_loss(tp, scfg, torch.from_numpy(x), torch.from_numpy(y), loss_chunk=16)
    np.testing.assert_allclose(float(a), float(b), rtol=1e-6)
