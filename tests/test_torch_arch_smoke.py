"""Every arch through the port, on the CPU at smoke size: the counterpart of
``tests/test_arch_smoke.py`` over all ten ``ARCH_IDS``, from the weights the
reference makes (``convert.from_reference``), in the configured dtypes (bf16
weights and activations, fp32 norms, routers and SSM caches).

Per arch: the forward's shapes and finite values, one AdamW train step that
moves the parameters and stays finite, two greedy serve steps and the cache
they write, greedy decode ≡ the teacher-forced forward (the reference's own
bf16 tolerance, atol 0.15 and rtol 0.1), the full configs' parameter counts
from the port's specs against the reference's, and MoE active parameters.

Logits parity against the reference, fp32 at 2e-5 and bf16 at 5e-2, for the
archs no other file holds: nemotron-4-340b, moonshot-v1-16b-a3b,
jamba-1.5-large-398b, internvl2-26b and musicgen-medium.  gemma3-1b and
phi3-medium-14b are held in ``test_torch_model.py``, mamba2-1.3b in
``test_torch_ssm.py``, minicpm3-4b in ``test_torch_mla.py`` and olmoe-1b-7b
in ``test_torch_moe.py``.  jamba's bf16 logits are held to 0.1 (and its aux
loss to 2e-2): its smallest config is 8 layers, and bf16 rounding drifts
further through them (``test_torch_decode.py``).
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
from repro.models import transformer as ref_transformer
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import from_reference, tree_leaves, tree_map
from repro_torch.data.pipeline import make_batch
from repro_torch.models import transformer
from repro_torch.models.layers import map_specs
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.training.train_step import make_serve_step, make_train_step

SMOKE_SHAPE = ShapeConfig("smoke", seq_len=32, global_batch=2, kind="train")
#: logits parity not held by another test_torch_*.py file (module docstring)
PARITY_ARCHS = ["nemotron-4-340b", "moonshot-v1-16b-a3b", "jamba-1.5-large-398b",
                "internvl2-26b", "musicgen-medium"]
#: bf16 (logits atol, aux rtol) where the default (5e-2, 1e-3) does not hold:
#: jamba's 8 layers drift further, enough to flip one first choice of 64
#: tokens, which moves the aux loss by about E·Δme/64 ≈ 1e-2
BF16_TOL = {"jamba-1.5-large-398b": (0.1, 2e-2)}


@pytest.fixture(scope="module", params=configs.ARCH_IDS)
def arch_setup(request):
    """(arch, port config, reference config, torch params) from the
    reference's init."""
    arch = request.param
    ref_cfg = ref_configs.smoke_config(arch)
    jp = ref_transformer.init_params(ref_cfg, jax.random.PRNGKey(0))
    return arch, configs.smoke_config(arch), ref_cfg, \
        from_reference(jax.tree.map(np.asarray, jp), "cpu")


def _finite(x) -> bool:
    return bool(torch.isfinite(x.float()).all())


def _inputs(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "tokens":
        return torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)).astype(np.int32))
    return torch.from_numpy(rng.standard_normal((B, S, cfg.d_model)).astype(np.float32))


def test_forward_shapes_and_finite(arch_setup):
    arch, cfg, _, params = arch_setup
    batch = make_batch(cfg, SMOKE_SHAPE, 0, device="cpu")
    with torch.no_grad():
        logits, aux = transformer.logits_fn(params, cfg, batch["inputs"])
    assert logits.shape == (2, 32, cfg.vocab) and logits.dtype == torch.bfloat16
    assert _finite(logits) and _finite(aux)
    assert (float(aux) > 0) == bool(cfg.moe)


def test_train_step_updates_and_finite(arch_setup):
    arch, cfg, _, params = arch_setup
    params = tree_map(torch.clone, params)       # the step updates in place
    before = [t.clone() for t in tree_leaves(params)]
    opt = make_optimizer("adamw", 1e-3, state_dtype=cfg.state_dtype)
    step = make_train_step(cfg, opt)
    batch = make_batch(cfg, SMOKE_SHAPE, 0, device="cpu")
    new_params, _, metrics = step(params, opt.init(params), batch, 0)
    assert _finite(metrics["loss"]) and float(metrics["loss"]) > 0
    assert _finite(metrics["grad_norm"]) and _finite(metrics["aux_loss"])
    after = tree_leaves(new_params)
    assert all(_finite(t) for t in after)
    assert max(float((a.float() - b.float()).abs().max()) for a, b in zip(after, before,
                                                                            strict=True)) > 0


def test_decode_step_and_cache(arch_setup):
    """Two greedy serve steps: next tokens of shape (B,), and every cache
    leaf the steps write holds something at position 0."""
    arch, cfg, _, params = arch_setup
    B, T = 2, 16
    cache = transformer.init_cache(cfg, B, T, "cpu")
    serve = make_serve_step(cfg)
    inp = _inputs(cfg, B, 2)
    nxt, cache = serve(params, cache, inp[:, :1], 0)
    assert nxt.shape == (B,) and nxt.dtype == torch.int32
    nxt2, cache = serve(params, cache, inp[:, 1:], 1)
    assert nxt2.shape == (B,)
    for leaf in tree_leaves(cache):
        assert _finite(leaf) and leaf.abs().sum() > 0


def test_decode_matches_forward_logits(arch_setup):
    """Decode over a short prompt ≡ the teacher-forced forward, bf16, with
    the reference's tolerance; for embedding-input archs too (the reference
    skips them: its frontend stub feeds positions)."""
    arch, cfg, _, params = arch_setup
    B, S = 1, 8
    toks = _inputs(cfg, B, S)
    logits, _ = transformer.logits_fn(params, cfg, toks)
    cache = transformer.init_cache(cfg, B, S, "cpu")
    outs = []
    for t in range(S):
        lg, cache = transformer.decode_step(params, cache, cfg, toks[:, t:t + 1], t)
        outs.append(lg)
    np.testing.assert_allclose(torch.cat(outs, 1).float().detach().numpy(),
                               logits.float().detach().numpy(), atol=1.5e-1, rtol=1e-1)


def test_full_config_param_counts():
    """Summed over the port's specs of each full config, nothing allocated:
    equal to the reference's specs, and inside the reference test's ranges."""
    expected = {
        "nemotron-4-340b": (320e9, 360e9),
        "gemma3-1b": (0.9e9, 1.2e9),
        "phi3-medium-14b": (13e9, 16e9),
        "minicpm3-4b": (3.8e9, 4.8e9),
        "mamba2-1.3b": (1.2e9, 1.6e9),
        "olmoe-1b-7b": (6.3e9, 7.5e9),
        "jamba-1.5-large-398b": (370e9, 420e9),
    }
    for arch in configs.ARCH_IDS:
        total = []
        map_specs(lambda s: total.append(math.prod(s.shape)),
                  transformer.param_specs(configs.get_config(arch)))
        ref = sum(math.prod(a.shape) for a in jax.tree.leaves(
            ref_transformer.abstract_params(ref_configs.get_config(arch))))
        assert sum(total) == ref, arch
        if arch in expected:
            lo, hi = expected[arch]
            assert lo < configs.get_config(arch).param_count() < hi, arch


def test_moe_active_params():
    cfg = configs.get_config("olmoe-1b-7b")
    assert cfg.active_param_count() < 0.25 * cfg.param_count()
    for arch in configs.ARCH_IDS:
        assert configs.get_config(arch).active_param_count() == \
            ref_configs.get_config(arch).active_param_count(), arch


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", PARITY_ARCHS)
def test_logits_match_reference(arch, dtype):
    """Logits and aux from the same weights: fp32 (every weight cast on both
    sides) within 2e-5; the configured dtypes within 5e-2 and the aux loss
    within 1e-3 of itself (jamba: ``BF16_TOL``), the MoE routers drawn at std
    1 so that no near-tie of two gates flips (``test_torch_decode.py``)."""
    ref_cfg = ref_configs.smoke_config(arch)
    cfg = configs.smoke_config(arch)
    jp = ref_transformer.init_params(ref_cfg, jax.random.PRNGKey(1))
    if dtype == "float32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
        cfg = replace(cfg, param_dtype=dtype, compute_dtype=dtype)
        ref_cfg = replace(ref_cfg, param_dtype=dtype, compute_dtype=dtype)
    else:
        jp = jax.tree_util.tree_map_with_path(
            lambda path, a: a * 50.0 if path[-1].key == "router" else a, jp)
    tp = from_reference(jax.tree.map(np.asarray, jp), "cpu")
    x = _inputs(cfg, 2, 32, seed=3)
    want, want_aux = ref_transformer.logits_fn(jp, ref_cfg, jnp.asarray(x.numpy()))
    with torch.no_grad():
        got, aux = transformer.logits_fn(tp, cfg, x)
    if dtype == "float32":
        tol, aux_tol = 2e-5, dict(atol=2e-5)
    else:
        tol, aux_rtol = BF16_TOL.get(arch, (5e-2, 1e-3))
        aux_tol = dict(rtol=aux_rtol)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=tol)
    np.testing.assert_allclose(float(aux), float(want_aux), **aux_tol)
