"""The port's Mixture-of-Experts layer and the olmoe model against the JAX
package, from shared weights, on the CPU.

Weights are made by the reference (``materialize`` of its specs) and handed
over through ``from_reference``; inputs come from numpy with a seed.  Three
routers: the random init ("small", std 0.02); one with two identical
columns, so that two experts tie exactly and the tie order decides which of
them runs (trap T7); and one that sends every token's first choice to
expert 0, so that its capacity drops entries.

Tolerances: 2e-5 for fp32 values and 5e-5 for fp32 gradients (two fp32
summation orders), 1e-4 over five train steps; 5e-2 for bf16 (every product
rounded to 8 bits of mantissa; the port sums a token's K expert outputs in
fp32 and casts once where the reference adds them in bf16).
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
from repro.models import layers as ref_layers
from repro.models import moe as ref_moe
from repro.models import transformer as ref_transformer
from repro.optim import optimizers as ref_optim
from repro.training import loss as ref_loss
from repro.training.train_step import make_train_step as ref_make_train_step
from repro_torch.convert import from_reference, to_reference, tree_flatten_with_path
from repro_torch.data.pipeline import make_batch
from repro_torch.models import moe, transformer
from repro_torch.models.layers import map_specs
from repro_torch.optim import optimizers as optim
from repro_torch.training import loss
from repro_torch.training.train_step import make_train_step

ARCH = "olmoe-1b-7b"
FP32 = dict(param_dtype="float32", compute_dtype="float32")
ROUTES = {"plain": dict(use_flash=False), "kernel": dict(use_flash=True)}
ROUTERS = ["random", "tied", "one_expert"]


def small(arch=ARCH, **kw):
    """(port config, reference config): the smoke config (4 experts, top 2,
    d_ff_expert 64, d_model 64) with the same overrides; ``moe=`` takes a
    dict of MoEConfig overrides."""
    moe_kw = kw.pop("moe", None)
    cfgs = []
    for mod in (configs, ref_configs):
        cfg = replace(mod.smoke_config(arch), **kw)
        if moe_kw:
            cfg = replace(cfg, moe=replace(cfg.moe, **moe_kw))
        cfgs.append(cfg)
    return tuple(cfgs)


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def shared_moe(ref_cfg, router="random", fp32=True, seed=0):
    """(jax tree, torch tree) of one MoE layer's weights with the same
    numbers; ``router`` as in the module docstring."""
    jp = ref_layers.materialize(ref_moe.moe_specs(ref_cfg), jax.random.PRNGKey(seed))
    if fp32:
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    r = np.asarray(jp["router"], np.float32).copy()
    if router == "tied":
        r[:, 2] = r[:, 1]                      # experts 1 and 2 tie everywhere
    elif router == "one_expert":
        r[:, 0] = 0.5                          # with x ≥ 0, expert 0 always leads
    jp = {**jp, "router": jnp.asarray(r)}
    return jp, from_reference(jax.tree.map(np.asarray, jp), "cpu")


def moe_input(cfg, B, S, router="random", seed=1, dtype=np.float32):
    x = np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    if router == "one_expert":
        x = np.abs(x)
    return x.astype(dtype)


# -- parameters and capacity ----------------------------------------------------------


@pytest.mark.parametrize("mlp", ["swiglu", "geglu", "gelu"])
def test_moe_specs_match_reference(mlp):
    """Keys, shapes, dtypes, axes and inits: the router (d, E) fp32
    ``small``; ``wi`` / ``wo`` (E, d, f) / (E, f, d); ``wg`` only for the
    gated MLPs."""
    cfg, ref_cfg = small(mlp=mlp)
    mine, ref = moe.moe_specs(cfg), ref_moe.moe_specs(ref_cfg)
    assert sorted(mine) == sorted(ref)
    for k in ref:
        assert (mine[k].shape, mine[k].axes, mine[k].dtype, mine[k].init) == \
            (ref[k].shape, ref[k].axes, ref[k].dtype, ref[k].init), k
    assert mine["router"].dtype == "float32" and mine["router"].init == "small"
    assert ("wg" in mine) == (mlp != "gelu")


@pytest.mark.parametrize("E,K", [(4, 2), (16, 2), (64, 6), (64, 8)])
def test_capacity_matches_reference(E, K):
    """At least 8, a multiple of 8, over group sizes and capacity factors
    (E/K gives C = S: nothing can be dropped)."""
    for S in (1, 3, 8, 24, 100, 128, 768, 4096):
        for cf in (0.5, 1.0, 1.25, 2.0, E / K):
            cfg, ref_cfg = small(moe=dict(n_experts=E, top_k=K, capacity_factor=cf))
            c = moe._capacity(S, cfg)
            assert c == ref_moe._capacity(S, ref_cfg), (S, cf)
            assert c >= 8 and c % 8 == 0
            if cf == E / K:
                assert c >= S


# -- routing: tie order and dispatch --------------------------------------------------


@pytest.mark.parametrize("K", [1, 2, 3, 8])
def test_top_k_takes_lax_top_k_order_on_exact_ties(K):
    """Gates drawn from four values (every row full of exact ties): the
    port's top k equal ``jax.lax.top_k``'s values and indices, the lower
    index first among equal values."""
    rng = np.random.default_rng(K)
    g = rng.choice(np.array([0.05, 0.1, 0.2, 0.4], np.float32), size=(3, 50, 16))
    g[0, 0] = 0.1                              # a row of 16 equal gates
    want_v, want_i = jax.lax.top_k(jnp.asarray(g), K)
    got_v, got_i = moe._top_k(torch.from_numpy(g), K)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert got_i[0, 0].tolist() == list(range(K))


def reference_dispatch(top_idx, E, C):
    """The reference's ``route_group`` (``src/repro/models/moe.py``) per
    group, as it is written there: (order, dest) in sorted order."""
    def group(idx_g):
        flat_e = idx_g.reshape(-1)
        order = jnp.argsort(flat_e, stable=True)
        se = flat_e[order]
        counts = jnp.bincount(flat_e, length=E)
        starts = jnp.cumsum(counts) - counts
        rank = jnp.arange(flat_e.shape[0]) - starts[se]
        return order, jnp.where(rank < C, se * C + rank, E * C)
    return jax.vmap(group)(jnp.asarray(top_idx))


@pytest.mark.parametrize("E,K,S,C", [(4, 2, 24, 8), (4, 2, 24, 16), (8, 3, 40, 8),
                                     (64, 8, 100, 16)])
def test_dispatch_slots_match_reference(E, K, S, C):
    """Every entry's slot (rank within its expert by a stable sort, dropped
    past C) equals the reference's, on choices with many ties among the
    entries (few experts, many tokens), including groups that overflow."""
    rng = np.random.default_rng(E + K + S)
    top_idx = np.stack([np.stack([rng.choice(E, K, replace=False) for _ in range(S)])
                        for _ in range(3)]).astype(np.int64)
    top_idx[1, :, 0] = 0                       # group 1: expert 0 overflows
    order, dest_sorted = (np.asarray(a) for a in reference_dispatch(top_idx, E, C))
    want = np.empty_like(dest_sorted)
    np.put_along_axis(want, order, dest_sorted, axis=1)   # back to token order
    got = moe._dispatch_slots(torch.from_numpy(top_idx), E, C).reshape(3, S * K)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[1] == E * C).any()             # something was dropped


# -- moe_apply ------------------------------------------------------------------------


@pytest.mark.parametrize("router", ROUTERS)
@pytest.mark.parametrize("mlp", ["swiglu", "geglu", "gelu"])
def test_moe_apply_matches_reference(router, mlp):
    """y and aux in fp32 within 2e-5: random weights, two tied experts, and
    one expert that takes every first choice (its capacity drops)."""
    cfg, ref_cfg = small(mlp=mlp, **FP32)
    jp, tp = shared_moe(ref_cfg, router)
    x = moe_input(cfg, 3, 24, router)
    want_y, want_aux = ref_moe.moe_apply(jp, jnp.asarray(x), ref_cfg)
    got_y, got_aux = moe.moe_apply(tp, torch.from_numpy(x), cfg)
    assert got_y.shape == (3, 24, cfg.d_model) and got_aux.dtype == torch.float32
    np.testing.assert_allclose(f32(got_y), f32(want_y), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(float(got_aux), float(want_aux), atol=2e-5, rtol=2e-5)


def test_router_cases_do_what_they_say():
    """The tied router ties experts 1 and 2 exactly and the tie decides
    which runs; the one-expert router overflows expert 0."""
    cfg, ref_cfg = small(**FP32)
    _, tp = shared_moe(ref_cfg, "tied")
    x = torch.from_numpy(moe_input(cfg, 3, 24, "tied"))
    gates, _, top_idx = moe._route(tp, x, cfg)
    assert torch.equal(gates[..., 1], gates[..., 2])
    chosen = (top_idx == 1) | (top_idx == 2)
    assert (chosen.sum(-1) == 1).any()         # one of the pair runs: expert 1
    assert not (top_idx == 2)[chosen.sum(-1) == 1].any()
    _, tp = shared_moe(ref_cfg, "one_expert")
    x = torch.from_numpy(moe_input(cfg, 3, 24, "one_expert"))
    _, _, top_idx = moe._route(tp, x, cfg)
    assert (top_idx[..., 0] == 0).all() and moe._capacity(24, cfg) < 24


@pytest.mark.parametrize("router", ROUTERS)
def test_moe_apply_grads_match_reference(router):
    """Every gradient (router, wi, wg, wo and the input) of
    ``sum(y·r) + aux`` against ``jax.grad`` within 5e-5."""
    cfg, ref_cfg = small(**FP32)
    jp, tp = shared_moe(ref_cfg, router)
    x = moe_input(cfg, 3, 24, router)
    r = np.random.default_rng(9).standard_normal((3, 24, cfg.d_model)).astype(np.float32)

    def f(p, xx):
        y, aux = ref_moe.moe_apply(p, xx, ref_cfg)
        return jnp.sum(y * jnp.asarray(r)) + aux

    want_p, want_x = jax.grad(f, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = tree_flatten_with_path(tp)
    xt = torch.from_numpy(x).requires_grad_(True)
    for t in leaves.values():
        t.requires_grad_(True)
    y, aux = moe.moe_apply(tp, xt, cfg)
    grads = torch.autograd.grad(torch.sum(y * torch.from_numpy(r)) + aux,
                                [*leaves.values(), xt])
    ref = tree_flatten_with_path(jax.tree.map(np.asarray, want_p))
    assert list(leaves) == list(ref) == ["router", "wg", "wi", "wo"]
    for k, g in zip(leaves, grads, strict=False):
        np.testing.assert_allclose(f32(g), ref[k], atol=5e-5, rtol=5e-5, err_msg=k)
        assert np.abs(ref[k]).max() > 0, k
    np.testing.assert_allclose(f32(grads[-1]), f32(want_x), atol=5e-5, rtol=5e-5)


def test_aux_loss_has_no_gradient_through_the_first_choice():
    """``ce`` counts first choices: with the gates fixed, the aux loss's
    gradient reaches the router only through ``me``."""
    cfg, ref_cfg = small(**FP32)
    _, tp = shared_moe(ref_cfg)
    x = torch.from_numpy(moe_input(cfg, 2, 16))
    gates = torch.softmax(x @ tp["router"], dim=-1).requires_grad_(True)
    _, top_idx = moe._top_k(gates, cfg.moe.top_k)
    aux = moe._aux_loss(gates, top_idx, cfg.moe.n_experts)
    (g,) = torch.autograd.grad(aux, gates)
    ce = torch.nn.functional.one_hot(top_idx[..., 0], 4).float().mean(dim=(0, 1))
    np.testing.assert_allclose(g.numpy(), np.broadcast_to(
        4 * ce.numpy() / (2 * 16), g.shape), rtol=1e-6)


@pytest.mark.parametrize("router", ROUTERS)
def test_moe_apply_bf16(router):
    """The configured dtypes (bf16 activations and expert weights, fp32
    router) within 5e-2."""
    cfg, ref_cfg = small()
    jp, tp = shared_moe(ref_cfg, router, fp32=False)
    x = moe_input(cfg, 3, 24, router)
    want_y, want_aux = ref_moe.moe_apply(jp, jnp.asarray(x, jnp.bfloat16), ref_cfg)
    got_y, got_aux = moe.moe_apply(tp, torch.from_numpy(x).to(torch.bfloat16), cfg)
    assert got_y.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(got_y), f32(want_y), atol=5e-2, rtol=5e-2)
    np.testing.assert_allclose(float(got_aux), float(want_aux), atol=1e-5)


def test_combine_sums_in_fp32_and_casts_once():
    """bf16: y is the fp32 sum of a token's K weighted expert outputs, cast
    once (the rounding stated in docs/torch_port.md); the weight is cast to
    bf16 before its product, as in the reference."""
    cfg, ref_cfg = small(moe=dict(top_k=3))
    _, tp = shared_moe(ref_cfg, fp32=False)
    x = torch.from_numpy(moe_input(cfg, 2, 16)).to(torch.bfloat16)
    y, _ = moe.moe_apply(tp, x, cfg)
    B, S, D = x.shape
    E, K, C = 4, 3, moe._capacity(S, cfg)
    _, top_gate, top_idx = moe._route(tp, x, cfg)
    want = torch.zeros((B, S, D), dtype=torch.float32)
    for b in range(B):
        for s in range(S):
            for k in range(K):
                e = int(top_idx[b, s, k])
                h = x[b, s] @ tp["wi"][e]
                h = torch.nn.functional.silu(x[b, s] @ tp["wg"][e]) * h
                out = h @ tp["wo"][e]
                want[b, s] += (out * top_gate[b, s, k].to(torch.bfloat16)).float()
    assert C >= S                               # nothing dropped at this size
    assert torch.equal(y, want.to(torch.bfloat16))


def test_decode_step_drops_nothing():
    """A decode step routes one token a group: capacity ≥ top_k for every
    MoE arch, so nothing is dropped."""
    for arch in configs.ARCH_IDS:
        cfg = configs.get_config(arch)
        if cfg.moe:
            assert moe._capacity(1, cfg) >= cfg.moe.top_k, arch


# -- the whole model ------------------------------------------------------------------


def shared_params(ref_cfg, fp32=True, seed=0):
    jp = ref_transformer.init_params(ref_cfg, jax.random.PRNGKey(seed))
    if fp32:
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    return jp, from_reference(jax.tree.map(np.asarray, jp), "cpu")


def tokens(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
            rng.integers(0, cfg.vocab, (B, S)).astype(np.int32))


def test_param_tree_and_full_param_count():
    """The smoke tree key for key (``ln2`` and ``moe`` in every layer), and
    the full config's count from the specs equals the reference's,
    6,919,096,320: the analytic count (6,919,094,272) and the final norm,
    which it leaves out."""
    cfg, ref_cfg = small()
    mine = tree_flatten_with_path(transformer.init_params(cfg, 0, "cpu"))
    ref = tree_flatten_with_path(jax.tree.map(
        np.asarray, ref_transformer.init_params(ref_cfg, jax.random.PRNGKey(0))))
    assert list(mine) == list(ref)
    for k in mine:
        assert tuple(mine[k].shape) == ref[k].shape, k
        assert str(mine[k].dtype)[6:] == str(ref[k].dtype), k
    assert mine["scan/0/moe/wi"].shape == (2, 4, 64, 64)
    total = []
    map_specs(lambda s: total.append(math.prod(s.shape)),
              transformer.param_specs(configs.get_config(ARCH)))
    ref_total = sum(math.prod(a.shape) for a in jax.tree.leaves(
        ref_transformer.abstract_params(ref_configs.get_config(ARCH))))
    full = configs.get_config(ARCH)
    assert sum(total) == ref_total == full.param_count() + full.d_model == 6_919_096_320


def test_moe_leaves_convert_unchanged():
    """The router crosses in fp32 and the expert stacks in bf16, bit for
    bit, both ways."""
    _, ref_cfg = small()
    jp = jax.tree.map(np.asarray, ref_transformer.init_params(ref_cfg, jax.random.PRNGKey(3)))
    tp = from_reference(jp, "cpu")
    m = tp["scan"]["0"]["moe"]
    assert m["router"].dtype == torch.float32
    assert {m[k].dtype for k in ("wi", "wg", "wo")} == {torch.bfloat16}
    back = tree_flatten_with_path(to_reference(tp))
    for k, a in tree_flatten_with_path(jp).items():
        assert back[k].dtype == a.dtype, k
        np.testing.assert_array_equal(back[k].view(np.uint8), a.view(np.uint8), err_msg=k)


@pytest.mark.parametrize("route", list(ROUTES))
def test_logits_fn_and_aux(route):
    """Logits to 2e-5 and the aux loss summed over the layers to 2e-5."""
    cfg, ref_cfg = small(**FP32, **ROUTES[route])
    jp, tp = shared_params(ref_cfg)
    x, _ = tokens(cfg, 2, 128)
    want, want_aux = ref_transformer.logits_fn(jp, ref_cfg, jnp.asarray(x))
    got, aux = transformer.logits_fn(tp, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(f32(got), f32(want), atol=2e-5)
    assert float(aux) > 0
    np.testing.assert_allclose(float(aux), float(want_aux), atol=2e-5)


@pytest.mark.parametrize("route", list(ROUTES))
def test_lm_loss_and_grads(route):
    """Loss (with ``AUX_LOSS · aux``) to 2e-5 and every gradient leaf, the
    routers included, to 5e-5 against ``jax.grad``; labels partly masked, S
    = 128 so that the kernel route takes the flash kernels' plain version."""
    cfg, ref_cfg = small(**FP32, **ROUTES[route])
    jp, tp = shared_params(ref_cfg)
    x, y = tokens(cfg, 2, 128, seed=1)
    y[:, 100:] = -1

    def f(p):
        return ref_loss.lm_loss(p, ref_cfg, jnp.asarray(x), jnp.asarray(y))

    (want, want_m), want_g = jax.value_and_grad(f, has_aux=True)(jp)
    leaves = tree_flatten_with_path(tp)
    for t in leaves.values():
        t.requires_grad_(True)
    got, metrics = loss.lm_loss(tp, cfg, torch.from_numpy(x), torch.from_numpy(y))
    grads = torch.autograd.grad(got, list(leaves.values()))
    np.testing.assert_allclose(float(got.detach()), float(want), atol=2e-5)
    np.testing.assert_allclose(float(metrics["aux_loss"].detach()),
                               float(want_m["aux_loss"]), atol=2e-5)
    ref_leaves = tree_flatten_with_path(jax.tree.map(np.asarray, want_g))
    assert list(leaves) == list(ref_leaves)
    for (k, g), gr in zip(zip(leaves, grads, strict=True), ref_leaves.values(), strict=True):
        np.testing.assert_allclose(f32(g), gr, atol=5e-5, err_msg=k)
    assert np.abs(ref_leaves["scan/0/moe/router"]).max() > 0


def test_aux_loss_flows_into_the_loss():
    """``lm_loss`` = nll + z-loss + ``AUX_LOSS · aux``: removing the aux term
    by hand gives the loss of the same model with its aux set to zero."""
    cfg, ref_cfg = small(**FP32)
    _, tp = shared_params(ref_cfg)
    x, y = tokens(cfg, 2, 32, seed=2)
    got, m = loss.lm_loss(tp, cfg, torch.from_numpy(x), torch.from_numpy(y))
    _, aux = transformer.forward_hidden(tp, cfg, torch.from_numpy(x))
    assert float(m["aux_loss"]) == float(aux) > 0.5
    orig = transformer.forward_hidden
    try:
        loss.forward_hidden = lambda *a: (orig(*a)[0], torch.zeros(()))
        without, _ = loss.lm_loss(tp, cfg, torch.from_numpy(x), torch.from_numpy(y))
    finally:
        loss.forward_hidden = orig
    np.testing.assert_allclose(float(got - without), loss.AUX_LOSS * float(aux), rtol=1e-5)


def test_five_train_steps_match_reference():
    """From the same weights and batches, five whole steps (forward through
    the kernel route, backward, clipping, AdamW) in both packages, fp32, with
    remat.  Loss, aux and grad norm per step and the final parameters to
    1e-4."""
    cfg, ref_cfg = small(use_flash=True, remat="dots", **FP32)
    shape = configs.ShapeConfig("t", seq_len=64, global_batch=2, kind="train")
    jp, tp = shared_params(ref_cfg)
    ref_opt = ref_optim.adamw(ref_optim.warmup_cosine(1e-3))
    opt = optim.adamw(optim.warmup_cosine(1e-3))
    js, ts = ref_opt.init(jp), opt.init(tp)
    ref_step = jax.jit(ref_make_train_step(ref_cfg, ref_opt))
    step_fn = make_train_step(cfg, opt)
    for step in range(5):
        jp, js, jm = ref_step(jp, js, ref_make_batch(ref_cfg, shape, step), jnp.int32(step))
        tp, ts, tm = step_fn(tp, ts, make_batch(cfg, shape, step, device="cpu"), step)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), atol=1e-4)
        np.testing.assert_allclose(float(tm["aux_loss"]), float(jm["aux_loss"]), atol=1e-4)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    for a, (k, b) in zip(tree_flatten_with_path(tp).values(),
                         tree_flatten_with_path(jax.tree.map(np.asarray, jp)).items(),
                         strict=True):
        np.testing.assert_allclose(f32(a), f32(b), atol=1e-4, err_msg=k)


def test_train_step_logs_aux_loss_with_grad_accum():
    """The aux loss is a metric of the step, also when it accumulates
    microbatches (their mean)."""
    cfg, ref_cfg = small(**FP32)
    shape = configs.ShapeConfig("t", seq_len=32, global_batch=4, kind="train")
    batch = make_batch(cfg, shape, 0, device="cpu")
    auxes = []
    for half in (slice(0, 2), slice(2, 4)):
        _, m = loss.lm_loss(shared_params(ref_cfg)[1], cfg, batch["inputs"][half],
                            batch["labels"][half])
        auxes.append(float(m["aux_loss"]))
    _, tp = shared_params(ref_cfg)
    opt = optim.adamw(optim.warmup_cosine(1e-3))
    _, _, m = make_train_step(cfg, opt, grad_accum=2)(tp, opt.init(tp), batch, 0)
    np.testing.assert_allclose(float(m["aux_loss"]), np.mean(auxes), rtol=1e-6)


def test_capacity_drops_make_decode_differ_from_forward():
    """Where the forward drops entries, decode (one token a group, nothing
    dropped) differs from it, in the reference as in the port; with
    capacity_factor = E/K (C = S) the port's decode ≡ forward holds to
    2e-5.  The port's forward with drops equals the reference's."""
    cfg, ref_cfg = small(**FP32, moe=dict(capacity_factor=0.5))
    jp, tp = shared_params(ref_cfg)
    x, _ = tokens(cfg, 2, 24, seed=4)
    want, _ = ref_transformer.logits_fn(jp, ref_cfg, jnp.asarray(x))
    fwd, _ = transformer.logits_fn(tp, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(f32(fwd), f32(want), atol=2e-5)
    step = jax.jit(lambda p, c, xx, pos: ref_transformer.decode_step(p, c, ref_cfg, xx, pos))
    rc = ref_transformer.init_cache(ref_cfg, 2, 24)
    tc = transformer.init_cache(cfg, 2, 24, "cpu")
    ref_dec, dec = [], []
    for t in range(24):
        lg, rc = step(jp, rc, jnp.asarray(x[:, t:t + 1]), jnp.int32(t))
        ref_dec.append(f32(lg))
        lg, tc = transformer.decode_step(tp, tc, cfg, torch.from_numpy(x[:, t:t + 1]), t)
        dec.append(f32(lg))
    ref_dec, dec = np.concatenate(ref_dec, 1), np.concatenate(dec, 1)
    np.testing.assert_allclose(dec, ref_dec, atol=2e-5)
    assert np.abs(ref_dec - f32(want)).max() > 1e-2       # the reference's own gap
    assert np.abs(dec - f32(fwd)).max() > 1e-2
    no_drop = replace(cfg, moe=replace(cfg.moe, capacity_factor=2.0))
    full, _ = transformer.logits_fn(tp, no_drop, torch.from_numpy(x))
    np.testing.assert_allclose(dec, f32(full), atol=2e-5)


def test_launch_main_trains_olmoe_on_cpu(tmp_path, capsys):
    """``Trainer.fit`` through the CLI: three steps, the aux loss printed,
    and a checkpoint."""
    from repro_torch.ckpt import store
    from repro_torch.launch.train import main
    main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "3",
          "--seq", "64", "--batch", "2", "--ckpt-dir", str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert "steps=3 loss" in out and "aux_loss" in out
    assert store.latest_step(str(tmp_path / "ck")) == 3
