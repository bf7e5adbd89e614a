"""The port's Mamba-2 (SSD) mixer and the mamba2 model against the JAX
package, from shared weights, on the CPU.

Weights are made by the reference (``materialize`` / ``init_params``) and
handed over through ``from_reference``; inputs come from numpy with a seed.
Both routes of the port are held against the reference: the plain einsums
(``use_flash=False``) and the kernel route (``use_flash=True``: the SSD chunk
kernel's plain version for the within-chunk part, the torch recurrence across
chunks, and the rmsnorm kernel's plain version for the gated norm).  fp32
runs cast every weight to fp32 on both sides.

Tolerances: 2e-5 for fp32 values and 5e-5 for fp32 gradients (two fp32
summation orders), 1e-4 over five train steps, 5e-2 for bf16 logits.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro_torch.configs as configs
from repro.data.pipeline import make_batch as ref_make_batch
from repro.kernels import ops as ref_ops
from repro.models import layers as ref_layers
from repro.models import ssm as ref_ssm
from repro.models import transformer as ref_transformer
from repro.optim import optimizers as ref_optim
from repro.training import loss as ref_loss
from repro.training.train_step import make_train_step as ref_make_train_step
from repro_torch.convert import (from_reference, numpy_to_tensor, to_reference,
                                 tree_flatten_with_path)
from repro_torch.data.pipeline import make_batch
from repro_torch.kernels import ops
from repro_torch.models import ssm, transformer
from repro_torch.optim import optimizers as optim
from repro_torch.training import loss
from repro_torch.training.train_step import make_train_step

FP32 = dict(param_dtype="float32", compute_dtype="float32")
ROUTES = {"plain": dict(use_flash=False), "kernel": dict(use_flash=True)}


def small(chunk=None, **kw):
    """(port config, reference config): the mamba2 smoke config with the
    same overrides (``chunk`` sets the SSD chunk)."""
    out = []
    for mod in (configs, ref_configs):
        cfg = replace(mod.smoke_config("mamba2-1.3b"), **kw)
        if chunk is not None:
            cfg = replace(cfg, ssm=replace(cfg.ssm, chunk=chunk))
        out.append(cfg)
    return tuple(out)


def shared(spec_tree, seed=0, fp32=True):
    """(jax tree, torch tree) holding the same numbers."""
    jp = ref_layers.materialize(spec_tree, jax.random.PRNGKey(seed))
    if fp32:
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    return jp, from_reference(jax.tree.map(np.asarray, jp), "cpu")


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def activations(cfg, B, S, seed=2, scale=0.5):
    x = (np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)) * scale
         ).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def tokens(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
            rng.integers(0, cfg.vocab, (B, S)).astype(np.int32))


def assert_grads_close(tree, grads, ref_grads, atol):
    ref_leaves = tree_flatten_with_path(jax.tree.map(np.asarray, ref_grads))
    for (k, g), (kr, gr) in zip(zip(tree, grads, strict=True), ref_leaves.items(),
                                strict=True):
        assert k == kr
        np.testing.assert_allclose(f32(g), gr, atol=atol, err_msg=k)


# -- specs, conversion, the convolution -------------------------------------------------


def test_ssm_specs_and_conversion_carry_every_leaf():
    """Same keys, shapes and dtypes as the reference (fp32 A_log, D, conv_*,
    norm; bf16 matrices); from_reference / to_reference keep every bit."""
    cfg, ref_cfg = small()
    jp, tp = shared(ref_ssm.ssm_specs(ref_cfg), fp32=False)
    mine = tree_flatten_with_path(ssm.ssm_specs(cfg))
    assert list(mine) == list(tree_flatten_with_path(ref_ssm.ssm_specs(ref_cfg)))
    for k, t in tree_flatten_with_path(tp).items():
        assert tuple(t.shape) == mine[k].shape and str(t.dtype)[6:] == mine[k].dtype, k
    assert tp["A_log"].dtype == tp["D"].dtype == tp["conv_x"].dtype == torch.float32
    assert tp["wz"].dtype == torch.bfloat16
    back = to_reference(tp)
    for k, a in tree_flatten_with_path(jax.tree.map(np.asarray, jp)).items():
        b = tree_flatten_with_path(back)[k]
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k


@pytest.mark.parametrize("cw", [2, 4])
def test_causal_conv(cw):
    rng = np.random.default_rng(1)
    u = rng.standard_normal((2, 11, 6)).astype(np.float32)
    w = rng.standard_normal((cw, 6)).astype(np.float32)
    want = ref_ssm._causal_conv(jnp.asarray(u), jnp.asarray(w))
    got = ssm._causal_conv(torch.from_numpy(u), torch.from_numpy(w))
    np.testing.assert_allclose(f32(got), f32(want), atol=1e-6)


# -- ssd_apply -----------------------------------------------------------------------


@pytest.mark.parametrize("cw", [2, 4])
def test_causal_conv_silu_is_the_plain_code_to_the_bit(cw):
    """On the CPU the kernel route's ``ops.causal_conv_silu`` (bf16 u) is the
    plain route's ``silu(_causal_conv(u.float(), w))`` cast back, values and
    both gradients equal bit for bit."""
    rng = np.random.default_rng(5)
    u = torch.from_numpy(rng.standard_normal((2, 37, 64)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.standard_normal((cw, 64)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((2, 37, 64)).astype(np.float32)).bfloat16()
    outs = []
    for conv in (lambda a, b: ops.causal_conv_silu(a, b),
                 lambda a, b: torch.nn.functional.silu(ssm._causal_conv(a.float(), b)).to(a.dtype)):
        ua, wa = u.clone().requires_grad_(True), w.clone().requires_grad_(True)
        y = conv(ua, wa)
        outs.append((y, *torch.autograd.grad(y, (ua, wa), dy)))
    for got, want in zip(*outs, strict=True):
        assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("chunk,S", [(8, 32), (32, 64), (16, 16)])
def test_ssd_apply_matches_reference(route, chunk, S):
    """Forward 2e-5 and gradients (every parameter and the input) 5e-5."""
    cfg, ref_cfg = small(chunk, **FP32, **ROUTES[route])
    jp, tp = shared(ref_ssm.ssm_specs(ref_cfg), seed=1)
    jx, tx = activations(cfg, 2, S)
    jw, tw = activations(cfg, 2, S, seed=3)

    def f(p, x):
        return jnp.sum(ref_ssm.ssd_apply(p, x, ref_cfg) * jw)

    want = ref_ssm.ssd_apply(jp, jx, ref_cfg)
    want_g = jax.grad(f, argnums=(0, 1))(jp, jx)
    leaves = tree_flatten_with_path(tp)
    for t in [*leaves.values(), tx]:
        t.requires_grad_(True)
    got = ssm.ssd_apply(tp, tx, cfg)
    np.testing.assert_allclose(f32(got), f32(want), atol=2e-5)
    grads = torch.autograd.grad((got * tw).sum(), [*leaves.values(), tx])
    assert_grads_close(leaves, grads[:-1], want_g[0], 5e-5)
    np.testing.assert_allclose(f32(grads[-1]), f32(want_g[1]), atol=5e-5)


def test_kernel_intra_chunk_plus_torch_recurrence_is_ssd_apply():
    """Trap T5, the comparison the reference's test leaves out: the SSD chunk
    kernel's outputs, in the reference's (B·H, nc, Q, ·) layout, with the
    inter-chunk recurrence written out here in torch, rebuild the reference's
    ``ssd_apply`` — minding that the kernel's states are (N, hp) and the
    model's (hp, N).  The same inputs through the reference's own Pallas
    kernel give the same chunk outputs."""
    cfg, ref_cfg = small(8, **FP32)
    jp, tp = shared(ref_ssm.ssm_specs(ref_cfg), seed=1)
    jx, tx = activations(cfg, 2, 32)
    want = ref_ssm.ssd_apply(jp, jx, ref_cfg)

    s = cfg.ssm
    B_, S, _ = tx.shape
    nh, hp, N, Q = cfg.ssm_heads, s.headdim, s.d_state, s.chunk
    nc = S // Q
    p = tp
    z = tx @ p["wz"]
    xin = torch.nn.functional.silu(ssm._causal_conv(tx @ p["wx"], p["conv_x"]))
    bc = torch.nn.functional.silu(ssm._causal_conv(tx @ p["wbc"], p["conv_bc"]))
    Bm, Cm = bc.reshape(B_, S, 2, N).split(1, dim=2)
    dt = torch.nn.functional.softplus(tx @ p["wdt"] + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xin.reshape(B_, S, nh, hp)

    # the reference's kernel layout: (B·nh, nc, Q, ·), B/C repeated per head
    def fold(t):                        # (B,S,nh,k) -> (B·nh, nc, Q, k)
        return t.permute(0, 2, 1, 3).reshape(B_ * nh, nc, Q, t.shape[-1])

    xk = fold(xh)
    dtk = dt.permute(0, 2, 1).reshape(B_ * nh, nc, Q)
    bk = fold(Bm.expand(B_, S, nh, N))
    ck = fold(Cm.expand(B_, S, nh, N))
    ak = A.repeat(B_)
    y_in, st, cum = ops.ssd_chunk(xk, dtk, bk, ck, ak)
    ref_out = ref_ops.ssd_chunk(*(jnp.asarray(f32(t)) for t in (xk, dtk, bk, ck, ak)))
    for a, b in zip((y_in, st, cum), ref_out, strict=True):
        np.testing.assert_allclose(f32(a), f32(b), atol=2e-4, rtol=2e-5)

    st = st.reshape(B_, nh, nc, N, hp).transpose(-1, -2)          # (B,nh,nc,hp,N)
    cum = cum.reshape(B_, nh, nc, Q)
    state = torch.zeros(B_, nh, hp, N)
    y_inter = []
    for c in range(nc):
        cc = ck.reshape(B_, nh, nc, Q, N)[:, :, c]                # (B,nh,Q,N)
        y_inter.append(torch.einsum("bhqn,bhpn->bhqp", cc * torch.exp(cum[:, :, c])[..., None],
                                    state))
        state = state * torch.exp(cum[:, :, c, -1])[..., None, None] + st[:, :, c]
    y = y_in.reshape(B_, nh, nc, Q, hp) + torch.stack(y_inter, dim=2)
    y = y.reshape(B_, nh, S, hp).permute(0, 2, 1, 3) + xh * p["D"][:, None]
    y = y.reshape(B_, S, -1) * torch.nn.functional.silu(z)
    got = ops.rmsnorm(y, p["norm"], cfg.norm_eps) @ p["wo"]
    np.testing.assert_allclose(f32(got), f32(want), atol=2e-5)


@pytest.mark.parametrize("route", list(ROUTES))
def test_reference_fault_nan_grads_at_chunk_128(route):
    """The reference exponentiates exp(cum_i − cum_j) for every (i, j) and
    masks after: at chunk 128 the exponent of i < j passes ~88, and jax.grad
    gives 0·inf = NaN in A_log, dt_bias and wdt.  The port masks the exponent
    first: its gradients are finite everywhere and equal the reference's
    wherever those are finite; the forward values agree."""
    cfg, ref_cfg = small(128, **FP32, **ROUTES[route])
    jp, tp = shared(ref_ssm.ssm_specs(ref_cfg), seed=1)
    jx = jax.random.normal(jax.random.PRNGKey(2), (2, 128, cfg.d_model))
    tx = numpy_to_tensor(np.asarray(jx))

    jw, tw = activations(cfg, 2, 128, seed=3, scale=1.0)
    want = ref_ssm.ssd_apply(jp, jx, ref_cfg)
    want_g = jax.grad(lambda p: jnp.sum(ref_ssm.ssd_apply(p, jx, ref_cfg) * jw))(jp)
    bad = {k: int((~np.isfinite(np.asarray(v))).sum()) for k, v in want_g.items()}
    assert bad["A_log"] == bad["dt_bias"] == cfg.ssm_heads and bad["wdt"] > 0, bad

    leaves = tree_flatten_with_path(tp)
    for t in leaves.values():
        t.requires_grad_(True)
    got = ssm.ssd_apply(tp, tx, cfg)
    np.testing.assert_allclose(f32(got), f32(want), atol=2e-5)
    grads = torch.autograd.grad((got * tw).sum(), list(leaves.values()))
    for k, g in zip(leaves, grads, strict=True):
        g, r = f32(g), np.asarray(want_g[k])
        assert np.isfinite(g).all(), k
        ok = np.isfinite(r)
        if not ok.any():
            continue
        # 5e-5 of the leaf's largest entry: these gradients sum 256 positions
        # of 128-long chunks into entries of up to ~100 (D, conv_bc)
        atol = 5e-5 * max(1.0, float(np.abs(r[ok]).max()))
        np.testing.assert_allclose(g[ok], r[ok], atol=atol, err_msg=k)


# -- the whole model -------------------------------------------------------------------


def model_case(name):
    if name == "2L":
        return small(32, **FP32)
    if name == "2L-kernel":
        return small(32, use_flash=True, **FP32)
    # four layers, recomputed in the backward (one scanned period of 1, four times)
    return small(32, n_layers=4, remat="dots", use_flash=True, **FP32)


@pytest.mark.parametrize("name", ["2L", "2L-kernel", "4L-remat-kernel"])
def test_param_tree_matches_reference(name):
    cfg, ref_cfg = model_case(name)
    mine = transformer.init_params(cfg, 0, "cpu")
    ref = jax.tree.map(np.asarray, ref_transformer.init_params(ref_cfg, jax.random.PRNGKey(0)))
    a, b = tree_flatten_with_path(mine), tree_flatten_with_path(ref)
    assert list(a) == list(b)
    for k in a:
        assert tuple(a[k].shape) == b[k].shape and str(a[k].dtype)[6:] == str(b[k].dtype), k
    assert "mixer" in mine["scan"]["0"] and "ln2" not in mine["scan"]["0"]
    assert float(mine["scan"]["0"]["mixer"]["D"].min()) == 1.0


@pytest.mark.parametrize("name", ["2L", "2L-kernel", "4L-remat-kernel"])
def test_forward_hidden(name):
    cfg, ref_cfg = model_case(name)
    jp, tp = shared(ref_transformer.param_specs(ref_cfg))
    x, _ = tokens(cfg, 2, 64)
    want, _ = ref_transformer.forward_hidden(jp, ref_cfg, jnp.asarray(x))
    got, aux = transformer.forward_hidden(tp, cfg, torch.from_numpy(x))
    assert float(aux) == 0.0
    # after the final norm (unit scale): fp32 noise of up to four SSD layers
    np.testing.assert_allclose(f32(got), f32(want), atol=5e-5)


@pytest.mark.parametrize("name", ["2L", "2L-kernel", "4L-remat-kernel"])
def test_lm_loss_and_grads(name):
    cfg, ref_cfg = model_case(name)
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
    assert_grads_close(leaves, grads, want_g, 5e-5)


def test_logits_bf16():
    """The configured dtypes (bf16 weights and activations), plain route."""
    cfg, ref_cfg = small(32)
    jp, tp = shared(ref_transformer.param_specs(ref_cfg), fp32=False)
    x, _ = tokens(cfg, 2, 64)
    want, _ = ref_transformer.logits_fn(jp, ref_cfg, jnp.asarray(x))
    got, _ = transformer.logits_fn(tp, cfg, torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(got), f32(want), atol=5e-2)


def test_kernel_route_counts_nothing_on_the_cpu():
    cfg, ref_cfg = small(32, use_flash=True, **FP32)
    _, tp = shared(ref_transformer.param_specs(ref_cfg))
    before = dict(ops.LAUNCHES)
    transformer.forward_hidden(tp, cfg, torch.from_numpy(tokens(cfg, 1, 64)[0]))
    assert ops.LAUNCHES == before


def test_five_train_steps_match_reference():
    """From the same weights and batches, five whole steps (forward through
    the kernel route, backward, clipping, AdamW through ops.fused_adam) in
    both packages, fp32.  Loss per step and final parameters to 1e-4."""
    cfg, ref_cfg = small(32, use_flash=True, **FP32)
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


def test_launch_main_trains_mamba_on_cpu(tmp_path, capsys):
    from repro_torch.ckpt import store
    from repro_torch.launch.train import main
    main(["--arch", "mamba2-1.3b", "--smoke", "--device", "cpu", "--steps", "3",
          "--seq", "64", "--batch", "2", "--ckpt-dir", str(tmp_path / "ck")])
    assert "steps=3 loss" in capsys.readouterr().out
    assert store.latest_step(str(tmp_path / "ck")) == 3
