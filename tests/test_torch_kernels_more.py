"""The port's rmsnorm, fused_adam, ssd_chunk and causal conv against the JAX
package's, on the CPU.

The JAX side runs its Pallas kernels in interpret mode (what
``repro.kernels.ops`` does off-TPU); the port runs the plain PyTorch versions
that sit beside its CUDA kernels and state the same arithmetic.  Inputs come
from numpy with a seed and go to both.  The CUDA kernels themselves are held
against these plain versions on the card by ``chip_smoke.py``.

Tolerances are those of tests/test_kernels.py: 2e-5 fp32 and 2e-2 bf16
(abs and rel), ten times the absolute one for the SSD chunk (sums over a
whole chunk), 1e-5 for its ``cum``, 1e-6 for Adam; 5e-5 for fp32 gradients
(the rmsnorm backward's dscale: 5e-5 of its largest entry, a sum over rows).
"""

import ast
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.kernels.ssd_chunk import ssd_chunk as pallas_ssd_chunk
from repro.models import ssm as ref_ssm
from repro.optim import optimizers as ref_optim
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import numpy_to_tensor, tree_leaves
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import causal_conv as cc
from repro_torch.kernels import fused_adam as fad
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import ssd_chunk as sc
from repro_torch.models.transformer import init_params
from repro_torch.optim import optimizers as optim

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
#: bf16: largest relative 2-norm error of one row (over hp), three bf16 ulps,
#: as chip_smoke.py holds the tensor-core SSD kernel to it on the card
ROW_RTOL = 3 * 2 ** -8
CSRC = os.path.join(os.path.dirname(__file__), "..", "src", "repro_torch", "kernels", "csrc")


def rand(rng, shape, dtype="float32", scale=1.0):
    """(jax array, torch tensor) with the same values."""
    a = jnp.asarray(rng.standard_normal(shape).astype(np.float32) * scale, dtype)
    return a, numpy_to_tensor(np.asarray(a))


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


# -- rmsnorm ----------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(4, 128), (2, 33, 256), (1, 7, 5, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_matches_pallas(shape, dtype):
    rng = np.random.default_rng(4)
    jx, tx = rand(rng, shape, dtype)
    js, ts = rand(rng, (shape[-1],), scale=0.1)
    want = ref_ops.rmsnorm(jx, js)
    got = ops.rmsnorm(tx, ts)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_allclose(f32(got), f32(want), atol=TOL[dtype], rtol=TOL[dtype])
    np.testing.assert_allclose(f32(ref.rmsnorm_ref(tx, ts)), f32(ref_ref.rmsnorm_ref(jx, js)),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("shape", [(3, 5, 64), (16, 1152)])
def test_rmsnorm_function_grads_match_autograd_of_plain(shape):
    rng = np.random.default_rng(5)
    _, x = rand(rng, shape)
    _, s = rand(rng, (shape[-1],), scale=0.1)
    _, dy = rand(rng, shape)
    for t in (x, s):
        t.requires_grad_(True)
    g = torch.autograd.grad(ops.rmsnorm(x, s), (x, s), dy)
    g_ref = torch.autograd.grad(ref.rmsnorm_ref(x, s), (x, s), dy)
    for a, b in zip(g, g_ref, strict=True):
        np.testing.assert_allclose(f32(a), f32(b), atol=5e-5)


def test_rmsnorm_grads_match_jax_grad():
    """The backward (autograd of the plain version) against jax.grad of the
    reference's oracle, fp32."""
    rng = np.random.default_rng(6)
    jx, tx = rand(rng, (6, 64))
    js, ts = rand(rng, (64,), scale=0.1)
    jw, tw = rand(rng, (6, 64))
    want = jax.grad(lambda x, s: jnp.sum(ref_ref.rmsnorm_ref(x, s) * jw), argnums=(0, 1))(jx, js)
    for t in (tx, ts):
        t.requires_grad_(True)
    got = torch.autograd.grad((ops.rmsnorm(tx, ts) * tw).sum(), (tx, ts))
    for a, b in zip(got, want, strict=True):
        np.testing.assert_allclose(f32(a), f32(b), atol=5e-5)


def jax_rmsnorm_grads(jx, js, jdy):
    """(dx, dscale) of ``sum(rmsnorm_ref(x, scale) * dy)`` by jax.grad."""
    return jax.grad(lambda x, s: jnp.sum(ref_ref.rmsnorm_ref(x, s).astype(jnp.float32) * jdy),
                    argnums=(0, 1))(jx, js)


@pytest.mark.parametrize("shape", [(6, 64), (16, 1152), (4, 4096)])
def test_rmsnorm_bwd_plain_matches_jax_grad(shape):
    """The backward kernel's arithmetic (``rmsnorm_bwd_plain``) against
    jax.grad of the reference's oracle, fp32: dx to 5e-5, dscale to 5e-5 of
    its largest entry."""
    rng = np.random.default_rng(16)
    jx, tx = rand(rng, shape)
    js, ts = rand(rng, (shape[-1],), scale=0.1)
    jdy, tdy = rand(rng, shape)
    want_dx, want_ds = jax_rmsnorm_grads(jx, js, jdy)
    dx, ds = rn.rmsnorm_bwd_plain(tx, ts, tdy)
    assert dx.dtype == tx.dtype and dx.shape == tx.shape
    assert ds.dtype == torch.float32 and ds.shape == ts.shape
    np.testing.assert_allclose(f32(dx), f32(want_dx), atol=5e-5)
    np.testing.assert_allclose(f32(ds), f32(want_ds), atol=5e-5 * float(np.abs(want_ds).max()))


@pytest.mark.parametrize("shape", [(6, 64), (16, 1152), (3, 5, 2048)])
def test_rmsnorm_bwd_plain_matches_autograd_of_plain_in_bf16(shape):
    """bf16 x and dy: the stated backward against autograd of
    ``rmsnorm_plain`` (fp32 inside, one cast), dx to the bf16 tolerance and
    dscale (fp32 on both sides) to 5e-5 of its largest entry."""
    rng = np.random.default_rng(17)
    _, x = rand(rng, shape, "bfloat16")
    _, s = rand(rng, (shape[-1],), scale=0.1)
    _, dy = rand(rng, shape, "bfloat16")
    xa, sa = x.clone().requires_grad_(True), s.clone().requires_grad_(True)
    want_dx, want_ds = torch.autograd.grad(rn.rmsnorm_plain(xa, sa), (xa, sa), dy)
    dx, ds = rn.rmsnorm_bwd_plain(x, s, dy)
    assert dx.dtype == want_dx.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(dx), f32(want_dx), atol=TOL["bfloat16"], rtol=TOL["bfloat16"])
    np.testing.assert_allclose(f32(ds), f32(want_ds), atol=5e-5 * float(want_ds.abs().max()))


def test_rmsnorm_function_takes_the_plain_backward_on_cpu(monkeypatch):
    """``RMSNorm``'s backward on CPU tensors is ``rmsnorm_bwd_plain`` (the
    CUDA tensor's is the kernel), not autograd of the forward's plain
    version: its gradients are that function's to the bit."""
    rng = np.random.default_rng(18)
    _, x = rand(rng, (5, 7, 64))
    _, s = rand(rng, (64,), scale=0.1)
    _, dy = rand(rng, (5, 7, 64))
    calls = []
    plain = rn.rmsnorm_bwd_plain
    monkeypatch.setattr(rn, "rmsnorm_bwd_plain", lambda *a: calls.append(a) or plain(*a))
    xa, sa = x.clone().requires_grad_(True), s.clone().requires_grad_(True)
    got = torch.autograd.grad(ops.rmsnorm(xa, sa), (xa, sa), dy)
    assert len(calls) == 1
    for a, b in zip(got, plain(x, s, dy), strict=True):
        assert torch.equal(a, b)


def test_rmsnorm_kernel_order_differs_from_the_models_in_bf16():
    """Trap T1: the kernel multiplies by (1 + scale) in fp32 and casts once;
    ``layers.rmsnorm`` casts first.  Equal in fp32, not in bf16."""
    from repro_torch.models import layers
    rng = np.random.default_rng(7)
    _, x32 = rand(rng, (4, 9, 64))
    _, s = rand(rng, (64,), scale=0.1)
    assert torch.equal(ops.rmsnorm(x32, s), layers.rmsnorm(x32, s))
    xb = x32.to(torch.bfloat16)
    a, b = ops.rmsnorm(xb, s), layers.rmsnorm(xb, s)
    assert not torch.equal(a, b)
    np.testing.assert_allclose(f32(a), f32(b), atol=2e-2, rtol=2e-2)


# -- fused_adam ---------------------------------------------------------------------


def adam_inputs(rng, n, p_dt="float32", g_dt="float32", s_dt="float32"):
    p, g = rand(rng, (n,), p_dt), rand(rng, (n,), g_dt)
    m = rand(rng, (n,), s_dt, scale=0.1)
    v0 = np.abs(rng.standard_normal(n).astype(np.float32)) * 0.01
    v = (jnp.asarray(v0, s_dt), numpy_to_tensor(np.asarray(jnp.asarray(v0, s_dt))))
    return [t[0] for t in (p, g, m, v)], [t[1] for t in (p, g, m, v)]


@pytest.mark.parametrize("n", [2 ** 10, 3 * 2 ** 9, 2 ** 16])
@pytest.mark.parametrize("count", [1, 100])
def test_fused_adam_plain_matches_pallas(n, count):
    rng = np.random.default_rng(5)
    jl, tl = adam_inputs(rng, n)
    want = ref_ops.fused_adam(*jl, jnp.int32(count), lr=1e-3, weight_decay=0.01)
    p, g, m, v = tl
    ops.fused_adam(p, g, m, v, torch.tensor(count, dtype=torch.int32), 1e-3,
                   weight_decay=0.01)
    for a, b in zip((p, m, v), want, strict=True):
        np.testing.assert_allclose(f32(a), f32(b), atol=1e-6)


@pytest.mark.parametrize("dtypes", [("bfloat16", "bfloat16", "float32"),
                                    ("float32", "float32", "bfloat16"),
                                    ("bfloat16", "float32", "float32")])
def test_fused_adam_mixed_dtypes_match_pallas(dtypes):
    """Every store in its buffer's dtype: bf16 results are the Pallas kernel's
    to one bf16 rounding."""
    rng = np.random.default_rng(8)
    jl, tl = adam_inputs(rng, 4096, *dtypes)
    want = ref_ops.fused_adam(*jl, jnp.int32(7), lr=1e-2, weight_decay=0.01)
    p, g, m, v = tl
    ops.fused_adam(p, g, m, v, torch.tensor(7, dtype=torch.int32), 1e-2, weight_decay=0.01)
    for a, b in zip((p, m, v), want, strict=True):
        assert str(a.dtype)[6:] == str(b.dtype)
        np.testing.assert_allclose(f32(a), f32(b), atol=2e-2, rtol=2e-2)


#: leaves of several sizes (some not multiples of 8) and dtypes (p, g, m/v)
MIXED_TREE = [((64, 8), ("bfloat16", "bfloat16", "float32")), ((13,), ("float32",) * 3),
              ((3, 40), ("bfloat16", "bfloat16", "float32")), ((4096,), ("float32",) * 3),
              ((7,), ("bfloat16", "float32", "float32")), ((5, 24), ("float32", "float32",
                                                                    "bfloat16"))]


def test_fused_adam_multi_plain_is_per_leaf_plain_and_pallas():
    """The multi-tensor entry point on a mixed-dtype tree: on the CPU it is
    ``fused_adam_plain`` leaf by leaf, bit for bit, and it agrees with the
    Pallas kernel in interpret mode (1e-6 where every buffer is fp32, 2e-2
    where one is bf16)."""
    rng = np.random.default_rng(19)
    leaves = []
    for shape, dts in MIXED_TREE:
        n = int(np.prod(shape))
        jl, tl = adam_inputs(rng, n, *dts)
        leaves.append(([a.reshape(shape) for a in jl], [t.reshape(shape) for t in tl]))
    mine = [[t.clone() for t in tl] for _, tl in leaves]
    per_leaf = [[t.clone() for t in tl] for _, tl in leaves]
    count = torch.tensor(7, dtype=torch.int32)
    ops.fused_adam_multi(*zip(*mine, strict=True), count, 1e-2, weight_decay=0.01)
    for leaf in per_leaf:
        fad.fused_adam_plain(*leaf, count, 1e-2, weight_decay=0.01)
    for (jl, _), got, same in zip(leaves, mine, per_leaf, strict=True):
        want = ref_ops.fused_adam(*jl, jnp.int32(7), lr=1e-2, weight_decay=0.01)
        tol = 1e-6 if all(t.dtype == torch.float32 for t in got) else 2e-2
        for a, b, w in zip((got[0], got[2], got[3]), (same[0], same[2], same[3]), want,
                           strict=True):
            assert torch.equal(a, b)
            np.testing.assert_allclose(f32(a), f32(w), atol=tol, rtol=tol)


@pytest.mark.parametrize("arch", ["gemma3-1b", "mamba2-1.3b"])
def test_launch_groups_of_the_smoke_models_are_two(arch):
    """AdamW's leaves fall into two dtype groups, bf16 matrices with fp32
    state and fp32 vectors, each within one launch."""
    params = init_params(smoke_config(arch), 0, "cpu")
    state = optim.adamw().init(params)
    ps, ms = tree_leaves(params), tree_leaves(state["m"])
    groups = fad.launch_groups(ps, ps, ms)
    assert len(groups) == 2
    assert sorted(i for g in groups for i in g) == list(range(len(ps)))
    assert {(ps[g[0]].dtype, ms[g[0]].dtype) for g in groups} == {
        (torch.bfloat16, torch.float32), (torch.float32, torch.float32)}


def test_launch_groups_split_at_the_table_capacity():
    """More leaves of one dtype than one launch's table holds: runs of at
    most ``MAX_LEAVES`` in order; a leaf without elements takes no launch."""
    cap = fad.MAX_LEAVES
    ps = [torch.zeros(3) for _ in range(2 * cap + 5)] + [torch.zeros(0)]
    ps += [torch.zeros(2, dtype=torch.bfloat16)]
    groups = fad.launch_groups(ps, ps, ps)
    assert [len(g) for g in groups] == [cap, cap, 5, 1]
    assert sum(groups[:3], []) == list(range(2 * cap + 5)) and groups[3] == [len(ps) - 1]


def test_max_leaves_is_the_kernels():
    text = open(os.path.join(CSRC, "fused_adam.cu")).read()
    assert int(re.search(r"constexpr int MAX_LEAVES = (\d+);", text).group(1)) == fad.MAX_LEAVES


def test_fused_adam_matches_optimizer():
    """The port's AdamW (through ops.fused_adam) ≡ the reference's kernel step
    (states fp32, wd = 0.01), as tests/test_kernels.py asks of the reference."""
    rng = np.random.default_rng(6)
    (jp, tp), (jg, tg) = rand(rng, (64, 8)), rand(rng, (64, 8))
    opt = optim.adamw(lr=1e-3, weight_decay=0.01)
    st = opt.init({"w": tp})
    newp, newst = opt.update({"w": tg}, st, {"w": tp}, 0)
    kp, km, kv = ref_ops.fused_adam(jp, jg, jnp.zeros_like(jp), jnp.zeros_like(jp),
                                    jnp.int32(1), lr=1e-3, weight_decay=0.01)
    np.testing.assert_allclose(f32(newp["w"]), f32(kp), atol=1e-6)
    np.testing.assert_allclose(f32(newst["m"]["w"]), f32(km), atol=1e-6)
    np.testing.assert_allclose(f32(newst["v"]["w"]), f32(kv), atol=1e-6)
    # and the reference's own optimizer agrees with both
    ref_opt = ref_optim.adamw(lr=1e-3, weight_decay=0.01)
    rp, _ = ref_opt.update({"w": jg}, ref_opt.init({"w": jp}), {"w": jp}, 0)
    np.testing.assert_allclose(f32(newp["w"]), f32(rp["w"]), atol=1e-6)


def test_fused_adam_updates_in_place_and_reads_count_as_given():
    rng = np.random.default_rng(9)
    _, (p, g, m, v) = adam_inputs(rng, 100)
    ids = [t.data_ptr() for t in (p, m, v)]
    want = ref.fused_adam_ref(p, g, m, v, lr=1e-3, count=3)
    ops.fused_adam(p, g, m, v, torch.tensor(3, dtype=torch.int32), 1e-3)
    assert [t.data_ptr() for t in (p, m, v)] == ids
    for a, b in zip((p, m, v), want, strict=True):
        assert torch.equal(a, b)


# -- ssd_chunk ----------------------------------------------------------------------


def ssd_inputs(rng, BH, nc, Q, hp, N, dtype="float32"):
    jx, tx = rand(rng, (BH, nc, Q, hp), dtype)
    dt0 = np.abs(rng.standard_normal((BH, nc, Q)).astype(np.float32)) * 0.1
    jb, tb = rand(rng, (BH, nc, Q, N), dtype)
    jc, tc = rand(rng, (BH, nc, Q, N), dtype)
    a0 = -np.abs(rng.standard_normal(BH).astype(np.float32)) - 0.1
    j = (jx, jnp.asarray(dt0), jb, jc, jnp.asarray(a0))
    t = (tx, torch.from_numpy(dt0), tb, tc, torch.from_numpy(a0))
    return j, t


@pytest.mark.parametrize("Q,hp,N", [(64, 32, 16), (128, 64, 128), (32, 16, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunk_plain_matches_pallas(Q, hp, N, dtype):
    rng = np.random.default_rng(7)
    j, t = ssd_inputs(rng, 3, 2, Q, hp, N, dtype)
    y1, s1, c1 = ref_ops.ssd_chunk(*j)
    y2, s2, c2 = ops.ssd_chunk(*t)
    assert y2.dtype == t[0].dtype and s2.dtype == c2.dtype == torch.float32
    assert y2.shape == t[0].shape and s2.shape == (3, 2, N, hp) and c2.shape == (3, 2, Q)
    np.testing.assert_allclose(f32(y2), f32(y1), atol=TOL[dtype] * 10, rtol=TOL[dtype])
    np.testing.assert_allclose(f32(s2), f32(s1), atol=TOL[dtype] * 10, rtol=TOL[dtype])
    np.testing.assert_allclose(f32(c2), f32(c1), atol=1e-5)


@pytest.mark.parametrize("G", [1, 2])
def test_ssd_chunk_function_grads_match_autograd_of_plain(G):
    """Model layout, B/C shared by groups of heads; the Function's backward
    (on the CPU the backward kernel's plain version) against autograd of the
    forward's plain version."""
    rng = np.random.default_rng(10)
    Bt, nc, Q, H, hp, N = 2, 2, 16, 4, 8, 8
    _, x = rand(rng, (Bt, nc, Q, H, hp))
    dt = torch.from_numpy(np.abs(rng.standard_normal((Bt, nc, Q, H))).astype(np.float32) * 0.5)
    _, bc = rand(rng, (Bt, nc, Q, 2 * G, N))
    a = torch.from_numpy(-np.abs(rng.standard_normal(H)).astype(np.float32) - 0.1)
    for t_ in (x, dt, bc, a):
        t_.requires_grad_(True)
    outs = [rand(rng, s)[1] for s in ((Bt, nc, Q, H, hp), (Bt, nc, H, N, hp), (Bt, nc, Q, H))]

    def grads(fn):
        b, c = bc.split(G, dim=3)
        y = fn(x, dt, b, c, a)
        loss = sum((o * w).sum() for o, w in zip(y, outs, strict=True))
        return torch.autograd.grad(loss, (x, dt, bc, a))

    for u, w in zip(grads(ops.ssd_chunk_heads), grads(ref.ssd_intra), strict=True):
        np.testing.assert_allclose(f32(u), f32(w), atol=5e-5)


def test_ssd_chunk_grads_match_jax_grad_of_reference_oracle():
    """Short chunks (no overflow in the reference's exponent): the port's
    gradients of (y, states, cum) against jax.grad of kernels/ref.py."""
    rng = np.random.default_rng(11)
    j, t = ssd_inputs(rng, 2, 2, 16, 8, 8)
    w = [rand(rng, s) for s in ((2, 2, 16, 8), (2, 2, 8, 8), (2, 2, 16))]

    def jloss(*args):
        return sum(jnp.sum(o * ww[0]) for o, ww in zip(ref_ref.ssd_chunk_ref(*args), w,
                                                       strict=True))

    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(*j)
    for t_ in t:
        t_.requires_grad_(True)
    loss = sum((o * ww[1]).sum() for o, ww in zip(ops.ssd_chunk(*t), w, strict=True))
    got = torch.autograd.grad(loss, t)
    for a, b in zip(got, want, strict=True):
        np.testing.assert_allclose(f32(a), f32(b), atol=5e-5, rtol=1e-5)


def test_ssd_plain_has_finite_grads_where_the_exponent_overflows():
    """dt·a summed over a chunk of 256 reaches ~−180: exp(cum_i − cum_j) for
    i < j overflows fp32.  Masking the exponent first keeps every gradient
    finite; the forward is the reference oracle's."""
    rng = np.random.default_rng(12)
    j, t = ssd_inputs(rng, 2, 1, 256, 8, 8)
    dt = torch.full((2, 1, 256), 0.7)
    args = (t[0], dt, t[2], t[3], torch.tensor([-1.0, -0.5]))
    for t_ in args:
        t_.requires_grad_(True)
    y, s, c = ops.ssd_chunk(*args)
    y1, s1, c1 = ref_ref.ssd_chunk_ref(j[0], jnp.asarray(dt.detach().numpy()), j[2], j[3],
                                       jnp.asarray([-1.0, -0.5]))
    np.testing.assert_allclose(f32(y), f32(y1), atol=2e-4, rtol=2e-5)
    g = torch.autograd.grad(y.square().sum() + s.sum(), args)
    assert all(torch.isfinite(x).all() for x in g)


def ssd_model_inputs(rng, Bt, nc, Q, H, hp, G, N, dt_scale=0.5):
    """Model layout, b and c the two group halves of one ``bc`` (strided
    views, as the model slices them), and the three output gradients."""
    x = rand(rng, (Bt, nc, Q, H, hp))[1]
    dt = torch.from_numpy(np.abs(rng.standard_normal((Bt, nc, Q, H))).astype(np.float32)
                          * dt_scale)
    bc = rand(rng, (Bt, nc, Q, 2 * G, N))[1]
    a = torch.from_numpy(-np.abs(rng.standard_normal(H)).astype(np.float32) - 0.1)
    cots = [rand(rng, s)[1] for s in ((Bt, nc, Q, H, hp), (Bt, nc, H, N, hp), (Bt, nc, Q, H))]
    return (x, dt, bc, a), cots


def assert_grads_close(got, want, names):
    """5e-5, of the largest entry where that is above 1: ddt and da sum a
    chunk's rows (da also batch and chunks), the rest up to Q terms."""
    for name, u, w in zip(names, got, want, strict=True):
        u, w = f32(u), f32(w)
        atol = 5e-5 * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(u, w, atol=atol, err_msg=name)


@pytest.mark.parametrize("case", ["Q256-G1", "Q256-G2", "Q96-G2", "dy-None", "dstates-None",
                                  "dcum-None"])
def test_ssd_chunk_bwd_plain_matches_autograd_of_plain(case):
    """``ssd_chunk_bwd_plain`` (the backward kernel's arithmetic written out,
    no autograd) against ``torch.autograd.grad`` of the forward's plain
    version ``ssd_intra``: mamba2's chunk (Q 256) with small heads and
    states, one and two groups (dB and dC summed over a group's heads), a
    ragged chunk, and each output gradient ``None`` in turn (zeros)."""
    rng = np.random.default_rng(20)
    Q, G = (256, 1) if case == "Q256-G1" else (96, 2) if case == "Q96-G2" else (256, 2)
    (x, dt, bc, a), cots = ssd_model_inputs(rng, 2, 2, Q, 4, 8, G, 8)
    none = {"dy-None": 0, "dstates-None": 1, "dcum-None": 2}.get(case)
    if none is not None:
        cots[none] = None
    leaves = [t.clone().requires_grad_(True) for t in (x, dt, bc, a)]
    b, c = leaves[2].split(G, dim=3)
    outs = ref.ssd_intra(leaves[0], leaves[1], b, c, leaves[3])
    pairs = [(o, w) for o, w in zip(outs, cots, strict=True) if w is not None]
    want = torch.autograd.grad([o for o, _ in pairs], leaves, [w for _, w in pairs],
                               allow_unused=True, materialize_grads=True)
    dx, ddt, db, dc, da = sc.ssd_chunk_bwd_plain(x, dt, *bc.split(G, dim=3), a, *cots)
    assert db.is_contiguous() and dc.is_contiguous() and db.shape == (2, 2, Q, G, 8)
    assert_grads_close((dx, ddt, torch.cat((db, dc), dim=3), da), want,
                       ("dx", "ddt", "dbc", "da"))


def test_ssd_chunk_function_honours_needs_input_grad():
    """``a`` frozen: the Function's backward (``ssd_chunk_bwd`` on the CPU,
    its plain version) gives no gradient for it and the others' equal
    autograd of ``ssd_intra``; the forward's plain version runs once (the
    backward does not re-run it), the backward's plain version once, and
    nothing is launched."""
    rng = np.random.default_rng(21)
    (x, dt, bc, a), cots = ssd_model_inputs(rng, 1, 2, 64, 4, 8, 1, 16)
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = sc.ssd_chunk_plain, sc.ssd_chunk_bwd_plain

    def counted(key, fn):
        def inner(*args):
            calls[key] += 1
            return fn(*args)
        return inner

    before = dict(ops.LAUNCHES)
    leaves = [t.clone().requires_grad_(True) for t in (x, dt, bc)]
    try:
        sc.ssd_chunk_plain = counted("fwd", fwd)
        sc.ssd_chunk_bwd_plain = counted("bwd", bwd)
        outs = ops.ssd_chunk_heads(leaves[0], leaves[1], *leaves[2].split(1, dim=3), a)
        loss = sum((o * w).sum() for o, w in zip(outs, cots, strict=True))
        loss.backward()
    finally:
        sc.ssd_chunk_plain, sc.ssd_chunk_bwd_plain = fwd, bwd
    assert calls == {"fwd": 1, "bwd": 1} and a.grad is None and ops.LAUNCHES == before
    ref_leaves = [t.clone().requires_grad_(True) for t in (x, dt, bc)]
    outs = ref.ssd_intra(ref_leaves[0], ref_leaves[1], *ref_leaves[2].split(1, dim=3), a)
    want = torch.autograd.grad(sum((o * w).sum() for o, w in zip(outs, cots, strict=True)),
                               ref_leaves)
    assert_grads_close([t.grad for t in leaves], want, ("dx", "ddt", "dbc"))


def test_ssd_chunk_bwd_plain_matches_jax_grad_of_reference_oracle():
    """Q 64 (under 128, where the reference's own gradients are finite): the
    backward's plain version, through the reference's layout (views), against
    ``jax.vjp`` of ``repro.kernels.ref.ssd_chunk_ref`` with the same three
    output gradients."""
    rng = np.random.default_rng(22)
    BH, nc, Q, hp, N = 3, 2, 64, 16, 16
    j, t = ssd_inputs(rng, BH, nc, Q, hp, N)
    cj = [rand(rng, s) for s in ((BH, nc, Q, hp), (BH, nc, N, hp), (BH, nc, Q))]
    _, vjp = jax.vjp(ref_ref.ssd_chunk_ref, *j)
    want = vjp(tuple(w[0] for w in cj))
    x, dt, b, c, a = t
    dy, dS, dcum = (w[1] for w in cj)
    got = sc.ssd_chunk_bwd_plain(*ref.to_heads(x, dt, b, c), a, dy.permute(1, 2, 0, 3)[None],
                                 dS.permute(1, 0, 2, 3)[None], dcum.permute(1, 2, 0)[None])
    dx, ddt, db, dc, da = got
    back = (dx[0].permute(2, 0, 1, 3), ddt[0].permute(2, 0, 1), db[0].permute(2, 0, 1, 3),
            dc[0].permute(2, 0, 1, 3), da)
    assert_grads_close(back, want, ("dx", "ddt", "db", "dc", "da"))


def test_ssd_chunk_bwd_plain_is_finite_where_the_exponent_overflows():
    """Chunks of 128 and 256 with dt·a summing to ~−180 over the chunk: the
    backward's plain version masks the exponent before ``exp`` (as the
    kernel evaluates it only for i ≥ j), so every gradient is finite."""
    rng = np.random.default_rng(23)
    for Q in (128, 256):
        (x, dt, bc, a), cots = ssd_model_inputs(rng, 1, 1, Q, 2, 8, 1, 8)
        dt = torch.full_like(dt, 0.7)
        a = torch.tensor([-1.0, -0.5])
        grads = sc.ssd_chunk_bwd_plain(x, dt, *bc.split(1, dim=3), a, *cots)
        assert all(torch.isfinite(g).all() for g in grads), Q


def test_ssd_chunk_module_takes_no_autograd_of_the_plain_version():
    """The Function's backward is ``ssd_chunk_bwd``: the module calls
    neither ``torch.autograd.grad`` nor ``ssd_intra`` in a backward."""
    text = open(sc.__file__).read()
    assert "autograd.grad" not in text and "enable_grad" not in text
    assert "ssd_chunk_bwd(*ctx.saved_tensors" in text


def ssd_tc_arithmetic(x, dt, b, c, a):
    """The arithmetic of the bf16 SSD kernel on ``wgmma``
    (``ssd_chunk_wg_kernel``) in plain PyTorch, in the model's layout: fp32
    products of the bf16 inputs; the score ``C·Bᵀ`` times ``exp(cum_i −
    cum_j)`` (i ≥ j; below the diagonal tile the kernel takes it as a row's
    and a column's factor, both ≤ 1, which moves only fp32 roundings) and
    ``dt_j`` in fp32, rounded to bf16 once before it
    meets the exact bf16 ``x``; ``B`` times ``w = exp(cum_Q − cum)·dt`` in fp32,
    rounded to bf16 once before it meets ``x`` in the states product; y
    rounded to x's dtype at the end, states and cum fp32."""
    Bt, nc, Q, H, hp = x.shape
    rep = H // b.shape[3]
    bf = lambda t: t.to(torch.bfloat16).float()
    xf = x.float()
    bh = b.float().repeat_interleave(rep, dim=3)                 # (Bt,nc,Q,H,N)
    ch = c.float().repeat_interleave(rep, dim=3)
    cum = torch.cumsum(dt.float(), dim=2) * a                    # (Bt,nc,Q,H)
    ct = cum.transpose(2, 3)                                     # (Bt,nc,H,Q)
    tri = torch.ones((Q, Q), dtype=torch.bool).tril()
    decay = torch.exp(torch.where(tri, ct[..., :, None] - ct[..., None, :], float("-inf")))
    s = torch.einsum("bcihn,bcjhn->bchij", ch, bh)
    att = bf(s * decay * dt.transpose(2, 3)[..., None, :])
    y = torch.einsum("bchij,bcjhp->bcihp", att, xf)
    w = torch.exp(cum[:, :, -1:] - cum) * dt                     # (Bt,nc,Q,H)
    states = torch.einsum("bcjhn,bcjhp->bchnp", bf(bh * w[..., None]), xf)
    return y.to(x.dtype), states, cum


def _model_to_reference(x, dt, b, c, a):
    """The model's layout → the reference's (B·H,nc,Q,·), B/C repeated per
    head, as numpy arrays for JAX."""
    Bt, nc, Q, H, hp = x.shape
    rep = H // b.shape[3]
    per_head = lambda t, r: jnp.asarray(  # bf16 values go through fp32 exactly
        t.repeat_interleave(r, dim=3).permute(0, 3, 1, 2, 4).reshape(Bt * H, nc, Q, -1)
        .float().numpy(), str(t.dtype).removeprefix("torch."))
    return (per_head(x, 1), jnp.asarray(dt.permute(0, 3, 1, 2).reshape(Bt * H, nc, Q).numpy()),
            per_head(b, rep), per_head(c, rep), jnp.asarray(a.repeat(Bt).numpy()))


@pytest.mark.parametrize("case", ["ref:64,32,16", "ref:128,64,128", "ref:32,16,32",
                                  "model:96,16,32"])
def test_ssd_tensor_core_rounding_fits_the_bf16_tolerance(case):
    """The arithmetic stated in ``ssd_tc_arithmetic`` stays, on bf16 inputs,
    within the tolerances the card holds the tensor-core SSD kernel to of the
    Pallas kernel run in interpret mode: y and states a row within
    ``ROW_RTOL`` and elementwise within the SSD tolerance (atol 0.2, rtol
    2e-2), cum within 1e-5.  Cases: the reference's test shapes (3 heads, one
    per group, nc = 2), and the model's layout with 8 heads on 2 groups, a
    ragged last row tile (Q = 96) and dt as large as the model's at init.  It
    checks that statement of the rounding, not the port's code: the kernel
    itself is held to the same tolerances by chip_smoke.py on the card."""
    kind, dims = case.split(":")
    Q, hp, N = map(int, dims.split(","))
    rng = np.random.default_rng(15)
    if kind == "ref":
        _, (x, dt, b, c, a) = ssd_inputs(rng, 3, 2, Q, hp, N, "bfloat16")
        x, dt, b, c = ref.to_heads(x, dt, b, c)
    else:
        Bt, nc, H, G = 2, 2, 8, 2
        x = rand(rng, (Bt, nc, Q, H, hp), "bfloat16")[1]
        dt = torch.from_numpy(np.abs(rng.standard_normal((Bt, nc, Q, H))).astype(np.float32)
                              * 0.7)
        b, c = rand(rng, (Bt, nc, Q, 2 * G, N), "bfloat16")[1].split(G, dim=3)
        a = torch.from_numpy(-np.abs(rng.standard_normal(H)).astype(np.float32) - 0.1)
    y, states, cum = ssd_tc_arithmetic(x, dt, b, c, a)
    Bt, nc, _, H, _ = x.shape
    jy, jst, jcum = pallas_ssd_chunk(*_model_to_reference(x, dt, b, c, a), interpret=True)
    want = {"y": f32(jy).reshape(Bt, H, nc, Q, hp).transpose(0, 2, 3, 1, 4),
            "states": f32(jst).reshape(Bt, H, nc, N, hp).transpose(0, 2, 1, 3, 4)}
    for key, got in (("y", y), ("states", states)):
        g, w = f32(got), want[key]
        np.testing.assert_allclose(g, w, atol=10 * TOL["bfloat16"], rtol=TOL["bfloat16"])
        err = np.linalg.norm((g - w).reshape(-1, hp), axis=-1)
        assert np.all(err <= ROW_RTOL * np.linalg.norm(w.reshape(-1, hp), axis=-1)), \
            (key, err.max())
    np.testing.assert_allclose(f32(cum), f32(jcum).reshape(Bt, H, nc, Q).transpose(0, 2, 3, 1),
                               atol=1e-5)


def chip_smoke_function(name):
    """A function of chip_smoke.py, read from its source (the script exits at
    import without a GPU)."""
    with open(os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name == name:
            space = {"torch": torch}
            exec(compile(ast.Module([node], []), "chip_smoke.py", "exec"), space)
            return space[name]
    raise AssertionError(f"chip_smoke.py has no {name}")


#: db and dc as the bf16 backward kernel forms them (fp32, before its last
#: rounding): chip_smoke.py holds the kernel to it a row at a time on the card
ssd_bwd_tc_db_dc = chip_smoke_function("ssd_bwd_tc_db_dc")


@pytest.mark.parametrize("case", ["model:96,16,32,8,2,0.7", "mamba2:256,64,128,64,1,0.1"])
def test_ssd_bwd_tensor_core_rounding_fits_the_bf16_tolerance(case):
    """The rounding of ``ssd_bwd_tc_db_dc`` on bf16 inputs against the
    backward's plain version: every row of db and dc (over N) within
    ``ROW_RTOL`` of the larger of its own norm and the median row's, as
    ``chip_smoke.py`` holds the kernel on the card where this rounding fits
    that limit.  The floor is needed:
    db and dc sum ds over a group's heads, and where those terms cancel (a
    chunk's first rows see one key a head) a small row's relative error is
    the rounding's times the cancellation.  Cases: chip_smoke's small model-layout case (8 heads on 2
    groups, a ragged chunk, dt as large as at init) and one chunk at
    mamba2-1.3b's widths."""
    Q, hp, N, H, G, dt_scale = (float(v) if "." in v else int(v)
                                for v in case.split(":")[1].split(","))
    rng = np.random.default_rng(24)
    (x, dt, bc, a), (dy, dS, dcum) = ssd_model_inputs(rng, 1, 2 if Q < 256 else 1, Q, H, hp,
                                                      G, N, dt_scale)
    x, bc, dy = x.bfloat16(), bc.bfloat16(), dy.bfloat16()
    b, c = bc.split(G, dim=3)
    _, _, db_want, dc_want, _ = sc.ssd_chunk_bwd_plain(x, dt, b, c, a, dy, dS, dcum)
    for name, got, want in zip(("db", "dc"), ssd_bwd_tc_db_dc(x, dt, b, c, a, dy, dS),
                               (db_want, dc_want), strict=True):
        g, w = f32(got.to(b.dtype)).reshape(-1, N), f32(want).reshape(-1, N)
        err, norm = np.linalg.norm(g - w, axis=-1), np.linalg.norm(w, axis=-1)
        assert np.all(err <= ROW_RTOL * np.maximum(norm, np.median(norm))), (name, err.max())


# -- causal_conv ----------------------------------------------------------------------


def conv_inputs(rng, shape, cw, dtype):
    """u (B,S,C) in ``dtype``, w (cw,C) fp32 and dy like u."""
    u = rand(rng, shape)[1].to(getattr(torch, dtype))
    return u, rand(rng, (cw, shape[2]), scale=0.5)[1], rand(rng, shape)[1].to(u.dtype)


@pytest.mark.parametrize("cw", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_bwd_plain_is_autograd_of_the_plain_forward(cw, dtype):
    """``causal_conv_bwd_plain`` writes out autograd's backward of
    ``causal_conv_plain``: du and dw equal it bit for bit, with a sequence
    shorter than the taps and one longer."""
    rng = np.random.default_rng(19 + cw)
    for shape in ((2, 3, 16), (3, 37, 64)):
        u, w, dy = conv_inputs(rng, shape, cw, dtype)
        ua, wa = u.clone().requires_grad_(True), w.clone().requires_grad_(True)
        want = torch.autograd.grad(cc.causal_conv_plain(ua, wa), (ua, wa), dy)
        for a, b in zip(cc.causal_conv_bwd_plain(u, w, dy), want, strict=True):
            assert a.dtype == b.dtype and torch.equal(a, b), shape


@pytest.mark.parametrize("cw", [2, 4])
def test_causal_conv_plain_matches_the_reference_conv(cw):
    """fp32: the plain version against silu of the reference's
    ``_causal_conv`` (jnp), values and gradients."""
    rng = np.random.default_rng(23)
    ju, u = rand(rng, (2, 19, 24))
    jw, w = rand(rng, (cw, 24), scale=0.5)
    jdy, dy = rand(rng, (2, 19, 24))
    f = lambda a, b: jax.nn.silu(ref_ssm._causal_conv(a, b))
    want, vjp = jax.vjp(f, ju, jw)
    np.testing.assert_allclose(f32(cc.causal_conv_plain(u, w)), f32(want), atol=TOL["float32"])
    for got, ref_grad in zip(cc.causal_conv_bwd_plain(u, w, dy), vjp(jdy), strict=True):
        np.testing.assert_allclose(f32(got), f32(ref_grad), atol=5e-5, rtol=5e-5)


def test_causal_conv_function_takes_the_plain_backward_on_cpu(monkeypatch):
    """``CausalConvSilu``'s backward on CPU tensors is
    ``causal_conv_bwd_plain`` from the saved u and w (the CUDA tensor's is
    the kernel), and honours ``needs_input_grad``."""
    rng = np.random.default_rng(21)
    u, w, dy = conv_inputs(rng, (2, 11, 32), 4, "bfloat16")
    calls = []
    plain = cc.causal_conv_bwd_plain
    monkeypatch.setattr(cc, "causal_conv_bwd_plain", lambda *a: calls.append(a) or plain(*a))
    ua, wa = u.clone().requires_grad_(True), w.clone().requires_grad_(True)
    got = torch.autograd.grad(ops.causal_conv_silu(ua, wa), (ua, wa), dy)
    assert len(calls) == 1 and torch.equal(calls[0][0], u) and torch.equal(calls[0][1], w)
    for a, b in zip(got, plain(u, w, dy), strict=True):
        assert torch.equal(a, b)
    (du,) = torch.autograd.grad(ops.causal_conv_silu(ua, w), (ua,), dy)
    assert torch.equal(du, got[0])


def test_causal_conv_on_meta_gives_shapes_and_dtypes():
    """A ``meta`` call takes the plain versions: y and du in u's dtype and
    shape, dw fp32 in w's, nothing launched."""
    before = dict(ops.LAUNCHES)
    u = torch.empty((4, 4096, 256), dtype=torch.bfloat16, device="meta", requires_grad=True)
    w = torch.empty((4, 256), device="meta", requires_grad=True)
    y = ops.causal_conv_silu(u, w)
    assert y.device.type == "meta" and y.dtype == torch.bfloat16 and y.shape == u.shape
    du, dw = torch.autograd.grad(y, (u, w), torch.empty_like(y))
    assert (du.dtype, du.shape) == (torch.bfloat16, u.shape)
    assert (dw.dtype, dw.shape) == (torch.float32, w.shape)
    assert ops.LAUNCHES == before


def test_causal_conv_geometry_at_mamba2():
    """On an H100's 132 SMs at mamba2-1.3b's shapes: x (4 × 4096 × 4096)
    walks runs of 64 positions (1,024 blocks of 128 channels, 32 partials of
    dw a column), B/C (256 channels) runs of 8; the runs of a grid cover
    every position of every sequence and the channel blocks every channel."""
    assert cc.geometry(4, 4096, 4096, 132) == {"run": 64, "grid": (32, 8, 4), "parts": 32}
    assert cc.geometry(4, 4096, 256, 132) == {"run": 8, "grid": (2, 64, 4), "parts": 256}
    for B, S, C in ((1, 1, 8), (3, 1000, 200), (2, 77, 16384)):
        geo = cc.geometry(B, S, C, 132)
        gx, gy, gz = geo["grid"]
        assert gz == B and geo["parts"] == B * gy and geo["run"] in cc.RUNS
        assert (gy - 1) * cc.WARPS * geo["run"] < S <= gy * cc.WARPS * geo["run"]
        assert (gx - 1) * cc.LANES * cc.CHANNELS < C <= gx * cc.LANES * cc.CHANNELS


# -- the bf16 kernels' launch geometry ----------------------------------------------------

SLICE_CASES = [(64, 1), (8, 2), (6, 3), (48, 2), (17, 1), (96, 4), (4, 4)]


@pytest.mark.parametrize("H,G,kernel", [(H, G, k) for k in ("bwd", "fwd") for H, G in SLICE_CASES],
                         ids=[f"{k}-{H}-{G}".removeprefix("bwd-") for k in ("bwd", "fwd")
                              for H, G in SLICE_CASES])
def test_ssd_bwd_slices_cover_every_head_once_in_order(H, G, kernel):
    """The slices of ``ssd_bwd_geometry`` (the bf16 backward sums dB and dC
    over each in its block) and of ``ssd_fwd_geometry`` (the bf16 forward
    holds B and C, and forms the scores, once for each) are runs of
    consecutive heads of one group, at most ``SLICE_HEADS`` long, all of one
    length R that divides the group, and together every head exactly once,
    in order.  The backward has one block a slice and row tile; the forward
    one a slice and role: the states, then y of each row tile, the last
    first."""
    Q = 96
    geometry = sc.ssd_bwd_geometry if kernel == "bwd" else sc.ssd_fwd_geometry
    geo = geometry(2, 3, Q, H, G, 64, 128)
    R, rep = geo["slice_heads"], H // G
    assert [h for s in geo["slices"] for h in s] == list(range(H))
    assert all(len(s) == R and len({h // rep for h in s}) == 1 for s in geo["slices"])
    assert rep % R == 0 and R <= sc.SLICE_HEADS
    assert R == max(r for r in range(1, sc.SLICE_HEADS + 1) if rep % r == 0)
    if kernel == "bwd":
        assert geo["tiles"] == 2 and geo["blocks"] == 2 * 3 * len(geo["slices"]) * 2
        assert geo["scratch"]["pdb"] == geo["scratch"]["pdc"] == 2 * 3 * (H // R) * Q * 128
    else:
        assert geo["tiles"] == 2 and geo["roles"] == [("states", None), ("y", 1), ("y", 0)]
        assert geo["blocks"] == 2 * 3 * len(geo["slices"]) * 3
        assert geo["slice_heads"] == sc.ssd_bwd_geometry(2, 3, Q, H, G, 64, 128)["slice_heads"]


def test_ssd_bwd_scratch_at_mamba2_is_an_eighth_of_the_per_head_partials():
    """At mamba2-1.3b's training shape (batch 4 x 4096, chunk 256, 64 heads
    of 64, one group, d_state 128) the bf16 backward's scratch is at most an
    eighth of the 1.07 GB of per-head fp32 partials (which the fp32 kernel
    keeps: one (Q, N) partial of dB and of dC a head)."""
    cfg = get_config("mamba2-1.3b")
    s = cfg.ssm
    shape = (4, 4096 // s.chunk, s.chunk, cfg.ssm_heads, s.n_groups, s.headdim, s.d_state)
    assert shape == (4, 16, 256, 64, 1, 64, 128)
    per_head = 2 * 4 * 16 * 64 * 256 * 128 * 4
    fp32 = sc.ssd_bwd_geometry(*shape, bf16=False)
    assert fp32["scratch_bytes"] == per_head + 4 * 16 * 64 * 4
    geo = sc.ssd_bwd_geometry(*shape)
    assert geo["slice_heads"] == 16 and geo["blocks"] == 4 * 16 * 4 * 4
    assert geo["scratch_bytes"] <= per_head / 8


OUTSIDE = [(64, 8, 3, 64, 128), (64, 8, 0, 64, 128), (64, 8, 2, 128, 128), (64, 8, 2, 48, 128),
           (64, 8, 2, 64, 256), (64, 8, 2, 64, 96), (0, 8, 2, 64, 128), (257, 8, 2, 64, 128)]


@pytest.mark.parametrize("Q,H,G,hp,N,kernel", [(*d, k) for k in ("bwd", "fwd") for d in OUTSIDE],
                         ids=["-".join(map(str, (k, *d))).removeprefix("bwd-")
                              for k in ("bwd", "fwd") for d in OUTSIDE])
def test_ssd_bwd_geometry_raises_outside_the_instantiations(Q, H, G, hp, N, kernel):
    geometry = sc.ssd_bwd_geometry if kernel == "bwd" else sc.ssd_fwd_geometry
    with pytest.raises(ValueError):
        geometry(1, 1, Q, H, G, hp, N)


def test_ssd_fwd_geometry_at_mamba2():
    """At mamba2-1.3b's training shape the bf16 forward runs 4 slices of 16
    heads a chunk, each in 5 blocks (the states, y of 4 row tiles), 1,280 in
    all."""
    geo = sc.ssd_fwd_geometry(4, 16, 256, 64, 1, 64, 128)
    assert geo["slice_heads"] == 16 and len(geo["slices"]) == 4
    assert geo["roles"] == [("states", None), ("y", 3), ("y", 2), ("y", 1), ("y", 0)]
    assert geo["blocks"] == 4 * 16 * 4 * 5 == 1280


# -- dispatch, counters, sources ----------------------------------------------------------


def test_cpu_tensors_take_the_plain_path_and_count_nothing():
    before = dict(ops.LAUNCHES)
    rng = np.random.default_rng(13)
    _, x = rand(rng, (4, 64))
    ops.rmsnorm(x, torch.zeros(64))
    _, (p, g, m, v) = adam_inputs(rng, 64)
    ops.fused_adam(p, g, m, v, torch.tensor(1, dtype=torch.int32), 1e-3)
    ops.fused_adam_multi([p, m], [g, v], [m.clone(), m.clone()], [v.clone(), v.clone()],
                         torch.tensor(2, dtype=torch.int32), 1e-3)
    ops.ssd_chunk(*ssd_inputs(rng, 2, 1, 32, 16, 16)[1])
    xg = x.clone().requires_grad_(True)
    ops.rmsnorm(xg, torch.zeros(64)).sum().backward()
    ug = rand(rng, (2, 9, 16))[1].bfloat16().requires_grad_(True)
    ops.causal_conv_silu(ug, torch.ones(4, 16)).float().sum().backward()
    assert ops.LAUNCHES == before


def test_six_kernels_are_built_counted_and_documented():
    """The six ported kernels and the causal conv, which replaces no TPU
    kernel (the reference's conv is jnp that XLA fuses) and says so."""
    assert build.SOURCES == ("flash_fwd", "flash_dq", "flash_dkv", "rmsnorm", "fused_adam",
                             "ssd_chunk", "causal_conv")
    # every source's entry point, the rmsnorm backward in rmsnorm.cu, the
    # SSD chunk's backward in ssd_chunk.cu and the conv's in causal_conv.cu
    assert build.ENTRY_POINTS == {**{n: n for n in build.SOURCES}, "rmsnorm_bwd": "rmsnorm",
                                  "ssd_chunk_bwd": "ssd_chunk",
                                  "causal_conv_bwd": "causal_conv"}
    assert list(ops.LAUNCHES) == list(build.ENTRY_POINTS) and ops.LAUNCHES is build.LAUNCHES
    for entry, source in build.ENTRY_POINTS.items():
        assert f'extern "C" int {entry}(' in open(os.path.join(CSRC, f"{source}.cu")).read()
    tpu = {"flash_fwd": "_fwd_kernel", "flash_dq": "flash_attention.py",
           "flash_dkv": "flash_attention.py", "rmsnorm": "_rmsnorm_kernel",
           "fused_adam": "_adam_kernel", "ssd_chunk": "_ssd_chunk_kernel",
           "causal_conv": "_causal_conv"}
    for name in build.SOURCES:
        head = open(os.path.join(CSRC, f"{name}.cu")).read(4000)
        replaces = "Replaces no Pallas TPU kernel" if name == "causal_conv" else \
            "Replaces the Pallas TPU kernel"
        assert replaces in head and tpu[name] in head, name
        assert "What bounds it on this card" in head, name
        assert f'extern "C" int {name}(' in open(os.path.join(CSRC, f"{name}.cu")).read()


def _bad_input(kind):
    rng = np.random.default_rng(14)
    if kind == "rmsnorm_cpu":
        return rn.rmsnorm_cuda, (rand(rng, (4, 64))[1], torch.zeros(64)), ValueError
    if kind == "rmsnorm_width":
        return rn.rmsnorm_cuda, (rand(rng, (4, 60))[1], torch.zeros(60)), ValueError
    if kind == "rmsnorm_dtype":
        x = rand(rng, (4, 64))[1].half()
        return rn.rmsnorm_cuda, (x, torch.zeros(64)), TypeError
    if kind == "adam_cpu":
        _, leaf = adam_inputs(rng, 64)
        leaves = tuple([t] for t in leaf)
        return (fad.fused_adam_multi_cuda, (*leaves, torch.tensor(1, dtype=torch.int32), 1e-3),
                ValueError)
    if kind == "adam_dtype":
        _, (p, g, m, v) = adam_inputs(rng, 64)
        return (fad.fused_adam_multi_cuda, ([p.half()], [g], [m], [v],
                                            torch.tensor(1, dtype=torch.int32), 1e-3), TypeError)
    if kind.startswith("rmsnorm_bwd"):
        x, dy = rand(rng, (4, 64))[1], rand(rng, (4, 64))[1]
        if kind == "rmsnorm_bwd_cpu":
            return rn.rmsnorm_bwd_cuda, (x, torch.zeros(64), dy), ValueError
        if kind == "rmsnorm_bwd_dy_dtype":
            return rn.rmsnorm_bwd_cuda, (x, torch.zeros(64), dy.bfloat16()), TypeError
        if kind == "rmsnorm_bwd_dy_shape":
            return rn.rmsnorm_bwd_cuda, (x, torch.zeros(64), dy[:2]), ValueError
        raise KeyError(kind)
    if kind.startswith("adam_multi"):
        leaves = [adam_inputs(rng, n)[1] for n in (64, 13)]
        if kind == "adam_multi_misaligned":
            # contiguous, but starting one element past a 16-byte boundary
            p = leaves[1][0]
            leaves[1][0] = torch.empty(p.numel() + 1)[1:].copy_(p)
            match = "16-byte"
        elif kind == "adam_multi_mv_dtypes":
            leaves[1][3] = leaves[1][3].bfloat16()
        elif kind == "adam_multi_cpu":
            match = "CUDA device"
        else:
            raise KeyError(kind)
        args = (*zip(*leaves, strict=True), torch.tensor(1, dtype=torch.int32), 1e-3)
        if kind == "adam_multi_mv_dtypes":
            return fad.fused_adam_multi_cuda, args, TypeError
        return fad.fused_adam_multi_cuda, args, ValueError, match
    if kind.startswith("conv"):
        u, w = rand(rng, (2, 9, 16))[1].bfloat16(), torch.ones(4, 16)
        if kind == "conv_cpu":
            return cc.causal_conv_cuda, (u, w), ValueError
        if kind == "conv_channels":
            return cc.causal_conv_cuda, (u[..., :12].contiguous(), w[:, :12].contiguous()), \
                ValueError
        if kind == "conv_taps":
            return cc.causal_conv_cuda, (u, torch.ones(5, 16)), ValueError
        if kind == "conv_dtype":
            return cc.causal_conv_cuda, (u.half(), w), TypeError
        if kind == "conv_w_dtype":
            return cc.causal_conv_cuda, (u, w.bfloat16()), TypeError
        if kind == "conv_last_dim":
            return cc.causal_conv_cuda, (u.transpose(1, 2).contiguous().transpose(1, 2), w), \
                ValueError, "last dim must be contiguous"
        if kind == "conv_bwd_cpu":
            return cc.causal_conv_bwd_cuda, (u, w, u.clone()), ValueError
        if kind == "conv_bwd_dy_dtype":
            return cc.causal_conv_bwd_cuda, (u, w, u.float()), TypeError
        raise KeyError(kind)
    _, (x, dt, b, c, a) = ssd_inputs(rng, 2, 1, 32, 16, 16)
    heads = (*ref.to_heads(x, dt, b, c), a)
    if kind.startswith("ssd_bwd"):
        cots = [torch.zeros(s) for s in ((1, 1, 32, 2, 16), (1, 1, 2, 16, 16), (1, 1, 32, 2))]
        if kind == "ssd_bwd_cpu":
            return sc.ssd_chunk_bwd_cuda, (*heads, *cots), ValueError
        if kind == "ssd_bwd_head_dim":
            _, (x, dt, b, c, a) = ssd_inputs(rng, 2, 1, 32, 8, 16)
            return sc.ssd_chunk_bwd_cuda, (*ref.to_heads(x, dt, b, c), a, None, None, None), \
                ValueError
        if kind == "ssd_bwd_dy_dtype":
            x, dt, b, c = (t.to(torch.bfloat16) if t.dim() == 5 else t
                           for t in ref.to_heads(x, dt, b, c))
            x, b, c = (t.clone(memory_format=torch.contiguous_format) for t in (x, b, c))
            return sc.ssd_chunk_bwd_cuda, (x, dt, b, c, a, *cots), TypeError
        raise KeyError(kind)
    if kind == "ssd_cpu":
        return sc.ssd_chunk_cuda, heads, ValueError
    if kind == "ssd_head_dim":
        _, (x, dt, b, c, a) = ssd_inputs(rng, 2, 1, 32, 8, 16)
        return sc.ssd_chunk_cuda, (*ref.to_heads(x, dt, b, c), a), ValueError
    if kind == "ssd_chunk_len":
        _, (x, dt, b, c, a) = ssd_inputs(rng, 2, 1, 512, 16, 16)
        return sc.ssd_chunk_cuda, (*ref.to_heads(x, dt, b, c), a), ValueError
    # bf16 rows go in by 16-byte cp.async: 8-element alignment
    x, dt, b, c, a = (t.to(torch.bfloat16) if t.dtype == torch.float32 and t.dim() == 5 else t
                      for t in heads)
    if kind == "ssd_bf16_misaligned":
        # contiguous, but starting one element past a 16-byte boundary
        x = torch.empty(x.numel() + 1, dtype=x.dtype)[1:].view(x.shape).copy_(x)
    elif kind == "ssd_bf16_row_stride":
        # rows 20 elements apart: aligned to 4 elements (enough in fp32), not 8
        x = torch.zeros((*x.shape[:-1], x.shape[-1] + 4), dtype=x.dtype)[..., :x.shape[-1]]
        assert x.stride(3) % 4 == 0 and x.stride(3) % 8
    else:
        raise KeyError(kind)
    return sc.ssd_chunk_cuda, (x, dt, b, c, a), ValueError, "aligned to 8 elements"


@pytest.mark.parametrize("kind", ["rmsnorm_cpu", "rmsnorm_width", "rmsnorm_dtype", "adam_cpu",
                                  "adam_dtype", "ssd_cpu", "ssd_head_dim", "ssd_chunk_len",
                                  "ssd_bf16_misaligned", "ssd_bf16_row_stride",
                                  "rmsnorm_bwd_cpu", "rmsnorm_bwd_dy_dtype",
                                  "rmsnorm_bwd_dy_shape", "adam_multi_cpu",
                                  "adam_multi_misaligned", "adam_multi_mv_dtypes",
                                  "ssd_bwd_cpu", "ssd_bwd_head_dim", "ssd_bwd_dy_dtype",
                                  "conv_cpu", "conv_channels", "conv_taps", "conv_dtype",
                                  "conv_w_dtype", "conv_last_dim", "conv_bwd_cpu",
                                  "conv_bwd_dy_dtype"])
def test_cuda_wrappers_raise_on_what_the_kernels_do_not_take(kind):
    """The CUDA wrappers never compute anything for inputs outside the
    kernels' contract (CPU tensors included), and never fall back.  The bf16
    SSD cases, the misaligned Adam leaf and the causal conv's channel count,
    taps, dtypes and last dim raise on the contract itself, before the device
    is looked at."""
    fn, args, exc, *match = _bad_input(kind)
    before = dict(ops.LAUNCHES)
    with pytest.raises(exc, match=match[0] if match else None):
        fn(*args)
    assert ops.LAUNCHES == before


def test_port_never_calls_the_library_yardsticks():
    """chip_smoke.py times F.rms_norm, torch._fused_adamw_ and F.conv1d
    beside the kernels; the port itself never calls them."""
    root = os.path.join(os.path.dirname(__file__), "..", "src", "repro_torch")
    for d, _, fs in os.walk(root):
        for f in fs:
            if f.endswith((".py", ".cu", ".cuh")):
                text = open(os.path.join(d, f)).read()
                for call in ("rms_norm(", "_fused_adamw", "optim.AdamW", "torch.compile",
                             "conv1d("):
                    assert call not in text, (f, call)
