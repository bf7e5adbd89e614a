"""The port's rmsnorm, fused_adam and ssd_chunk against the JAX package's, on
the CPU.

The JAX side runs its Pallas kernels in interpret mode (what
``repro.kernels.ops`` does off-TPU); the port runs the plain PyTorch versions
that sit beside its CUDA kernels and state the same arithmetic.  Inputs come
from numpy with a seed and go to both.  The CUDA kernels themselves are held
against these plain versions on the card by ``chip_smoke.py``.

Tolerances are those of tests/test_kernels.py: 2e-5 fp32 and 2e-2 bf16
(abs and rel), ten times the absolute one for the SSD chunk (sums over a
whole chunk), 1e-5 for its ``cum``, 1e-6 for Adam; 5e-5 for fp32 gradients.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.kernels.ssd_chunk import ssd_chunk as pallas_ssd_chunk
from repro.optim import optimizers as ref_optim
from repro_torch.convert import numpy_to_tensor
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import fused_adam as fad
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import ssd_chunk as sc
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
    """Model layout, B/C shared by groups of heads; the Function's backward is
    autograd of the plain version."""
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


def ssd_tc_arithmetic(x, dt, b, c, a):
    """The arithmetic of the bf16 tensor-core SSD kernel
    (``ssd_chunk_tc_kernel``) in plain PyTorch, in the model's layout: fp32
    products of the bf16 inputs; the score ``C·Bᵀ`` times ``exp(cum_i −
    cum_j)`` (i ≥ j) and ``dt_j`` in fp32, rounded to bf16 once before it
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


# -- dispatch, counters, sources ----------------------------------------------------------


def test_cpu_tensors_take_the_plain_path_and_count_nothing():
    before = dict(ops.LAUNCHES)
    rng = np.random.default_rng(13)
    _, x = rand(rng, (4, 64))
    ops.rmsnorm(x, torch.zeros(64))
    _, (p, g, m, v) = adam_inputs(rng, 64)
    ops.fused_adam(p, g, m, v, torch.tensor(1, dtype=torch.int32), 1e-3)
    ops.ssd_chunk(*ssd_inputs(rng, 2, 1, 32, 16, 16)[1])
    assert ops.LAUNCHES == before


def test_six_kernels_are_built_counted_and_documented():
    assert build.SOURCES == ("flash_fwd", "flash_dq", "flash_dkv", "rmsnorm", "fused_adam",
                             "ssd_chunk")
    assert list(ops.LAUNCHES) == list(build.SOURCES) and ops.LAUNCHES is build.LAUNCHES
    tpu = {"flash_fwd": "_fwd_kernel", "flash_dq": "flash_attention.py",
           "flash_dkv": "flash_attention.py", "rmsnorm": "_rmsnorm_kernel",
           "fused_adam": "_adam_kernel", "ssd_chunk": "_ssd_chunk_kernel"}
    for name in build.SOURCES:
        head = open(os.path.join(CSRC, f"{name}.cu")).read(4000)
        assert "Replaces the Pallas TPU kernel" in head and tpu[name] in head, name
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
        return fad.fused_adam_cuda, (*leaf, torch.tensor(1, dtype=torch.int32), 1e-3), ValueError
    if kind == "adam_dtype":
        _, (p, g, m, v) = adam_inputs(rng, 64)
        return (fad.fused_adam_cuda, (p.half(), g, m, v, torch.tensor(1, dtype=torch.int32),
                                      1e-3), TypeError)
    _, (x, dt, b, c, a) = ssd_inputs(rng, 2, 1, 32, 16, 16)
    heads = (*ref.to_heads(x, dt, b, c), a)
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
                                  "ssd_bf16_misaligned", "ssd_bf16_row_stride"])
def test_cuda_wrappers_raise_on_what_the_kernels_do_not_take(kind):
    """The CUDA wrappers never compute anything for inputs outside the
    kernels' contract (CPU tensors included), and never fall back.  The bf16
    SSD cases raise on the alignment itself, before the device is looked at."""
    fn, args, exc, *match = _bad_input(kind)
    before = dict(ops.LAUNCHES)
    with pytest.raises(exc, match=match[0] if match else None):
        fn(*args)
    assert ops.LAUNCHES == before


def test_port_never_calls_the_library_yardsticks():
    """chip_smoke.py times F.rms_norm and torch._fused_adamw_ beside the
    kernels; the port itself never calls them."""
    root = os.path.join(os.path.dirname(__file__), "..", "src", "repro_torch")
    for d, _, fs in os.walk(root):
        for f in fs:
            if f.endswith((".py", ".cu", ".cuh")):
                text = open(os.path.join(d, f)).read()
                for call in ("rms_norm(", "_fused_adamw", "optim.AdamW", "torch.compile"):
                    assert call not in text, (f, call)
