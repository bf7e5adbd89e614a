"""The port's flash attention against the JAX package's, on the CPU.

The JAX side runs its Pallas kernels in interpret mode (what
``repro.kernels.ops`` does off-TPU); the port runs the plain PyTorch versions
that sit beside its CUDA kernels and state the same arithmetic.  Inputs come
from numpy with a seed and go to both.

Tolerances are those of tests/test_kernels.py: fp32 2e-5 forward and 5e-5
gradients (two fp32 summation orders over at most 256 keys), bf16 2e-2 (one
rounding of the output to 8 bits of mantissa).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro_torch.convert import numpy_to_tensor
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def inputs(seed, B, S, T, H, Kv, hd, dtype="float32"):
    """(jax arrays, torch tensors) q, k, v, do with the same values."""
    rng = np.random.default_rng(seed)
    shapes = [(B, S, H, hd), (B, T, Kv, hd), (B, T, Kv, hd), (B, S, H, hd)]
    js = [jnp.asarray(rng.standard_normal(s).astype(np.float32), dtype) for s in shapes]
    ts = [numpy_to_tensor(np.asarray(a)) for a in js]
    return js, ts


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("S,T", [(128, 128), (128, 256)])
@pytest.mark.parametrize("H,Kv", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_fwd_matches_pallas(S, T, H, Kv, dtype):
    B, hd = 2, 32
    (jq, jk, jv, _), (q, k, v, _) = inputs(0, B, S, T, H, Kv, hd, dtype)
    o_ref, lse_ref = ref_ops._flash_fwd_impl(jq, jk, jv, True, None, 64, 64, None)
    o, lse = ops.flash_fwd(q, k, v, True, None)
    assert o.dtype == q.dtype and lse.dtype == torch.float32
    np.testing.assert_allclose(f32(o), f32(o_ref), atol=TOL[dtype], rtol=TOL[dtype])
    # lse is fp32 on both sides whatever the input type; (B·H, S) there, (B,H,S) here
    np.testing.assert_allclose(f32(lse).reshape(B * H, S), f32(lse_ref),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("window", [16, 64, None])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_fwd_window_and_noncausal(window, causal):
    (jq, jk, jv, _), (q, k, v, _) = inputs(1, 1, 128, 128, 2, 2, 32)
    o_ref = ref_ops.flash_attention(jq, jk, jv, causal, window, 32, 32)
    o, _ = ops.flash_fwd(q, k, v, causal, window)
    np.testing.assert_allclose(f32(o), f32(o_ref), atol=2e-5)
    np.testing.assert_allclose(f32(ref.flash_attention_ref(q, k, v, causal, window)),
                               f32(o_ref), atol=2e-5)


@pytest.mark.parametrize("H,Kv,S,T,window", [(4, 4, 128, 128, None), (4, 1, 128, 128, None),
                                             (4, 2, 128, 256, None), (4, 1, 128, 128, 16)])
def test_plain_bwd_matches_jax_grad(H, Kv, S, T, window):
    """dq, dk, dv of the explicit recompute formulas vs jax.grad through the
    Pallas custom-vjp, for the same cotangent."""
    (jq, jk, jv, _), (q, k, v, _) = inputs(2, 1, S, T, H, Kv, 32)

    def f(q, k, v):
        return jnp.sum(jnp.tanh(ref_ops.flash_attention(q, k, v, True, window, 64, 64)))

    g_ref = jax.grad(f, argnums=(0, 1, 2))(jq, jk, jv)
    for t in (q, k, v):
        t.requires_grad_(True)
    loss = torch.tanh(ops.flash_attention(q, k, v, True, window)).sum()
    g = torch.autograd.grad(loss, (q, k, v))
    for a, b in zip(g, g_ref, strict=True):
        np.testing.assert_allclose(f32(a), f32(b), atol=5e-5)


@pytest.mark.parametrize("dtype,tol", [("float32", 5e-5), ("bfloat16", 2e-2)])
def test_plain_bwd_functions_match_pallas_bwd(dtype, tol):
    """The three wrappers one by one, fed the reference's residuals."""
    B, S, T, H, Kv, hd = 1, 128, 256, 4, 2, 32
    (jq, jk, jv, jdo), (q, k, v, do) = inputs(3, B, S, T, H, Kv, hd, dtype)
    o, lse = ops.flash_fwd(q, k, v, True, None)
    delta = ops.attention_delta(o, do)
    assert delta.shape == (B, H, S) and delta.dtype == torch.float32
    dq = ops.flash_dq(q, k, v, do, lse, delta, True, None)
    dk, dv = ops.flash_dkv(q, k, v, do, lse, delta, True, None)
    assert dq.dtype == q.dtype and dk.dtype == k.dtype and dv.shape == v.shape
    _, vjp = jax.vjp(lambda a, b, c: ref_ops.flash_attention(a, b, c, True, None, 64, 64),
                     jq, jk, jv)
    for a, b in zip((dq, dk, dv), vjp(jdo), strict=True):
        np.testing.assert_allclose(f32(a), f32(b), atol=tol, rtol=tol)


@pytest.mark.parametrize("H,Kv,S,T,causal,window", [
    (4, 4, 128, 128, True, None), (4, 1, 128, 256, True, None),
    (2, 1, 64, 64, False, None), (4, 2, 128, 128, True, 16), (2, 2, 64, 128, False, 8)])
def test_autograd_function_matches_autograd_of_oracle(H, Kv, S, T, causal, window):
    """The hand-written backward vs autograd of the dense oracle (fp32, 5e-5)."""
    _, (q, k, v, do) = inputs(4, 2, S, T, H, Kv, 16)
    for t in (q, k, v):
        t.requires_grad_(True)
    o = ops.flash_attention(q, k, v, causal, window)
    o_ref = ref.flash_attention_ref(q, k, v, causal, window)
    np.testing.assert_allclose(f32(o), f32(o_ref), atol=2e-5)
    g = torch.autograd.grad(o, (q, k, v), do)
    g_ref = torch.autograd.grad(o_ref, (q, k, v), do)
    for a, b in zip(g, g_ref, strict=True):
        np.testing.assert_allclose(f32(a), f32(b), atol=5e-5)


def test_window_smaller_than_a_tile_has_no_nan():
    """Rows whose window lies wholly in a later key tile: the finite NEG_INF
    keeps them NaN-free (with -inf they would be exp(-inf + inf))."""
    _, (q, k, v, _) = inputs(5, 1, 256, 256, 2, 1, 16)
    o, lse = ops.flash_fwd(q, k, v, True, 4)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    assert fa.NEG_INF == ref.NEG_INF and np.isfinite(fa.NEG_INF)


def test_cpu_tensors_take_the_plain_path_and_count_nothing():
    before = dict(ops.LAUNCHES)
    _, (q, k, v, _) = inputs(6, 1, 64, 64, 2, 1, 16)
    ops.flash_attention(q, k, v)
    assert ops.LAUNCHES == before == {"flash_fwd": before["flash_fwd"],
                                      "flash_dq": before["flash_dq"],
                                      "flash_dkv": before["flash_dkv"]}


@pytest.mark.parametrize("bad", ["cpu_tensor", "head_dim", "seq", "dtype", "t_lt_s",
                                 "strided", "window"])
def test_cuda_wrapper_raises_on_what_the_kernel_does_not_take(bad):
    """The CUDA wrapper never computes anything for inputs outside the
    kernels' contract, and never falls back to the plain version."""
    B, S, T, H, Kv, hd = 1, 64, 64, 2, 1, 16
    window = None
    exc = ValueError
    if bad == "head_dim":
        hd = 48
    elif bad == "seq":
        S = T = 96
    elif bad == "t_lt_s":
        S, T = 128, 64
    _, (q, k, v, _) = inputs(7, B, S, T, H, Kv, hd)
    if bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
        exc = TypeError
    elif bad == "strided":
        q = q.transpose(1, 2)
    elif bad == "window":
        window = 0
    with pytest.raises(exc):
        fa.flash_fwd_cuda(q, k, v, True, window)
