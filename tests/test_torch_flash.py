"""The port's flash attention against the JAX package's, on the CPU.

The JAX side runs its Pallas kernels in interpret mode (what
``repro.kernels.ops`` does off-TPU); the port runs the plain PyTorch versions
that sit beside its CUDA kernels and state the same arithmetic.  Inputs come
from numpy with a seed and go to both.

Tolerances are those of tests/test_kernels.py: fp32 2e-5 forward and 5e-5
gradients (two fp32 summation orders over at most 256 keys), bf16 2e-2 (one
rounding of the output to 8 bits of mantissa; on the card's bf16 kernels also
the rounding of p and ds before the second products — p·v, pᵀ·do, dsᵀ·q and
ds·k — which ``test_tensor_core_rounding_fits_the_bf16_tolerance`` states in
PyTorch).
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
#: bf16: largest relative 2-norm error of one row (over hd), three bf16 ulps,
#: as chip_smoke.py holds the tensor-core kernels to it on the card
ROW_RTOL = 3 * 2 ** -8


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
    assert ops.LAUNCHES == before
    assert {"flash_fwd", "flash_dq", "flash_dkv"} <= set(before)


def tc_arithmetic(q, k, v, do, causal, window):
    """The arithmetic of the bf16 tensor-core kernels (``flash_fwd_tc_kernel``,
    ``flash_dq_tc_kernel``, ``flash_dkv_tc_kernel``) in plain PyTorch: fp32
    products of the bf16 inputs, with ``p`` (forward and dk/dv) and ``ds`` (dq
    and dk/dv) rounded to bf16 before they meet ``v``, ``do``, ``k`` and
    ``q``; the row sum ``l`` and ``ds`` are formed from the fp32 ``p``, and
    ``ds`` from the fp32 ``dp``.  Returns o, lse, dq, dk, dv (dk/dv summed
    over the GQA group); the backward uses this o and lse, as training
    does."""
    B, S, H, hd = q.shape
    T, Kv = k.shape[1], k.shape[2]
    G, scale = H // Kv, hd ** -0.5
    bf = lambda t: t.to(torch.bfloat16).float()
    qg = q.float().reshape(B, S, Kv, G, hd)
    dog = do.float().reshape(B, S, Kv, G, hd)
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * scale
    s = torch.where(ref.attention_mask(S, T, causal, window, q.device), s, ref.NEG_INF)
    m = s.max(dim=-1).values
    p = torch.exp(s - m[..., None])
    lse = m + torch.log(p.sum(dim=-1))
    o = torch.einsum("bkgst,btkd->bskgd", bf(p), v.float()) / p.sum(dim=-1).permute(
        0, 3, 1, 2)[..., None]
    o = o.reshape(B, S, H, hd).to(q.dtype)
    delta = ops.attention_delta(o, do).reshape(B, Kv, G, S)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bskgd,btkd->bkgst", dog, v.float())
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bkgst,btkd->bskgd", bf(ds), k.float()).reshape(B, S, H, hd)
    dv = torch.einsum("bkgst,bskgd->btkd", bf(p), dog)
    dk = torch.einsum("bkgst,bskgd->btkd", bf(ds), qg)
    return o, lse.reshape(B, H, S), dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@pytest.mark.parametrize("window", [None, 16])
def test_tensor_core_rounding_fits_the_bf16_tolerance(window):
    """The arithmetic stated in ``tc_arithmetic`` (p and ds rounded to bf16
    before the second products, which the card's bf16 kernels do and the fp32
    path does not) stays within the tolerances the card holds those kernels
    to (2e-2 elementwise, ``ROW_RTOL`` a row) of the Pallas kernels run in
    interpret mode on the same bf16 inputs: o and lse, and dq, dk, dv against
    ``jax.vjp`` of the reference.  It checks that statement of the
    rounding, not the port's code: the kernels themselves are held to the
    same tolerances by chip_smoke.py on the card."""
    B, S, T, H, Kv, hd = 1, 128, 256, 4, 2, 32
    tol = TOL["bfloat16"]
    (jq, jk, jv, jdo), (q, k, v, do) = inputs(8, B, S, T, H, Kv, hd, "bfloat16")
    o, lse, dq, dk, dv = tc_arithmetic(q, k, v, do, True, window)
    o_ref, vjp = jax.vjp(
        lambda a, b, c: ref_ops.flash_attention(a, b, c, True, window, 64, 64), jq, jk, jv)
    _, lse_ref = ref_ops._flash_fwd_impl(jq, jk, jv, True, window, 64, 64, None)
    dq_ref, dk_ref, dv_ref = vjp(jdo)
    np.testing.assert_allclose(f32(o), f32(o_ref), atol=tol, rtol=tol)
    np.testing.assert_allclose(f32(lse).reshape(B * H, S), f32(lse_ref), atol=2e-5, rtol=2e-5)
    for a, b in ((dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
        np.testing.assert_allclose(f32(a), f32(b), atol=tol, rtol=tol)
    for a, b in ((o, o_ref), (dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
        a, b = f32(a).reshape(-1, hd), f32(b).reshape(-1, hd)
        err = np.linalg.norm(a - b, axis=-1)
        assert np.all(err <= ROW_RTOL * np.linalg.norm(b, axis=-1)), err.max()


CONTRACT_CASES = ["cpu_tensor", "head_dim", "seq", "dtype", "t_lt_s", "strided", "window",
                  "misaligned", "mixed_dtype"]


@pytest.mark.parametrize("bad", CONTRACT_CASES + [f"bf16:{c}" for c in CONTRACT_CASES])
def test_cuda_wrapper_raises_on_what_the_kernel_does_not_take(bad):
    """The CUDA wrappers never compute anything for inputs outside the
    kernels' contract, and never fall back to the plain version: the
    forward, dq and dk/dv wrappers all raise before any launch, for fp32
    inputs (the FMA kernels) and bf16 inputs (the tensor-core kernels)
    alike."""
    dtype = "bfloat16" if bad.startswith("bf16:") else "float32"
    bad = bad.removeprefix("bf16:")
    B, S, T, H, Kv, hd = 1, 64, 64, 2, 1, 16
    window = None
    exc, match = ValueError, None
    if bad == "head_dim":
        hd = 48
    elif bad == "seq":
        S = T = 96
    elif bad == "t_lt_s":
        S, T = 128, 64
    _, (q, k, v, _) = inputs(7, B, S, T, H, Kv, hd, dtype)
    if bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
        exc = TypeError
    elif bad == "strided":
        q = q.transpose(1, 2)
    elif bad == "window":
        window = 0
    elif bad == "misaligned":
        # contiguous, but starting one element past a 16-byte boundary
        q = torch.empty(q.numel() + 1, dtype=q.dtype)[1:].view(q.shape).copy_(q)
        match = "16-byte"
    elif bad == "mixed_dtype":
        k = k.bfloat16() if dtype == "float32" else k.float()
        exc = TypeError
    do = torch.zeros(q.shape, dtype=q.dtype)
    lse, delta = torch.zeros((B, H, S)), torch.zeros((B, H, S))
    before = dict(ops.LAUNCHES)
    with pytest.raises(exc, match=match):
        fa.flash_fwd_cuda(q, k, v, True, window)
    with pytest.raises(exc, match=match):
        fa.flash_dq_cuda(q, k, v, do, lse, delta, True, window)
    with pytest.raises(exc, match=match):
        fa.flash_dkv_cuda(q, k, v, do, lse, delta, True, window)
    assert ops.LAUNCHES == before
