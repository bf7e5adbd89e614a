"""``repro_torch.core.trace`` (a PyTorch step → MONET's ``WorkloadGraph``)
against the reference's jaxpr tracer, on the CPU.

The nine tests of ``tests/test_trace.py`` are mirrored on torch functions
(the scan-scaling case holds an unrolled loop's total equal to the
reference's scaled scan).  Then, from shared weights, the smoke train steps
and forwards of the three archs that the reference traces are held to the
reference's graphs: ``gemm``-class FLOPs and the parameters exactly, the
``simd`` class within ``SIMD_RTOL`` once the reference's ``name`` primitive
(``checkpoint_name``, which its elementwise rule counts at one FLOP an
element and the port does not dispatch) is set aside.  With the kernels on
(``use_flash``, S = 128) each kernel call is one node with the plain
version's ``FlopCounterMode`` FLOPs, and the graph is the same on the CPU and
on ``meta``.  The reference fails on a Pallas kernel; the port does not.
"""

import dataclasses
from collections import Counter
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import repro.configs as ref_configs
import repro_torch.configs as configs
from repro.core import trace_fn as ref_trace_fn
from repro.core import trace_model as ref_trace_model
from repro.data.pipeline import make_batch as ref_make_batch
from repro.kernels import ops as ref_kops
from repro.models import transformer as ref_transformer
from repro.optim import optimizers as ref_optim
from repro.training.train_step import make_train_step as ref_make_train_step
from repro_torch.convert import from_reference, tree_map
from repro_torch.core import schedule, tpu_v5e_like, trace_fn, trace_model
from repro_torch.core.remat_policy import resolve_remat
from repro_torch.core.trace import flop_count, recording
from repro_torch.data.pipeline import make_batch
from repro_torch.kernels import build, ops
from repro_torch.kernels import fused_adam as fad
from repro_torch.kernels import rmsnorm as rn
from repro_torch.models import transformer
from repro_torch.optim import optimizers as optim
from repro_torch.training.train_step import make_train_step

#: the port's simd-class FLOPs over the reference's, its ``name`` nodes set
#: aside: the rest of the gap is the two backward decompositions (autograd's
#: ``pow`` backward is ``pow(x, 1)`` and two products where JAX's
#: ``integer_pow`` VJP is two products; a ``mean``'s or a broadcast's
#: gradient is an ``expand`` (0) and a ``div`` in the port, a ``div`` and a
#: ``broadcast_in_dim`` in JAX; SAC recomputes what JAX's partial evaluation
#: drops), measured at 0.984-1.028 over the nine cases below
SIMD_RTOL = 0.05
ARCHS = ref_configs.ARCH_IDS[:3]
SHAPE = ("t", 32, 2, "train")


def by_class(g) -> Counter:
    out = Counter()
    for n in g.nodes.values():
        out[n.op_class] += n.flops
    return out


def simd_without_name(g) -> int:
    return sum(n.flops for n in g.nodes.values()
               if n.op_class == "simd" and n.meta.get("prim") != "name")


def params_of(g) -> tuple[int, int]:
    ps = [t for t in g.tensors.values() if t.is_param]
    return len(ps), sum(t.bytes for t in ps)


def canonical(g) -> tuple:
    return ([dataclasses.astuple(s) for s in g.tensors.values()],
            [(n.name, n.op, n.kind, sorted(n.dims.items()), n.inputs, n.outputs, n.flops,
              sorted(n.meta.items())) for n in g.nodes.values()])


# -- tests/test_trace.py, mirrored ----------------------------------------------------


def test_gemm_flops_exact():
    g = trace_fn(lambda x, w: x @ w, torch.ones(8, 16), torch.ones(16, 32))
    assert g.total_flops() == 2 * 8 * 16 * 32


def test_conv_flops_exact():
    g = trace_fn(lambda x, w: F.conv2d(x, w, padding="same"), torch.ones(1, 3, 8, 8),
                 torch.ones(4, 3, 3, 3))
    conv_nodes = [n for n in g.nodes.values() if n.op == "conv"]
    assert len(conv_nodes) == 1
    assert conv_nodes[0].flops == 2 * 1 * 4 * 3 * 8 * 8 * 3 * 3


def test_unrolled_loop_equals_reference_scaled_scan():
    """The reference scans one body and scales its FLOPs by the trip count;
    the port runs the loop and records each trip: one gemm a trip, each of
    ``scan_length`` 1, and the same total."""
    def ref_f(ws, x):
        def body(c, w):
            return jnp.tanh(c @ w), None
        out, _ = jax.lax.scan(body, x, ws)
        return out

    def f(ws, x):
        for w in ws:
            x = torch.tanh(x @ w)
        return x

    ref_g = ref_trace_fn(ref_f, jnp.ones((5, 8, 8)), jnp.ones((4, 8)))
    g = trace_fn(f, torch.ones(5, 8, 8), torch.ones(4, 8))
    gemms = [n for n in g.nodes.values() if n.op == "gemm"]
    assert len(gemms) == 5
    assert all(n.flops == 2 * 4 * 8 * 8 and n.meta["scan_length"] == 1 for n in gemms)
    assert g.total_flops() == ref_g.total_flops() == 5 * (2 * 4 * 8 * 8 + 8 * 4 * 8)


def test_grad_graph_contains_more_flops():
    def model(params, x):
        for w in params:
            x = torch.clamp_min(x @ w, 0)
        return x

    def train(params, x, y):
        ps = [p.detach().requires_grad_(True) for p in params]
        loss = ((model(ps, x) - y) ** 2).mean()
        return torch.autograd.grad(loss, ps)

    params = [torch.ones(16, 16)] * 3
    x = torch.ones(4, 16)
    g_fwd = trace_model(model, params, x)
    g_tr = trace_fn(train, params, x, torch.ones(4, 16))
    assert g_tr.total_flops() > 2.4 * g_fwd.total_flops()
    assert len(g_tr) > len(g_fwd)


def test_traced_params_marked():
    g = trace_model(lambda p, x: x @ p["w"], {"w": torch.ones(8, 4)}, torch.ones(2, 8))
    assert sum(1 for t in g.tensors.values() if t.is_param) == 1


def test_traced_graph_schedulable():
    """End to end: a real PyTorch SGD step → MONET's cost model."""
    def model(params, x):
        return torch.tanh(x @ params["w1"]) @ params["w2"]

    def train(params, x, y):
        ps = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss = ((model(ps, x) - y) ** 2).mean()
        grads = torch.autograd.grad(loss, list(ps.values()))
        return {k: p - 0.1 * gg for (k, p), gg in zip(params.items(), grads, strict=True)}

    params = {"w1": torch.ones(32, 64), "w2": torch.ones(64, 8)}
    g = trace_fn(train, params, torch.ones(16, 32), torch.ones(16, 8), name="sgd_step")
    r = schedule(g, tpu_v5e_like())
    assert r.latency > 0 and r.energy > 0


def test_attention_traced():
    def attn(q, k, v):
        s = torch.einsum("bshd,bthd->bhst", q, k)
        return torch.einsum("bhst,bthd->bshd", torch.softmax(s, dim=-1), v)

    x = torch.ones(2, 16, 4, 8)
    g = trace_fn(attn, x, x, x)
    gemms = [n for n in g.nodes.values() if n.op == "gemm"]
    assert len(gemms) == 2
    assert all(n.dims["B"] == 8 for n in gemms)     # b×h batch


class _Tanh(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = torch.tanh(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, dy):
        (y,) = ctx.saved_tensors
        return dy * (1 - y * y)


def test_shared_function_no_collision():
    """One ``autograd.Function`` called twice, forward and backward, aliases
    no tensor: every output is a fresh tensor and the graph validates."""
    def g(x):
        x = x.detach().requires_grad_(True)
        out = _Tanh.apply(x) + _Tanh.apply(x * 2.0)
        return torch.autograd.grad(out.sum(), x)

    gr = trace_fn(g, torch.ones(4), name="shared")
    gr.validate()
    assert len(gr) >= 4
    tanhs = [n for n in gr.nodes.values() if n.meta.get("prim") == "tanh"]
    assert len(tanhs) == 2 and tanhs[0].outputs != tanhs[1].outputs
    assert len({t for n in gr.nodes.values() for t in n.outputs}) == \
        sum(len(n.outputs) for n in gr.nodes.values())


def smoke_step(arch, remat="none", optimizer="sgd", use_flash=False, seq=32, device="cpu"):
    """The port's smoke train step of ``arch`` and its arguments, weights from
    the reference's init (``PRNGKey(0)``), on ``device``."""
    cfg = replace(configs.smoke_config(arch), remat=remat, use_flash=use_flash)
    ref_cfg = replace(ref_configs.smoke_config(arch), remat=remat)
    jp = ref_transformer.init_params(ref_cfg, jax.random.PRNGKey(0))
    params = tree_map(lambda t: t.to(device), from_reference(jax.tree.map(np.asarray, jp), "cpu"))
    opt = (optim.sgd_momentum(1e-2) if optimizer == "sgd"
           else optim.make_optimizer("adamw", 1e-3, cfg.state_dtype))
    batch = make_batch(cfg, configs.ShapeConfig("t", seq, 2, "train"), 0, device="cpu")
    # inputs and labels are one tensor on the CPU (``.to`` returns it): two,
    # as on every other device
    batch = {k: v.to(device).clone() for k, v in batch.items()}
    return cfg, make_train_step(cfg, opt), params, opt.init(params), batch


def test_trace_all_arch_train_steps():
    """Every arch the reference traces: its real smoke train step traces
    into MONET and schedules on the v5e-class HDA."""
    for arch in ARCHS:
        _, step, params, state, batch = smoke_step(arch)
        g = trace_fn(step, params, state, batch, 0, name=arch)
        g.validate()
        assert schedule(g, tpu_v5e_like()).latency > 0


# -- against the reference's graphs ------------------------------------------------


def ref_smoke(arch, remat="none"):
    cfg = replace(ref_configs.smoke_config(arch), remat=remat)
    params = ref_transformer.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, params, ref_make_batch(cfg, ref_configs.ShapeConfig(*SHAPE), 0)


def ref_step_graph(arch, remat="none"):
    cfg, params, batch = ref_smoke(arch, remat)
    opt = ref_optim.sgd_momentum(1e-2)
    return ref_trace_model(ref_make_train_step(cfg, opt), params, opt.init(params), batch,
                           jnp.int32(0), name=arch)


def step_graph(arch, remat="none"):
    _, step, params, state, batch = smoke_step(arch, remat)
    return trace_model(step, params, state, batch, 0, name=arch)


def assert_like_reference(g, ref_g):
    mine, want = by_class(g), by_class(ref_g)
    assert mine["gemm"] == want["gemm"] > 0
    assert mine["conv"] == want["conv"]
    assert params_of(g) == params_of(ref_g)
    assert params_of(g)[0] > 0
    ratio = mine["simd"] / simd_without_name(ref_g)
    assert abs(ratio - 1) <= SIMD_RTOL, (ratio, mine["simd"], want["simd"])
    g.validate()


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_graph_like_reference(arch):
    assert_like_reference(step_graph(arch), ref_step_graph(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_graph_like_reference(arch):
    cfg, params, batch = ref_smoke(arch)
    ref_g = ref_trace_model(lambda p, x: ref_transformer.logits_fn(p, cfg, x), params,
                            batch["inputs"])
    my_cfg = configs.smoke_config(arch)
    tparams = from_reference(jax.tree.map(np.asarray, params), "cpu")
    inputs = make_batch(my_cfg, configs.ShapeConfig(*SHAPE), 0, device="cpu")["inputs"]
    g = trace_model(lambda p, x: transformer.logits_fn(p, my_cfg, x), tparams, inputs)
    assert_like_reference(g, ref_g)


#: the recompute under ``dots`` (its simd FLOPs less ``none``'s, the
#: reference's ``name`` nodes set aside), the port's over the reference's, in
#: a band of ±0.03 around what was measured (0.837, 0.876, 0.873): SAC has no
#: dead-code elimination (ROADMAP queue C), yet the port recomputes less than
#: the reference, whose partial evaluation of the remat'd scan body emits
#: more elementwise work than autograd's saved-tensor backward reads
DOTS_RECOMPUTE = {"nemotron-4-340b": (0.807, 0.867), "gemma3-1b": (0.846, 0.906),
                  "phi3-medium-14b": (0.843, 0.903)}


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_recompute_against_reference(arch):
    """Under ``dots`` both sides keep every matrix product (``gemm`` FLOPs
    equal ``none``'s, exactly); the elementwise recompute is measured and
    held in its measured band (``DOTS_RECOMPUTE``)."""
    g, ref_g = step_graph(arch, "dots"), ref_step_graph(arch, "dots")
    g0, ref_g0 = step_graph(arch), ref_step_graph(arch)
    assert by_class(g)["gemm"] == by_class(g0)["gemm"] == by_class(ref_g)["gemm"]
    mine = by_class(g)["simd"] - by_class(g0)["simd"]
    want = simd_without_name(ref_g) - simd_without_name(ref_g0)
    lo, hi = DOTS_RECOMPUTE[arch]
    assert mine > 0 and want > 0
    assert lo <= mine / want <= hi, (mine, want, mine / want)
    assert_like_reference(g, ref_g)


# -- kernels ------------------------------------------------------------------------


KERNEL_ARCHS = ["gemma3-1b", "mamba2-1.3b", "olmoe-1b-7b"]


def expected_kernel_nodes(cfg, params) -> dict:
    """A step's kernel calls, from the model code (as ``chip_smoke.py``
    derives launches): a layer's norms, one flash_fwd for attention and one
    ssd_chunk and two causal_conv (x and B/C) for a mamba mixer, each again
    when its period is recomputed; one rmsnorm_bwd a norm, flash_dq and
    flash_dkv for attention, one ssd_chunk_bwd and two causal_conv_bwd for a
    mamba mixer; the final norm and its backward; one fused_adam a launch
    group."""
    out = dict.fromkeys(build.ENTRY_POINTS, 0)
    period = cfg.scan_period()
    recomputed = (cfg.n_layers // period) * period if resolve_remat(cfg.remat)[0] else 0
    for i, spec in enumerate(cfg.layer_specs()):
        runs = 2 if i < recomputed else 1
        attn, mamba = spec.mixer in ("attn", "local"), spec.mixer == "mamba"
        norms = 1 + int(spec.moe or cfg.mlp != "none") + int(mamba) + 2 * int(spec.mixer == "mla")
        out["flash_fwd"] += runs * attn
        out["flash_dq"] += attn
        out["flash_dkv"] += attn
        out["ssd_chunk"] += runs * mamba
        out["ssd_chunk_bwd"] += mamba
        out["causal_conv"] += 2 * runs * mamba
        out["causal_conv_bwd"] += 2 * mamba
        out["rmsnorm"] += runs * norms
        out["rmsnorm_bwd"] += norms
    out["rmsnorm"] += 1
    out["rmsnorm_bwd"] += 1
    leaves = torch.utils._pytree.tree_leaves(params)
    state = [torch.empty(0, dtype=getattr(torch, cfg.state_dtype))] * len(leaves)
    out["fused_adam"] = len(fad.launch_groups(leaves, leaves, state))
    return out


def kernel_step(arch, remat, device):
    cfg, step, params, state, batch = smoke_step(arch, remat, "adamw", True, 128, device)
    return cfg, step, (params, state, batch, 0)


@pytest.mark.parametrize("remat", ["none", "dots"])
@pytest.mark.parametrize("arch", KERNEL_ARCHS)
def test_kernel_calls_are_nodes(arch, remat):
    """``use_flash`` at S = 128: every kernel call one node (``meta["kernel"]``,
    the plain version's ``FlopCounterMode`` FLOPs, none of its operators
    recorded), as many as the model code calls; ``gemm``-class FLOPs equal
    to ``FlopCounterMode`` over the same step on ``meta`` plus what SAC's
    recompute hides from it; the same graph on the CPU and on ``meta``."""
    cfg, step, args = kernel_step(arch, remat, "cpu")
    step(*kernel_step(arch, remat, "cpu")[2])          # caches filled (RoPE tables)
    with recording(arch, params=args[0], inputs=args[1:]) as rec:
        step(*args)
    g = rec.graph
    assert rec.kernel_nodes == expected_kernel_nodes(cfg, args[0])
    kn = [n for n in g.nodes.values() if n.meta.get("kernel")]
    assert len(kn) == sum(rec.kernel_nodes.values())
    for n in kn:
        assert n.op == {"rmsnorm": "norm", "rmsnorm_bwd": "norm_bwd", "fused_adam": "opt",
                        "causal_conv": "elementwise", "causal_conv_bwd": "elementwise"}.get(
            n.meta["kernel"], "gemm")
        if n.op == "gemm":
            assert n.flops > 0 and n.flops == 2 * n.dims["B"] * n.dims["M"] * n.dims["N"] * \
                n.dims["K"]
        else:
            assert n.flops == 0
    # the plain versions' operators are not recorded: gemma3's only batched
    # products are attention's, olmoe's are its experts' (3 a layer forward
    # and 6 in the backward; ``dots`` keeps them, so none is recomputed)
    bmm = sum(1 for n in g.nodes.values() if n.meta.get("aten") == "aten.bmm.default")
    if arch == "gemma3-1b":
        assert bmm == 0
    elif arch == "olmoe-1b-7b":
        assert bmm == 9 * cfg.n_layers
    # FLOPs: FlopCounterMode over the same step on meta
    meta_args = kernel_step(arch, remat, "meta")[2]
    counted, hidden = flop_count(step, *meta_args)
    cls = by_class(g)
    assert cls["gemm"] + cls["conv"] == counted + hidden
    if remat == "none":
        assert hidden == 0
    else:
        assert hidden > 0
    # the same graph on meta
    meta_args = kernel_step(arch, remat, "meta")[2]
    step(*kernel_step(arch, remat, "meta")[2])
    with recording(arch, params=meta_args[0], inputs=meta_args[1:]) as mrec:
        step(*meta_args)
    assert canonical(mrec.graph) == canonical(g)
    assert schedule(g, tpu_v5e_like()).latency > 0


def test_wrapper_calls_are_one_node_each():
    """The flash and norm wrappers alone: the forward is exactly the kernel
    node; forward and backward hold one node an entry point and no
    operator of a plain version (no ``bmm``, no ``rsqrt``)."""
    q = torch.randn(1, 128, 2, 64)
    g = trace_fn(ops.flash_attention, q, q, q)
    assert [n.meta.get("kernel") for n in g.nodes.values()] == ["flash_fwd"]
    x, scale = torch.randn(4, 64), torch.randn(64)
    g = trace_fn(ops.rmsnorm, x, scale)
    assert [n.meta.get("kernel") for n in g.nodes.values()] == ["rmsnorm"]

    def both(q, k, v, x, scale):
        q, x = q.requires_grad_(True), x.requires_grad_(True)
        o = ops.flash_attention(q, k, v)
        y = ops.rmsnorm(x, scale)
        return torch.autograd.grad((o.sum(), y.sum()), (q, x))

    with recording("both", inputs=(q, q.clone(), q.clone(), x, scale)) as rec:
        both(q.clone(), q.clone(), q.clone(), x.clone(), scale)
    kinds = Counter(n.meta.get("kernel") for n in rec.graph.nodes.values() if n.meta.get("kernel"))
    assert kinds == {"flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1, "rmsnorm": 1,
                     "rmsnorm_bwd": 1}
    atens = {n.meta.get("aten") for n in rec.graph.nodes.values()}
    assert not atens & {"aten.bmm.default", "aten.rsqrt.default", "aten._softmax.default"}


def test_fused_adam_is_one_node_a_launch_group():
    """AdamW over a mixed tree: one node a launch group (``launch_groups``),
    its p, m and v written in place under fresh names."""
    ps = [torch.randn(5, 3), torch.randn(4).bfloat16(), torch.randn(2, 2)]
    gs = [torch.randn_like(p) for p in ps]
    ms = [torch.zeros(p.shape) for p in ps]
    vs = [torch.zeros(p.shape) for p in ps]
    count = torch.tensor(1, dtype=torch.int32)
    with recording("adam", params=ps, inputs=(gs, ms, vs, count)) as rec:
        ops.fused_adam_multi(ps, gs, ms, vs, count, 1e-3)
    nodes = list(rec.graph.nodes.values())
    assert [n.meta["kernel"] for n in nodes] == ["fused_adam"] * 2
    assert [len(n.outputs) for n in nodes] == [3 * 2, 3 * 1]
    assert [n.dims["N"] for n in nodes] == [15 + 4, 4]
    assert not set(n.outputs[0] for n in nodes) & {t for t, s in rec.graph.tensors.items()
                                                   if s.is_param}


def test_planted_fault_a_wrapper_without_its_hook():
    """The norm's forward taken around ``kernel_call`` (its hook switched
    off): its plain operators are recorded and its nodes are missing, so the
    count check fails."""
    cfg, step, args = kernel_step("gemma3-1b", "none", "cpu")
    saved = rn.rmsnorm_fwd
    rn.rmsnorm_fwd = lambda x, scale, eps=1e-6: rn.rmsnorm_plain(x, scale, eps)
    try:
        with recording("fault", params=args[0], inputs=args[1:]) as rec:
            step(*args)
    finally:
        rn.rmsnorm_fwd = saved
    want = expected_kernel_nodes(cfg, args[0])
    assert rec.kernel_nodes != want
    assert rec.kernel_nodes["rmsnorm"] == 0 and want["rmsnorm"] > 0
    assert any(n.meta.get("aten") == "aten.rsqrt.default" for n in rec.graph.nodes.values())


def test_reference_trace_fails_on_a_pallas_kernel():
    """A fault in the reference, not copied: ``repro.core.trace`` inlines a
    ``pallas_call``'s kernel body as if it were a call and zips its refs
    (outputs included) against the call's operands, so it raises on any
    function that reaches a Pallas kernel, forward or gradient.  The port
    records the same function's kernel calls as nodes."""
    q = jnp.ones((1, 128, 2, 64), jnp.float32)
    with pytest.raises(ValueError, match="zip"):
        ref_trace_fn(lambda q, k, v: ref_kops.flash_attention(q, k, v), q, q, q)
    with pytest.raises(ValueError, match="zip"):
        ref_trace_fn(lambda q, k, v: jax.grad(
            lambda a: ref_kops.flash_attention(a, k, v).sum())(q), q, q, q)
    t = torch.ones(1, 128, 2, 64)
    g = trace_fn(ops.flash_attention, t, t, t)
    g.validate()
    assert g.total_flops() == 4 * 1 * 2 * 128 * 128 * 64

    def grad(q, k, v):
        q = q.detach().requires_grad_(True)
        return torch.autograd.grad(ops.flash_attention(q, k, v).sum(), q)

    g = trace_fn(grad, t, t, t)
    g.validate()
    assert Counter(n.meta.get("kernel") for n in g.nodes.values() if n.meta.get("kernel")) == \
        {"flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1}
    assert schedule(g, tpu_v5e_like()).latency > 0


def test_inplace_writes_take_fresh_names_and_stale_views_follow_them():
    """A write in place gives its tensor a fresh name (the node reads the
    old one); a view taken before the write and read after it reads what the
    storage holds now, through a ``reshape`` node from the written tensor."""
    def f(x):
        v = x[:2]
        x.mul_(2)
        return v + 1

    g = trace_fn(f, torch.ones(4))
    nodes = list(g.nodes.values())
    assert [n.meta["aten"] for n in nodes] == ["aten.slice.Tensor", "aten.mul_.Tensor",
                                               "view_of_storage", "aten.add.Tensor"]
    sl, mul, view, add = nodes
    assert mul.inputs == sl.inputs and mul.outputs != mul.inputs
    assert view.op == "reshape" and view.inputs == mul.outputs and add.inputs == view.outputs


def test_one_trace_at_a_time_and_no_hook_after():
    with recording("a"):
        with pytest.raises(RuntimeError, match="already active"):
            with recording("b"):
                pass
    assert build.TRACE_HOOK is None
    with pytest.raises(ZeroDivisionError):
        with recording("c"):
            raise ZeroDivisionError
    assert build.TRACE_HOOK is None
