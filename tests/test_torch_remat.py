"""Selective activation checkpointing in the port against the reference's
``core/remat_policy.py``, on the CPU.

The pieces (site names, policy names, ``family_of``, ``resolve_remat``) are
held equal to the reference's; then, from shared weights, every policy gives
the reference's loss and gradients (2e-5, and 5e-5 for gradients, as every
fp32 parity test of the port), saves what the reference's
``print_saved_residuals`` lists, keeps nothing a kernel wrapper allocates,
and, under ``dots``, runs no forward matrix product again in the backward.
"""

import contextlib
import io
import re
from collections import Counter
from dataclasses import replace

import jax
import jax.ad_checkpoint
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.ad_checkpoint import name_p
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import CheckpointPolicy, set_checkpoint_early_stop

import repro.configs as ref_configs
import repro_torch.configs as configs
from repro.core import build_training_graph, gpt2_graph, mlp_graph, resnet18_graph
from repro.core import remat_policy as ref_rp
from repro.models import transformer as ref_transformer
from repro.training import loss as ref_loss
from repro_torch.convert import from_reference, tree_flatten_with_path, tree_leaves
from repro_torch.core import remat_policy as rp
from repro_torch.kernels import ops
from repro_torch.models import transformer
from repro_torch.training import loss

FP32 = dict(param_dtype="float32", compute_dtype="float32")
B, S = 2, 64
#: the policies every model is held to: the four named ones, the keep-set of
#: ``test_system.py::test_monet_decision_drives_real_jax_step`` and the sites
#: that keep no product's output
POLICY_NAMES = ["none", "full", "dots", "dots_no_batch", "save:mlp_hidden,qkv",
                "save:attn_in,attn_out,moe_hidden,ssm_state,block_out"]
#: smoke configurations, fp32: gemma3 with a scanned period of 6 (5 local, 1
#: global) and a remainder of 2 that is never recomputed; mamba2 on the plain
#: route; minicpm3 (MLA); olmoe (MoE, capacity as configured)
MODELS = {"gemma3": ("gemma3-1b", dict(n_layers=8)), "mamba2": ("mamba2-1.3b", {}),
          "minicpm3": ("minicpm3-4b", {}), "olmoe": ("olmoe-1b-7b", {})}
PRODUCTS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default}


def small(model, **kw):
    arch, over = MODELS[model]
    kw = {**over, **FP32, **kw}
    return replace(configs.smoke_config(arch), **kw), replace(ref_configs.smoke_config(arch), **kw)


def shared_params(ref_cfg):
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      ref_transformer.init_params(ref_cfg, jax.random.PRNGKey(0)))
    return jp, from_reference(jax.tree.map(np.asarray, jp), "cpu")


def f32(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class Products(TorchDispatchMode):
    """Counts the matrix products that run inside it."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in PRODUCTS
        return func(*args, **(kwargs or {}))


class _Wrapped:
    """How deep the running code is in the kernel wrappers ``recorded``
    marks."""
    depth = 0


def _marked(fn):
    def run(*args, **kwargs):
        _Wrapped.depth += 1
        try:
            return fn(*args, **kwargs)
        finally:
            _Wrapped.depth -= 1
    return run


@contextlib.contextmanager
def recorded(monkeypatch):
    """Every decision that SAC receives from a port policy, as (op, the tag's
    name, inside a kernel wrapper — ``ops.flash_attention``, ``ops.rmsnorm``,
    ``ops.ssd_chunk_heads`` or ``ops.causal_conv_silu`` —, the output's
    shape, policy)."""
    log = []
    make = rp.create_selective_checkpoint_contexts

    def recording(policy):
        def rec(ctx, op, *args, **kwargs):
            out = policy(ctx, op, *args, **kwargs)
            shape = tuple(ctx.op_output.shape) if isinstance(ctx.op_output, torch.Tensor) \
                else None
            log.append((op, rp._SCOPE.pending, _Wrapped.depth > 0, shape, out))
            return out
        return make(rec)

    with monkeypatch.context() as m:
        m.setattr(rp, "create_selective_checkpoint_contexts", recording)
        for name in ("flash_attention", "rmsnorm", "ssd_chunk_heads", "causal_conv_silu"):
            m.setattr(ops, name, _marked(getattr(ops, name)))
        yield log


def saved(log):
    return [entry for entry in log if entry[-1] == CheckpointPolicy.MUST_SAVE]


# -- the pieces ------------------------------------------------------------------------


def test_sites_and_policy_names_match_reference():
    assert rp.KNOWN_SITES == ref_rp.KNOWN_SITES
    assert list(rp.POLICIES) == list(ref_rp.POLICIES)
    assert rp.POLICIES["none"] is None and rp.POLICIES["full"] == ref_rp.POLICIES["full"]


def _monet_names() -> list[str]:
    names = []
    for g in (gpt2_graph(1, 128, 256, 2, 4, 512), mlp_graph(batch=4, widths=(32, 16)),
              resnet18_graph(1, 32)):
        names += list(build_training_graph(g).graph.tensors)
    # names that match no rule, and ones that two rules would match
    return names + ["", "x", "l0.ssm_scan.out", "Final_Norm.OUT", "l3.add7.out",
                    "l0.gate.out.ln1.out", "l0.q.outer", "probs.scan"]


def test_family_of_matches_reference_on_monet_graph_names():
    """Every tensor name of MONET's training graphs (GPT-2, an MLP, ResNet-18)
    maps to the same activation family, or to none, on both sides."""
    names = _monet_names()
    got = [rp.family_of(n) for n in names]
    assert got == [ref_rp.family_of(n) for n in names]
    fams = Counter(got)
    assert fams[None] > 0 and {"qkv", "attn_probs", "attn_out", "mlp_hidden", "mlp_out",
                               "attn_in", "block_out", "ssm_state"} <= set(fams)


def _port_keeps(use, policy) -> tuple:
    """What a port policy keeps, read from SAC's decisions over a probe that
    tags every site and runs the three kinds of product: (sites kept, a 2-D
    ``mm``, a ``bmm`` with a batch dim, a ``bmm`` over a broadcast matrix)."""
    if not use or policy is None:
        return frozenset(), False, False, False
    w = torch.randn(8, 8, requires_grad=True)

    def probe(x):
        y = x
        for n in rp.KNOWN_SITES:
            y = rp.checkpoint_name(torch.tanh(y), n)
        mm = y @ w
        bmm = torch.bmm(y.reshape(2, 2, 8), y.reshape(2, 8, 2))
        bcast = torch.bmm(y.reshape(2, 2, 8), w.expand(2, 8, 8))
        return mm.sum() + bmm.sum() + bcast.sum()

    with pytest.MonkeyPatch.context() as m, recorded(m) as log:
        rp.checkpointed(probe, policy)(torch.randn(4, 8, requires_grad=True)).backward()
    kept = saved(log)
    sites = frozenset(n for op, n, *_ in kept if op is torch.ops.aten.alias.default)
    shapes = Counter(shape for op, _, _, shape, _ in kept if op in PRODUCTS)
    return sites, shapes[(4, 8)] == 1, shapes[(2, 2, 2)] == 1, shapes[(2, 2, 8)] == 1


def _ref_keeps(use, policy) -> tuple:
    """The same from the reference's policy function: a ``dot_general``
    without batch dims (``x @ w``, also what the port's broadcast ``bmm``
    computes), one with a batch dim, and ``name_p`` of each site."""
    if not use or policy is None:
        return frozenset(), False, False, False
    no_batch = bool(policy(jax.lax.dot_general_p, dimension_numbers=(((1,), (0,)), ((), ()))))
    batch = bool(policy(jax.lax.dot_general_p,
                        dimension_numbers=(((2,), (1,)), ((0,), (0,)))))
    sites = frozenset(n for n in ref_rp.KNOWN_SITES if policy(name_p, name=n))
    return sites, no_batch, batch, no_batch


@pytest.mark.parametrize("name", ["none", None, "full", "dots", "dots_no_batch",
                                  "save:qkv,mlp_hidden", "save:", "save:qkv,bogus"])
def test_resolve_remat_matches_reference(name):
    use, policy = rp.resolve_remat(name)
    ref_use, ref_policy = ref_rp.resolve_remat(name)
    assert use == ref_use
    assert (policy is None) == (ref_policy is None)
    assert _port_keeps(use, policy) == _ref_keeps(ref_use, ref_policy)


@pytest.mark.parametrize("name", ["bogus", "dots ", "Save:qkv", "nothing"])
def test_unknown_policy_raises_on_both_sides(name):
    with pytest.raises(ValueError, match="unknown remat policy"):
        ref_rp.resolve_remat(name)
    with pytest.raises(ValueError, match="unknown remat policy"):
        rp.resolve_remat(name)


@pytest.mark.parametrize("keep,names", [
    ({"l0.fc1.out", "l0.q.out"}, {"mlp_hidden", "qkv"}),
    ({"l0.ln1.out", "l1.res2.out", "l0.softmax.out", "tokens"},
     {"attn_in", "block_out", "attn_probs"}),
    ({"tokens", "wte.table"}, None)])
def test_keepset_to_policy_matches_reference(keep, names):
    """A keep-set becomes the same families; an empty set saves nothing."""
    got, want = rp.keepset_to_policy(keep), ref_rp.keepset_to_policy(keep)
    if names is None:
        assert got is rp.nothing_saveable
        assert want is jax.checkpoint_policies.nothing_saveable
    else:
        assert got.names == names
    assert _port_keeps(True, got)[0] == _ref_keeps(True, want)[0]
    assert rp.policy_from_keep(["qkv", "bogus"]).names == {"qkv"}


def test_monet_decision_drives_port_step():
    """``test_system.py::test_monet_decision_drives_real_jax_step`` in the
    port: a MONET keep-set becomes a SAC policy on a tagged ``tanh(x @ w)``
    block, which keeps the tag's output and gives the gradients of no remat."""
    policy = rp.keepset_to_policy({"l0.fc1.out", "l0.q.out"})
    assert policy is not None and policy.names == {"mlp_hidden", "qkv"}

    def block(w, x):
        h = rp.checkpoint_name(torch.tanh(x @ w), "mlp_hidden")
        return h @ w.T

    w = torch.ones((16, 16), requires_grad=True)
    x = torch.ones((4, 16))
    g1 = torch.autograd.grad(block(w, x).sum(), w)[0]
    with pytest.MonkeyPatch.context() as m, recorded(m) as log:
        g2 = torch.autograd.grad(rp.checkpointed(block, policy)(w, x).sum(), w)[0]
    np.testing.assert_allclose(g1.numpy(), g2.numpy(), rtol=1e-6)
    assert [(n, shape) for _, n, _, shape, _ in saved(log)] == [("mlp_hidden", (4, 16))]


def test_tag_is_an_alias_only_under_a_name_policy():
    """Outside a ``save:`` policy the tag is no operator; under one it is an
    ``aten.alias`` of the value, which shares its storage (no copy), and the
    recompute's alias returns that storage from SAC's cache."""
    x = torch.randn(3, 5)
    assert rp.checkpoint_name(x, "qkv") is x
    seen = []

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            seen.append((func, args[0].data_ptr(), out.data_ptr()))
            return out

    def f(t):
        with Ops():
            return rp.checkpoint_name(t * 2, "qkv") * t    # saves the tagged value

    t = torch.randn(3, 5, requires_grad=True)
    rp.checkpointed(f, rp.resolve_remat("save:qkv")[1])(t).sum().backward()
    (_, fwd_in, fwd_out), (_, rec_in, rec_out) = [
        e for e in seen if e[0] is torch.ops.aten.alias.default]
    assert fwd_out == fwd_in and rec_out == fwd_out and rec_in != fwd_in
    seen.clear()
    rp.checkpointed(f, rp.resolve_remat("save:attn_in")[1])(t).sum().backward()
    assert torch.ops.aten.alias.default not in [e[0] for e in seen]


# -- the models under every policy -------------------------------------------------------


def _ref_loss_and_grads(ref_cfg, jp, x, y):
    def f(p):
        return ref_loss.lm_loss(p, ref_cfg, jnp.asarray(x), jnp.asarray(y))[0]
    return jax.jit(jax.value_and_grad(f))(jp)


def _tokens(cfg, seed=1):
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(0, cfg.vocab, (B, S)).astype(np.int32) for _ in range(2))


@pytest.mark.parametrize("policy", POLICY_NAMES)
@pytest.mark.parametrize("model", list(MODELS))
def test_loss_and_grads_match_reference_under_policy(model, policy):
    """The same ``cfg.remat`` on both sides: loss to 2e-5, every gradient leaf
    to 5e-5 (plain route)."""
    cfg, ref_cfg = small(model, remat=policy)
    jp, tp = shared_params(ref_cfg)
    x, y = _tokens(cfg)
    want, want_g = _ref_loss_and_grads(ref_cfg, jp, x, y)
    leaves = tree_flatten_with_path(tp)
    for t in leaves.values():
        t.requires_grad_(True)
    got, _ = loss.lm_loss(tp, cfg, torch.from_numpy(x), torch.from_numpy(y))
    grads = torch.autograd.grad(got, list(leaves.values()))
    np.testing.assert_allclose(float(got.detach()), float(want), atol=2e-5)
    ref_leaves = tree_flatten_with_path(jax.tree.map(np.asarray, want_g))
    assert list(leaves) == list(ref_leaves)
    for k, g in zip(leaves, grads, strict=True):
        np.testing.assert_allclose(f32(g), ref_leaves[k], atol=5e-5, err_msg=k)


def _period(cfg):
    """One scanned period's parameters and specs, an input and positions."""
    return cfg.scan_period(), cfg.layer_specs()


def _ref_residuals(ref_cfg, jp, policy_name) -> Counter:
    """Element counts of what ``print_saved_residuals`` lists for one
    checkpointed period of the reference under the policy, without the
    period's arguments and constants."""
    period, specs = _period(ref_cfg)
    pp = jax.tree.map(lambda a: a[0], jp["scan"])
    xin = jnp.asarray(np.random.default_rng(2).standard_normal((B, S, ref_cfg.d_model)),
                      jnp.float32)
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))

    def body(x, pp):
        for i in range(period):
            x, _ = ref_transformer._apply_layer(pp[str(i)], x, ref_cfg, specs[i], pos)
        return x

    _, policy = ref_rp.resolve_remat(policy_name)
    f = jax.checkpoint(body, policy=policy, prevent_cse=False)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jax.ad_checkpoint.print_saved_residuals(lambda x, pp: f(x, pp).sum(), xin, pp)
    out = Counter()
    for line in buf.getvalue().splitlines():
        if "from the argument" in line or "from a constant" in line:
            continue
        dims = re.match(r"\w+\[([\d,]*)\]", line).group(1)
        out[int(np.prod([int(d) for d in dims.split(",") if d]))] += 1
    return out


def _port_saved(cfg, tp, policy_name, monkeypatch, seq=S) -> tuple[Counter, list]:
    """Element counts of what SAC keeps for one checkpointed period of the
    port under the policy, and every decision it took."""
    period, specs = _period(cfg)
    pp = transformer._unstack(tp["scan"], cfg.n_layers // period)[0]
    xin = torch.randn(B, seq, cfg.d_model, requires_grad=True)
    pos = torch.arange(seq, dtype=torch.int32).expand(B, seq)

    def body(x, pp):
        for i in range(period):
            x, _ = transformer._apply_layer(pp[str(i)], x, cfg, specs[i], pos)
        return x

    _, policy = rp.resolve_remat(policy_name)
    with recorded(monkeypatch) as log:
        rp.checkpointed(body, policy)(xin, pp).sum().backward()
    return Counter(int(np.prod(shape)) for *_, shape, _ in saved(log)), log


#: the port keeps, besides what the reference lists, the value that ends the
#: period when the policy selects it: SAC keeps what a policy names whether or
#: not a backward reads it, XLA drops a residual no backward reads.  Under the
#: product policies that is the period's last product, (B, S, D), where a
#: (B, S, D) product ends the period (not in olmoe, whose experts' last product
#: the gated combine reads); under ``block_out`` the period's output itself (an
#: alias of what the next period keeps as its input: no extra memory)
LAST = {"dots": ("gemma3", "mamba2", "minicpm3"), "dots_no_batch": ("gemma3", "mamba2", "minicpm3"),
        "save:attn_in,attn_out,moe_hidden,ssm_state,block_out": tuple(MODELS)}


def _jax_only(cfg, policy) -> Counter:
    """What the reference alone keeps under the product policies in a mamba
    layer: the outputs of the ``jnp.pad`` calls of its ``_causal_conv``
    (``conv_width − 1`` shifted copies of x and of B/C), a ``jax.jit``-wrapped
    function whose outputs XLA's partial evaluation keeps; no product."""
    if cfg.ssm is None or policy not in ("dots", "dots_no_batch"):
        return Counter()
    n = cfg.ssm.conv_width - 1
    return Counter({B * S * cfg.d_inner: n, B * S * 2 * cfg.ssm.n_groups * cfg.ssm.d_state: n})


@pytest.mark.parametrize("policy", POLICY_NAMES[1:])
@pytest.mark.parametrize("model", list(MODELS))
def test_saved_values_match_reference_residuals(model, policy, monkeypatch):
    """What SAC keeps for one period equals, by count and size, what the
    reference's ``jax.ad_checkpoint.print_saved_residuals`` lists for it
    (JAX 0.9 labels a named value "output of reduce_precision", so the sizes
    are compared), plus the value that ends the period (``LAST``), less the
    reference's own extras (``_jax_only``)."""
    cfg, ref_cfg = small(model, remat=policy)
    jp, tp = shared_params(ref_cfg)
    want = _ref_residuals(ref_cfg, jp, policy)
    got, _ = _port_saved(cfg, tp, policy, monkeypatch)
    extra = Counter({B * S * cfg.d_model: 1}) if model in LAST.get(policy, ()) else Counter()
    jax_only = _jax_only(cfg, policy)
    assert jax_only <= want
    assert got == want - jax_only + extra, (got - want, want - got)


#: what a kernel wrapper dispatches on the card besides the ctypes launch:
#: allocations and layout changes (an untagged alias among them)
WRAPPER_OPS = (torch.ops.aten.empty.memory_format, torch.ops.aten.empty_like.default,
               torch.ops.aten.empty_strided.default, torch.ops.aten.clone.default,
               torch.ops.aten._to_copy.default, torch.ops.aten.view.default,
               torch.ops.aten.alias.default)


@pytest.mark.parametrize("model", list(MODELS))
def test_kernel_route_keeps_nothing_a_kernel_wrapper_allocates(model, monkeypatch):
    """With ``use_flash`` (S = 128: flash takes S % 128 == 0) under every
    policy, SAC keeps only matrix products and tagged aliases, and asked
    about what a kernel wrapper dispatches on the card (``WRAPPER_OPS``, no
    product) every policy recomputes it: a ctypes launch writes what the
    dispatch mode cannot see.  Inside the wrappers, which run their plain
    versions here, nothing but those versions' own products is kept (none
    under a ``save:`` policy; MLA takes no kernel with products), and outside
    them the same values are kept as on the plain route, less, under
    ``dots``, the plain attention's and SSD chunk's own products."""
    for policy in POLICY_NAMES[2:]:
        cfg, ref_cfg = small(model, remat=policy, use_flash=True)
        _, tp = shared_params(ref_cfg)
        _, log = _port_saved(cfg, tp, policy, monkeypatch, seq=128)
        for op, name, _, _, _ in saved(log):
            assert op in rp.PRODUCTS or (op is torch.ops.aten.alias.default and name), op
        _, pol = rp.resolve_remat(policy)
        assert {pol(None, op) for op in WRAPPER_OPS} == {CheckpointPolicy.PREFER_RECOMPUTE}
        inside = [entry for entry in log if entry[2]]
        assert inside and all(op in rp.PRODUCTS for op, *_ in saved(inside)), policy
        if policy.startswith("save:") or model == "minicpm3":
            assert not saved(inside), policy
        outside = Counter(int(np.prod(e[3])) for e in saved(log) if not e[2])
        plain, _ = _port_saved(replace(cfg, use_flash=False), tp, policy, monkeypatch,
                               seq=128)
        if policy == "dots" and model != "minicpm3":
            assert outside < plain, policy
        else:
            assert outside == plain, policy


def test_backward_recomputes_no_product_under_dots():
    """A dispatch mode counts the matrix products of one step's backward
    (gemma3, 12 layers: two scanned periods, plain route).  With F products
    in the forward, R of them inside the periods: ``none`` and ``dots`` run
    2F (two a product, none again), ``full`` 3 a recomputed product — 2F + R
    with checkpoint's early stop off, one fewer a period with it on (the
    recompute stops before the period's last product, whose output no
    backward reads) — and ``dots_no_batch`` recomputes only the batched
    products, in between."""
    cfg, ref_cfg = small("gemma3", n_layers=12)
    _, tp = shared_params(ref_cfg)
    leaves = tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    x, y = (torch.from_numpy(a) for a in _tokens(cfg))
    n_periods = cfg.n_layers // cfg.scan_period()

    def products(policy, early_stop=True):
        fwd, bwd = Products(), Products()
        with set_checkpoint_early_stop(early_stop):
            with fwd:
                out, _ = loss.lm_loss(tp, replace(cfg, remat=policy), x, y)
            with bwd:
                torch.autograd.grad(out, leaves)
        return fwd.n, bwd.n

    F, none = products("none")
    R = F - 1                                # all but the head's product are scanned
    assert products("dots") == (F, 2 * F) and none == 2 * F
    assert products("full", early_stop=False) == (F, 2 * F + R)
    assert products("full") == (F, 2 * F + R - n_periods)
    _, no_batch = products("dots_no_batch")
    assert 2 * F < no_batch < 2 * F + R - n_periods
    # remat=None keeps everything, as in the reference (it used to recompute)
    assert products(None) == (F, 2 * F)
    assert ref_rp.resolve_remat(None) == (False, None)


def test_forward_hidden_refuses_an_unknown_policy_like_reference():
    """The reference raises on ``remat="bogus"``; the port used to take any
    name but ``"none"`` as full recompute, and raises now too — also without
    gradients, where it does not checkpoint."""
    cfg, ref_cfg = small("gemma3", remat="bogus")
    jp, tp = shared_params(ref_cfg)
    x, _ = _tokens(cfg)
    with pytest.raises(ValueError, match="unknown remat policy 'bogus'"):
        ref_transformer.forward_hidden(jp, ref_cfg, jnp.asarray(x))
    with pytest.raises(ValueError, match="unknown remat policy 'bogus'"):
        transformer.forward_hidden(tp, cfg, torch.from_numpy(x))
    with torch.no_grad(), pytest.raises(ValueError, match="unknown remat policy"):
        transformer.forward_hidden(tp, cfg, torch.from_numpy(x))
