"""The spans and counters of ``repro_torch.core.spans`` on the CPU: smoke
mamba2 and olmoe training steps inside ``torch.profiler`` sessions (CPU
activity only) and outside them.

On, every span of the module's list appears with the phases its code runs in
(``rec`` only under remat); the backward intervals of the stages form a chain
inside ``step.backward`` that no recompute overlaps; SAC's policy judges the
same operators as without a session, and they are counted.  Off, nothing is
recorded or hooked.  Either way the loss, the gradients and the updated
parameters are the same bit for bit, and a trace of the step
(``core/trace.py``) records the same nodes, one a kernel launch."""

import gc
from contextlib import nullcontext
from dataclasses import replace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, \
    create_selective_checkpoint_contexts

import repro_torch.configs as configs
from repro_torch.convert import tree_leaves
from repro_torch.core import remat_policy as rp
from repro_torch.core import spans
from repro_torch.core.trace import recording
from repro_torch.kernels import ops
from repro_torch.models.transformer import init_params
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.training.train_step import make_train_step

ARCHS = {"mamba2": "mamba2-1.3b", "olmoe": "olmoe-1b-7b"}
MIXER = {"mamba2": ("ssm.proj_in", "ssm.conv", "ssm.chunk", "ssm.scan", "ssm.gate",
                    "ssm.proj_out"),
         "olmoe": ("attn", "moe.route", "moe.dispatch", "moe.experts", "moe.combine")}
KERNELS = {"mamba2": ({"rmsnorm", "ssd_chunk", "causal_conv"},
                      {"rmsnorm_bwd", "ssd_chunk_bwd", "causal_conv_bwd"}),
           "olmoe": ({"rmsnorm", "flash_fwd"}, {"rmsnorm_bwd", "flash_dq", "flash_dkv"})}
STEP = ("step", "step.forward", "step.backward", "step.optimizer")


def smoke(model, remat):
    """A smoke config on the kernels' route (their plain versions here), its
    train step, fresh parameters and AdamW state, and a batch of 2 × 128."""
    cfg = replace(configs.smoke_config(ARCHS[model]), remat=remat, use_flash=True)
    opt = make_optimizer("adamw", 1e-3)
    params = init_params(cfg, 0, "cpu")
    toks = torch.randint(0, cfg.vocab, (2, 129), generator=torch.Generator().manual_seed(1))
    return cfg, make_train_step(cfg, opt), params, opt.init(params), \
        {"inputs": toks[:, :-1], "labels": toks[:, 1:]}


def profiled_step(model, remat):
    """One step inside a session: (its record, the step's outputs)."""
    cfg, step, params, state, batch = smoke(model, remat)
    n = len(spans.steps())
    with profile(activities=[ProfilerActivity.CPU]):
        out = step(params, state, batch, 0)
    recs = spans.steps()
    assert len(recs) == min(n + 1, spans.KEEP)
    return cfg, recs[-1], out


def expected(model, remat, n_layers):
    """name → (phases, count in the forward) of a step's spans, the
    collector's left out."""
    fwd = {"fwd", "rec"} if remat != "none" else {"fwd"}
    stage = fwd | {"bwd"}
    kf, kb = KERNELS[model]
    want = {name: ({"fwd"}, 1) for name in STEP}
    want["loss.head"] = ({"fwd", "bwd"}, 1)
    want["kernel.fused_adam"] = ({"fwd"}, 2)
    if model == "mamba2":
        # ln1 and the final norm are stages; the gated norm lies inside ssm.gate
        want["norm"] = (stage, 2 * n_layers + 1)
        want.update({name: (stage, n_layers) for name in MIXER[model]})
        want["ssm.proj_in"] = (stage, 2 * n_layers)     # the fourth projection apart
    else:
        want["norm"] = (stage, 2 * n_layers + 1)
        want.update({name: (stage, n_layers) for name in MIXER[model]})
        want["moe.route"] = (stage, 2 * n_layers)       # the aux loss apart
    want.update({f"kernel.{k}": (fwd, None) for k in kf})
    want.update({f"kernel.{k}": ({"bwd"}, None) for k in kb})
    return want


@pytest.mark.parametrize("remat", ["none", "dots", "full"])
@pytest.mark.parametrize("model", ["mamba2", "olmoe"])
def test_names_and_phases(model, remat):
    cfg, rec, _ = profiled_step(model, remat)
    got = {name: by_phase for name, by_phase in rec["spans"].items()
           if not name.startswith("gc.gen")}
    want = expected(model, remat, cfg.n_layers)
    assert set(got) == set(want)
    for name, (phases, count) in want.items():
        assert set(got[name]) == phases, name
        if count is not None:
            assert got[name]["fwd"]["count"] == count, name
        for d in got[name].values():
            assert d["stream_ms"] is None and d["host_ms"] >= 0.0     # no CUDA events here
    assert rec["launches"] == 0                                      # plain versions only
    assert (rec["policy_ops"] is None) == (remat != "dots")


def _bwd_chain(rec):
    return sorted((s[0], s[1], name) for name, phase, top, segs in rec["intervals"]
                  if phase == "bwd" and top for s in segs)


@pytest.mark.parametrize("model,remat", [("mamba2", "dots"), ("olmoe", "none"),
                                         ("olmoe", "dots")])
def test_backward_stages_form_a_chain(model, remat):
    """The stages' backward intervals do not overlap, lie inside
    ``step.backward``, run the layer's stages in reverse order, and no
    outermost ``rec`` stage overlaps one (the recompute pauses it)."""
    cfg, rec, _ = profiled_step(model, remat)
    (sb,) = [segs[0] for name, _, _, segs in rec["intervals"] if name == "step.backward"]
    chain = _bwd_chain(rec)
    for (a0, a1, _), (b0, b1, _) in zip(chain, chain[1:]):
        assert a0 <= a1 <= b0 <= b1
    assert sb[0] <= chain[0][0] and chain[-1][1] <= sb[1]
    # a stage paused by a recompute is two segments
    order = [name for i, (_, _, name) in enumerate(chain) if i == 0 or chain[i - 1][2] != name]
    assert order[:2] == ["loss.head", "norm"]
    last_layer = {"mamba2": ["ssm.proj_out", "ssm.gate", "ssm.scan", "ssm.chunk",
                             "ssm.proj_in", "ssm.conv", "ssm.proj_in", "norm"],
                  "olmoe": ["moe.route", "moe.combine", "moe.experts", "moe.dispatch",
                            "moe.route", "norm", "attn", "norm"]}[model]
    assert order[2:2 + len(last_layer)] == last_layer
    assert order == order[:2] + last_layer * cfg.n_layers
    rec_top = [(s[0], s[1]) for name, phase, top, segs in rec["intervals"]
               if phase == "rec" and top for s in segs]
    assert bool(rec_top) == (remat != "none")
    for r0, r1 in rec_top:
        assert all(r1 <= b0 or b1 <= r0 for b0, b1, _ in chain)


def test_off_records_and_hooks_nothing(monkeypatch):
    cfg, step, params, state, batch = smoke("mamba2", "dots")
    hooks = []
    monkeypatch.setattr(torch.Tensor, "register_hook",
                        lambda self, fn: hooks.append(fn))
    monkeypatch.setattr(torch.autograd.graph, "register_multi_grad_hook",
                        lambda *a, **k: hooks.append(a))
    n = len(spans.steps())
    step(params, state, batch, 0)
    assert len(spans.steps()) == n and hooks == []
    assert spans.span("ssm.conv") is spans.span("norm") is spans.step("cpu")
    assert spans.counted(rp.checkpoint_dots) is rp.checkpoint_dots


def _judged(monkeypatch, session: bool):
    """The operators SAC's ``dots`` policy judges over one mamba2 step, and the
    step's record (``None`` outside a session)."""
    seen = []

    def dots(ctx, op, *args, **kwargs):
        seen.append((str(op), ctx.is_recompute))
        return rp.checkpoint_dots(ctx, op, *args, **kwargs)

    monkeypatch.setitem(rp.POLICIES, "dots", dots)
    cfg, step, params, state, batch = smoke("mamba2", "dots")
    if not session:
        step(params, state, batch, 0)
        return seen, None
    with profile(activities=[ProfilerActivity.CPU]):
        step(params, state, batch, 0)
    return seen, spans.steps()[-1]


def test_policy_judges_the_same_operators(monkeypatch):
    off, _ = _judged(monkeypatch, False)
    on, rec = _judged(monkeypatch, True)
    assert on == off and not any("profiler" in op for op, _ in on)
    assert rec["policy_ops"] == len(on) > 0


def test_record_function_would_reach_the_policy():
    """Why the spans open ``_RecordFunctionFast``: ``record_function`` is
    dispatched as operators that a policy then judges; the fast form is not."""
    for fast in (False, True):
        seen = []

        def policy(ctx, op, *args, **kwargs):
            seen.append(str(op))
            return CheckpointPolicy.PREFER_RECOMPUTE

        def f(x, w, fast=fast):
            cm = torch._C._profiler._RecordFunctionFast("s") if fast else record_function("s")
            with cm:
                return torch.relu(x @ w).sum()

        x, w = (torch.randn(8, 8, requires_grad=True) for _ in range(2))
        with profile(activities=[ProfilerActivity.CPU]):
            checkpoint(f, x, w, use_reentrant=False,
                       context_fn=lambda p=policy: create_selective_checkpoint_contexts(p)
                       ).backward()
        assert any("profiler" in op for op in seen) != fast


@pytest.mark.parametrize("model,remat", [("mamba2", "dots"), ("olmoe", "dots"),
                                         ("mamba2", "full")])
def test_bit_identical_with_and_without_a_session(model, remat):
    _, step, params, state, batch = smoke(model, remat)
    p0, s0, m0 = step(params, state, batch, 0)
    _, step, params, state, batch = smoke(model, remat)
    with profile(activities=[ProfilerActivity.CPU]):
        p1, s1, m1 = step(params, state, batch, 0)
    for k in ("loss", "aux_loss", "grad_norm"):
        assert torch.equal(m0[k], m1[k]), k
    # AdamW's first moment after one step is (1 − b1)·g: the gradients
    for a, b in zip(tree_leaves(p0) + tree_leaves(s0), tree_leaves(p1) + tree_leaves(s1),
                    strict=True):
        assert torch.equal(a, b)


def test_collector_pass_is_a_span(monkeypatch):
    adam = ops.fused_adam_multi

    def collecting(*args, **kwargs):
        gc.collect()
        return adam(*args, **kwargs)

    monkeypatch.setattr(ops, "fused_adam_multi", collecting)
    _, rec, _ = profiled_step("olmoe", "none")
    assert rec["spans"]["gc.gen2"]["fwd"]["count"] >= 1
    assert rec["spans"]["gc.gen2"]["fwd"]["top_host_ms"] == 0.0     # not a stage


@pytest.mark.parametrize("model", ["mamba2", "olmoe"])
def test_trace_records_one_node_a_launch_under_a_session(model):
    """The kernel spans sit inside the tracer's node: the same graph with and
    without a session."""
    graphs = []
    for session in (False, True):
        _, step, params, state, batch = smoke(model, "dots")
        step(*smoke(model, "dots")[2:], 0)            # caches filled
        with profile(activities=[ProfilerActivity.CPU]) if session else nullcontext():
            with recording(model, params=params, inputs=(state, batch)) as rec:
                step(params, state, batch, 0)
        graphs.append((rec.kernel_nodes, len(rec.graph.nodes),
                       sorted(n.op for n in rec.graph.nodes.values())))
    assert graphs[0] == graphs[1] and sum(graphs[0][0].values()) > 0
