"""The port's copy of MONET's inference-serving model
(``repro_torch.core.serving``: KV-cache graphs, continuous batching, request
mixes) and the serving sweep, held against ``repro.core``.

Each test of ``tests/test_serving.py`` has a counterpart here that runs the
port's function, asserts the same property and, on the same inputs, equality
with the reference: graphs field by field, and every ``ServeResult`` field
equal (not close).  ``test_serve_lm_example_writes_pareto_csv`` drives
``examples/serve_lm.py``, which the port has no twin of yet (ROADMAP A10);
``test_launch_serve_cli`` is held in ``tests/test_torch_cli.py``.

Trap held here: ``_percentile`` walks the samples in sorted order and adds
normalized weights one at a time, and ``RequestMix.weights`` divides each
weight by their ``sum()`` (compensated since Python 3.12, unlike a running
``+=`` or ``np.sum``); a reordered or re-associated sum moves the last bit,
so the copies are held equal on weights chosen to expose that."""

import importlib

import numpy as np
import pytest
from test_torch_core import canonical
from test_torch_parallel import same

import repro.core as ref
import repro_torch.core as core
from repro_torch.core.memory import KV_CACHE

serving = importlib.import_module("repro_torch.core.serving")
ref_serving = importlib.import_module("repro.core.serving")

TINY = dict(d_model=64, n_layers=2, n_heads=4, vocab=256)
POLICIES = ("KEEP", "RECOMPUTE", "OFFLOAD")


def serve(n, policy="KEEP", mem_mb=None, **kw):
    """The port's ``evaluate_serve`` on ``edge_cluster(n)``, held equal to the
    reference's, every field."""
    ckw = {} if mem_mb is None else dict(mem_mb=mem_mb)
    got = core.evaluate_serve(core.edge_cluster(n, **ckw),
                              policy=core.ActivationPolicy[policy], **kw)
    want = ref.evaluate_serve(ref.edge_cluster(n, **ckw),
                              policy=ref.ActivationPolicy[policy], **kw)
    same(got, want)
    assert got.as_row() == want.as_row()
    return got


@pytest.fixture(scope="module")
def hda():
    return core.edge_cluster(1).chip, ref.edge_cluster(1).chip


# -- kv tensor category + graph structure -----------------------------------------------


def test_kv_nodes_classify_as_kv_cache():
    g = core.gpt2_decode_graph(batch=2, past=32, **TINY)
    assert canonical(g) == canonical(ref.gpt2_decode_graph(batch=2, past=32, **TINY))
    kv = [nd.outputs[0] for nd in g.nodes.values() if nd.kind == "kv" and nd.outputs]
    assert kv
    assert all(core.tensor_category(g, t) == KV_CACHE for t in kv)
    other = [nd.outputs[0] for nd in g.nodes.values() if nd.kind != "kv" and nd.outputs]
    assert all(core.tensor_category(g, t) != KV_CACHE for t in other)


def test_decode_graph_shapes_and_memo():
    g = core.gpt2_decode_graph(batch=4, past=64, **TINY)
    g2 = core.gpt2_decode_graph(batch=4, past=64, **TINY)
    assert list(g2.nodes) == list(g.nodes) and g2.tensors.keys() == g.tensors.keys()
    appends = [nd for nd in g.nodes.values() if nd.op == "concat" and nd.kind == "kv"]
    assert len(appends) == 2 * TINY["n_layers"]
    assert all(g.tensors[nd.outputs[0]].shape[2] == 65 for nd in appends)
    assert canonical(g2) == canonical(ref.gpt2_decode_graph(batch=4, past=64, **TINY))


def test_prefill_decode_verify_clean():
    cases = [("gpt2_prefill_graph", dict(batch=1, seq=64)),
             ("gpt2_decode_graph", dict(batch=4, past=64)),
             ("gpt2_decode_graph", dict(batch=4, past=64, kv_paged=True)),
             ("gpt2_decode_graph", dict(batch=2, past=32, tp=2))]
    for fn, kw in cases:
        g = getattr(core, fn)(**kw, **TINY)
        assert core.verify_graph(g) == []
        assert canonical(g) == canonical(getattr(ref, fn)(**kw, **TINY))


def _broken_kv(m):
    b = m.GraphBuilder("broken_kv")
    x = b.input("x", (2, 4, 1, 16), "bfloat16")
    ka = b.kv_append(b.kv_input("kc", (2, 4, 32, 16)), x, name="cat")
    b.g.nodes["cat"].dims["N"] = 1
    b.kv_commit([ka])
    return b.g


def _dead_kv(m):
    b = m.GraphBuilder("dead_kv")
    b.kv_input("kc", (2, 4, 32, 16))
    return b.g


@pytest.mark.parametrize("build", [_broken_kv, _dead_kv], ids=["broken_append", "dead_read"])
def test_m025_fires_on_broken_kv(build):
    """``test_m025_fires_on_broken_kv_append`` and
    ``test_m025_fires_on_dead_kv_read``: M025 fires, the findings are the
    reference's."""
    findings = core.verify_graph(build(core))
    assert any(f.rule == "M025" for f in findings), findings
    same(findings, ref.verify_graph(build(ref)))


# -- engine-vs-reference lifetime parity on decode graphs -------------------------------


@pytest.mark.parametrize("paged", [False, True])
def test_decode_engine_matches_reference(hda, paged):
    g = core.gpt2_decode_graph(batch=4, past=64, kv_paged=paged, **TINY)
    res = core.schedule(g, hda[0], engine=core.get_engine(hda[0]))
    naive = core.schedule(g, hda[0], use_engine=False)
    assert (res.latency, res.energy, res.peak_mem, res.mem_breakdown, res.spill_bytes) == \
        (naive.latency, naive.energy, naive.peak_mem, naive.mem_breakdown, naive.spill_bytes)
    assert res.mem_breakdown.get(KV_CACHE, 0) > 0
    same(res, ref.schedule(ref.gpt2_decode_graph(batch=4, past=64, kv_paged=paged, **TINY),
                           hda[1]))


def test_paged_decode_spills_kv_one_way(hda):
    keep = core.schedule(core.gpt2_decode_graph(batch=4, past=256, **TINY), hda[0])
    paged = core.schedule(core.gpt2_decode_graph(batch=4, past=256, kv_paged=True, **TINY),
                          hda[0])
    assert keep.spill_bytes == 0 and paged.spill_bytes > 0
    assert paged.peak_mem < keep.peak_mem
    assert paged.mem_breakdown.get(KV_CACHE, 0) < keep.mem_breakdown.get(KV_CACHE, 0)
    same(paged, ref.schedule(ref.gpt2_decode_graph(batch=4, past=256, kv_paged=True, **TINY),
                             hda[1]))


# -- continuous-batching evaluation: policy semantics -----------------------------------


def test_request_mix_validation():
    with pytest.raises(ValueError):
        core.RequestClass("bad", prompt=0, decode=8)
    with pytest.raises(ValueError):
        core.RequestMix(())
    assert abs(sum(core.DEFAULT_MIX.weights) - 1.0) < 1e-12
    assert core.RequestClass("c", prompt=128, decode=64).steady_ctx == 160
    same(core.DEFAULT_MIX, ref.DEFAULT_MIX)
    assert core.GPT2_SMALL == ref.GPT2_SMALL


def test_weights_and_percentile_keep_the_references_float_order():
    rng = np.random.default_rng(0)
    w = [0.1, 0.2, 0.3] + [float(x) for x in rng.random(4) * [1e-3, 7, 1e2, 3]]
    assert (w[0] + w[1]) + w[2] != (w[2] + w[1]) + w[0]  # a running sum shows its order
    mixes = [m.RequestMix(tuple(m.RequestClass(f"c{i}", prompt=8 * (i + 1), decode=4,
                                               weight=x) for i, x in enumerate(w)))
             for m in (core, ref)]
    assert mixes[0].weights == mixes[1].weights
    assert mixes[0].mean(lambda c: c.prompt) == mixes[1].mean(lambda c: c.prompt)
    for _ in range(20):
        samples = [(float(v), float(x)) for v, x in zip(rng.random(9), rng.random(9) * 5,
                                                        strict=True)]
        # the quantiles at the samples' own cumulative weights, summed back to
        # front: each lands within an ulp of a step, where the slack decides
        tot = sum(x for _, x in samples)
        norm = [x / tot for _, x in sorted(samples)]
        steps = [sum(reversed(norm[:i])) for i in range(1, len(norm) + 1)]
        for q in (0.0, 0.25, 0.5, 0.9, 0.99, 1.0, *steps):
            assert serving._percentile(samples, q) == ref_serving._percentile(samples, q)


def test_bucket_powers_of_two():
    assert serving._bucket(1) == 16
    assert serving._bucket(129) == 256
    assert serving._bucket(256) == 256
    assert [serving._bucket(n) for n in range(1, 3000, 7)] == \
        [ref_serving._bucket(n) for n in range(1, 3000, 7)]


def test_kv_bytes_per_token_sharding():
    full = core.kv_bytes_per_token()
    assert full == 2 * core.GPT2_SMALL["n_layers"] * core.GPT2_SMALL["d_model"] * 2
    assert core.kv_bytes_per_token(n_chips=4) == full // 4
    for kw in ({}, dict(n_chips=4), dict(model=TINY, dtype="float32")):
        assert core.kv_bytes_per_token(**kw) == ref.kv_bytes_per_token(**kw)


def test_policy_semantics_small_cluster():
    res = {p: serve(1, p, slots=4, model=TINY) for p in POLICIES}
    keep, rec, off = (res[p] for p in POLICIES)
    assert keep.feasible and keep.rps >= off.rps
    assert off.peak_mem <= keep.peak_mem and off.kv_bytes < keep.kv_bytes
    assert rec.kv_bytes == 0 and rec.rps < keep.rps
    for r in res.values():
        assert r.watts > 0 and r.tokens_per_joule > 0
        assert r.p99_ms >= r.p50_ms > 0


def test_keep_thrashes_over_capacity():
    keep = serve(1, "KEEP", mem_mb=8.0, slots=64)
    off = serve(1, "OFFLOAD", mem_mb=8.0, slots=64)
    assert not keep.feasible
    assert off.peak_mem < keep.peak_mem
    assert off.rps > keep.rps


def test_evaluate_serve_rejects_bad_tp():
    for chips, slots in ((5, 4), (1, 0)):
        msgs = []
        for m in (core, ref):
            with pytest.raises(ValueError) as e:
                m.evaluate_serve(m.edge_cluster(chips), slots=slots)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def test_max_keep_slots_consistent():
    n = core.max_keep_slots(core.edge_cluster(4), ctx=512)
    assert n > 0
    assert core.max_keep_slots(core.edge_cluster(4), ctx=1024) <= n
    for site in ("edge_cluster", "datacenter_cluster"):
        for chips, ctx in ((1, 256), (4, 512), (4, 1024), (12, 4096)):
            assert core.max_keep_slots(getattr(core, site)(chips), ctx) == \
                ref.max_keep_slots(getattr(ref, site)(chips), ctx)


# -- sweep_serve: fronts across cluster sizes -------------------------------------------


@pytest.fixture(scope="module")
def edge_points():
    """(port's points, reference's points), equal field by field."""
    got = core.sweep_serve(core.edge_cluster, [1, 4], slots_list=(4, 64))
    want = ref.sweep_serve(ref.edge_cluster, [1, 4], slots_list=(4, 64))
    same(got, want)
    return got, want


def test_sweep_serve_covers_grid(edge_points):
    got, want = edge_points
    assert len(got) == 12
    assert {p.n_chips for p in got} == {1, 4}
    assert {p.policy for p in got} == set(POLICIES)
    assert [p.row() for p in got] == [p.row() for p in want]


OBJS = (lambda p: -p.result.rps, lambda p: p.result.p99_ms, lambda p: p.result.peak_mem,
        lambda p: p.result.watts)


def test_sweep_serve_front_spans_cluster_sizes(edge_points):
    front = core.pareto_front(edge_points[0], OBJS)
    assert len(front) >= 2
    assert {p.n_chips for p in front} == {1, 4}
    same(front, ref.pareto_front(edge_points[1], OBJS))


def test_offload_dominates_keep_at_scale(edge_points):
    cells = {(p.n_chips, p.slots, p.policy): p.result for p in edge_points[0]}
    dominated = 0
    for chips, slots in [(1, 64), (4, 64)]:
        keep, off = cells[(chips, slots, "KEEP")], cells[(chips, slots, "OFFLOAD")]
        if off.rps >= keep.rps and off.p99_ms <= keep.p99_ms and off.peak_mem < keep.peak_mem:
            dominated += 1
            assert not keep.feasible and off.feasible
    assert dominated >= 1


def test_sweep_serve_skips_invalid_tp_cells():
    assert core.sweep_serve(core.edge_cluster, [5], slots_list=(4,)) == []
    assert ref.sweep_serve(ref.edge_cluster, [5], slots_list=(4,)) == []


# -- sanitizer contract on the serving path ---------------------------------------------


def test_serving_clean_under_sanitizer(monkeypatch):
    eng = core.get_engine(core.edge_cluster(1).chip)
    clean = {p: core.evaluate_serve(core.edge_cluster(1), slots=4,
                                    policy=core.ActivationPolicy[p], model=TINY,
                                    engine=eng).as_row() for p in POLICIES}
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    for p in POLICIES:
        assert core.evaluate_serve(core.edge_cluster(1), slots=4,
                                   policy=core.ActivationPolicy[p], model=TINY,
                                   engine=eng).as_row() == clean[p]
        assert clean[p] == ref.evaluate_serve(ref.edge_cluster(1), slots=4,
                                              policy=ref.ActivationPolicy[p],
                                              model=TINY).as_row()
