"""The port's copies of MONET's parallel-training model and its DSE drivers
(``repro_torch.core.parallel`` and ``dse``) held against ``repro.core``.

Each test of ``tests/test_parallel.py`` has a counterpart here that runs the
port's function, asserts the same property and, on the same inputs, equality
with the reference: exact for stage graphs (field by field, ``canonical``),
plans, ``ParallelResult`` (its stage and body schedules included), wire
bytes and fronts.  So do ``ga_parallel`` and ``sweep`` from
``test_nsga2.py`` and ``test_engine_batch.py``.

Traps held here: ``parallel._rewrite`` keys its LRU on the engine's
``_SIG_GEN`` and ``_fingerprint`` and reads ``sanitize_enabled``; each must
be the port's own, so the port's rewrites count in the port's
``rewrite_cache_stats`` and sign in the port's engine only
(``test_module_state_is_the_ports_own``).  ``ga_parallel`` draws through
``nsga2_int`` with its ``seed`` and ``sweep(sample=)`` through
``random.Random(seed)`` over the dict order of ``space``: the fronts and the
sampled points are the reference's, bit for bit."""

import importlib

import numpy as np
import pytest
from test_torch_core import as_plain, canonical

import repro.core as ref
import repro_torch.core as core
from repro_torch.core.engine import _NODE_COSTS, EvalEngine, sign_count
from repro_torch.core.fusion import repair_partition
from repro_torch.core.parallel import _local_batch, rewrite_cache_stats

parallel = importlib.import_module("repro_torch.core.parallel")
ref_parallel = importlib.import_module("repro.core.parallel")
ref_engine = importlib.import_module("repro.core.engine")


def same(got, want):
    assert as_plain(got) == as_plain(want)


@pytest.fixture(autouse=True)
def cold_rewrite_caches():
    """Each test starts from empty rewrite caches on both sides, as a fresh
    process does.  ``tests/test_verify.py``'s M030–M032 corrupt the stage
    graphs of a cached rewrite in place, and a worker that ran that file
    first would serve them to the reference's side here."""
    parallel._REWRITES.clear()
    ref_parallel._REWRITES.clear()


def both(build):
    """(reference, port) of one zoo training graph, each side's own builder;
    the two graphs are equal field by field."""
    want = build(ref)
    got = build(core)
    assert canonical(got.graph) == canonical(want.graph)
    assert got.param_grads == want.param_grads
    return want, got


@pytest.fixture(scope="module")
def mlp_tg():
    return both(lambda m: m.build_training_graph(m.mlp_graph(8), "adam"))


@pytest.fixture(scope="module")
def rn_tg():
    return both(lambda m: m.build_training_graph(m.resnet18_graph(2, 32), "adam"))


@pytest.fixture(scope="module")
def gpt_tg():
    return both(lambda m: m.build_training_graph(m.gpt2_graph(1, 64, 64, 2, 2, 256), "adam"))


def plans(tgs, cluster, n, **kw):
    """(reference plan, port plan) for one strategy on ``cluster(n)``."""
    want = ref.parallelize(tgs[0], ref.ParallelStrategy(**kw), getattr(ref, cluster)(n))
    got = core.parallelize(tgs[1], core.ParallelStrategy(**kw), getattr(core, cluster)(n))
    same(got, want)
    return want, got


# -- strategies + collective formulas ---------------------------------------------------


def test_strategy_space_covers_factorizations():
    strats = core.strategy_space(8)
    assert all(s.chips == 8 for s in strats)
    labels = {s.label for s in strats}
    assert "dp8" in labels and "tp8" in labels and "pp8@mb16" in labels
    assert len(strats) == 10
    same(strats, ref.strategy_space(8))
    assert [s.label for s in strats] == [s.label for s in ref.strategy_space(8)]
    with_zero = core.strategy_space(4, include_zero=True)
    assert any(s.zero for s in with_zero)
    same(with_zero, ref.strategy_space(4, include_zero=True))
    with pytest.raises(ValueError):
        core.ParallelStrategy(data=0)


@pytest.mark.parametrize("topo", ["ring", "full"])
def test_collective_wire_formulas(topo):
    nbytes, p = 1024.0, 4
    for op in ("all_reduce", "all_gather", "reduce_scatter", "send", "recv"):
        assert core.collective_wire(op, nbytes, p, topo) == \
            ref.collective_wire(op, nbytes, p, topo)
    wire, hops = core.collective_wire("all_reduce", nbytes, p, topo)
    assert wire == pytest.approx(2 * 3 / 4 * nbytes)
    assert hops == 2 * (p - 1) if topo == "ring" else hops < 2 * (p - 1)
    assert core.collective_wire("send", nbytes, p, topo) == (nbytes, 1)
    assert core.collective_wire("recv", nbytes, p, topo) == (0.0, 1)
    assert core.collective_wire("all_reduce", nbytes, 1) == (0.0, 0)
    with pytest.raises(ValueError):
        core.collective_wire("bogus", nbytes, p)


def test_comm_cycles_latency_vs_bandwidth():
    cyc = {}
    for m in (ref, core):
        fast = m.with_interconnect(m.edge_tpu(), bw=1e6, latency=100.0)
        slow = m.with_interconnect(m.edge_tpu(), bw=1.0, latency=100.0)
        nd = m.Node("ar", "all_reduce", "comm", dict(N=1 << 20, P=4, E=2), [], [])
        cyc[m] = (m.comm_cycles(nd, fast), m.comm_cycles(nd, slow))
    lat_bound, bw_bound = cyc[core]
    assert lat_bound == pytest.approx(6 * 100.0, rel=0.1)
    assert bw_bound > 1e6
    assert cyc[core] == cyc[ref]


# -- graph rewrites ---------------------------------------------------------------------


def test_data_parallel_inserts_gradient_allreduce(mlp_tg):
    _, plan = plans(mlp_tg, "edge_cluster", 4, data=4)
    (g,) = plan.stage_graphs
    ars = [n for n in g.nodes.values() if n.op == "all_reduce"]
    assert len(ars) == len(mlp_tg[1].param_grads)
    for nd in ars:
        assert nd.dims["P"] == 4
        assert any(g.nodes[c].kind == "opt" for c in g.consumers[nd.outputs[0]])
    g.validate()


def test_zero_shards_optimizer_states(mlp_tg):
    _, plan = plans(mlp_tg, "edge_cluster", 4, data=4, zero=True)
    (g,) = plan.stage_graphs
    ops = {n.op for n in g.nodes.values() if n.op_class == "comm"}
    assert "reduce_scatter" in ops and "all_gather" in ops
    base = mlp_tg[1].graph
    sharded = 0
    for t, spec in g.tensors.items():
        if t.startswith("m:") and not t.endswith(".next") and t in base.tensors:
            if base.tensors[t].shape[0] % 4 == 0:
                assert spec.size * 4 == base.tensors[t].size
                sharded += 1
            else:
                assert spec.size == base.tensors[t].size
    assert sharded > 0
    g.validate()


def test_tensor_parallel_shards_weights_and_comm(rn_tg):
    want, plan = plans(rn_tg, "edge_cluster", 2, tensor=2)
    (g,) = plan.stage_graphs
    assert plan.sharded_params and plan.sharded_params == want.sharded_params
    base = rn_tg[1].graph
    for w in plan.sharded_params:
        assert g.tensors[w].size * 2 == base.tensors[w].size
    ops = [n.op for n in g.nodes.values() if n.op_class == "comm"]
    assert ops.count("all_reduce") >= len(plan.sharded_params)
    assert ops.count("all_gather") >= 1
    assert g.total_flops() < base.total_flops()
    g.validate()


def test_pipeline_split_covers_and_balances(gpt_tg):
    _, plan = plans(gpt_tg, "datacenter_cluster", 2, pipeline=2, microbatches=4)
    assert len(plan.stage_graphs) == 2
    seen, sent, recv = set(), set(), set()
    for sg in plan.stage_graphs:
        sg.validate()
        own = {n for n, nd in sg.nodes.items() if nd.op not in ("send", "recv")}
        assert not (own & seen)
        seen |= own
        for nd in sg.nodes.values():
            if nd.op == "send":
                sent.add(nd.inputs[0])
            elif nd.op == "recv":
                recv.add(nd.outputs[0])
    assert seen == set(gpt_tg[1].graph.nodes)
    assert recv <= sent and sent
    f0, f1 = (sg.total_flops() for sg in plan.stage_graphs)
    assert min(f0, f1) > 0.2 * max(f0, f1)


@pytest.mark.parametrize("case", ["pipeline_too_deep", "cluster_mismatch"])
def test_rewrite_rejects_what_the_reference_rejects(mlp_tg, case):
    """``test_pipeline_degree_too_large_raises`` and
    ``test_strategy_cluster_mismatch``: both sides raise, with one message."""
    kw, n = (dict(pipeline=64), 64) if case == "pipeline_too_deep" else (dict(data=2), 4)
    msgs = []
    for m, tg in zip((ref, core), mlp_tg, strict=True):
        with pytest.raises(ValueError) as e:
            m.parallelize(tg, m.ParallelStrategy(**kw), m.edge_cluster(n))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# -- parity: engine path vs uncached path vs the reference ------------------------------


def assert_equal_results(a, b):
    assert (a.latency, a.energy, a.offchip_bytes, a.peak_mem, a.throughput, a.wire_bytes,
            a.feasible) == (b.latency, b.energy, b.offchip_bytes, b.peak_mem, b.throughput,
                            b.wire_bytes, b.feasible)


STRATS = [dict(data=4), dict(data=4, zero=True), dict(tensor=4),
          dict(pipeline=4, microbatches=8), dict(data=2, tensor=2),
          dict(data=2, pipeline=2, microbatches=4)]


@pytest.mark.parametrize("kw", STRATS, ids=lambda kw: core.ParallelStrategy(**kw).label)
@pytest.mark.parametrize("cluster", ["edge_cluster", "datacenter_cluster"], ids=["edge", "dc"])
def test_parallel_engine_parity(rn_tg, kw, cluster):
    """The port's cached and uncached evaluations equal each other and the
    reference's, every field (stage and body schedules included)."""
    s = core.ParallelStrategy(**kw)
    cached = core.evaluate_parallel(rn_tg[1], getattr(core, cluster)(4), s)
    naive = core.evaluate_parallel(rn_tg[1], getattr(core, cluster)(4), s, use_engine=False)
    assert_equal_results(cached, naive)
    for rc, rn in zip(cached.stage_results, naive.stage_results, strict=True):
        assert (rc.latency, rc.energy, rc.per_core_busy) == \
            (rn.latency, rn.energy, rn.per_core_busy)
    same(cached, ref.evaluate_parallel(rn_tg[0], getattr(ref, cluster)(4),
                                       ref.ParallelStrategy(**kw)))


def test_parallel_engine_parity_gpt2(gpt_tg):
    for kw in (dict(tensor=2, pipeline=2, microbatches=4), dict(data=4)):
        s = core.ParallelStrategy(**kw)
        cached = core.evaluate_parallel(gpt_tg[1], core.datacenter_cluster(4), s)
        naive = core.evaluate_parallel(gpt_tg[1], core.datacenter_cluster(4), s, use_engine=False)
        assert_equal_results(cached, naive)
        same(naive, ref.evaluate_parallel(gpt_tg[0], ref.datacenter_cluster(4),
                                          ref.ParallelStrategy(**kw), use_engine=False))


def test_parallel_schedule_parity_direct(mlp_tg):
    want_plan, plan = plans(mlp_tg, "edge_cluster", 2, data=2)
    res = []
    for m, p, rp in ((core, plan, repair_partition),
                     (ref, want_plan, ref.fusion.repair_partition)):
        (g,) = p.stage_graphs
        part = rp(g, m.manual_fusion(g))
        m.quotient_dag(g, part)
        res.append((m.schedule(g, p.cluster.chip, part),
                    m.schedule(g, p.cluster.chip, part, use_engine=False)))
    (a, b), (ra, rb) = res
    assert a.latency == b.latency and a.energy == b.energy
    assert a.per_core_busy == b.per_core_busy
    assert "ici" in a.per_core_busy
    same(a, ra)
    same(b, rb)


# -- engine cache-invalidation contract for parallel rewrites ---------------------------


def test_strategy_change_changes_signatures(mlp_tg):
    tg = mlp_tg[1]
    eng = core.get_engine(core.edge_cluster(2).chip)
    g2 = core.parallelize(tg, core.ParallelStrategy(data=2), core.edge_cluster(2)).stage_graphs[0]
    g4 = core.parallelize(tg, core.ParallelStrategy(data=4), core.edge_cluster(4)).stage_graphs[0]
    assert eng.bind(g2).fingerprint() != eng.bind(g4).fingerprint()
    r2 = core.evaluate_parallel(tg, core.edge_cluster(2), core.ParallelStrategy(data=2))
    r4 = core.evaluate_parallel(tg, core.edge_cluster(4), core.ParallelStrategy(data=4))
    assert r2.wire_bytes != r4.wire_bytes
    assert (r2.wire_bytes, r4.wire_bytes) == tuple(
        ref.evaluate_parallel(mlp_tg[0], ref.edge_cluster(n),
                              ref.ParallelStrategy(data=n)).wire_bytes
        for n in (2, 4))


def test_rewrite_invalidates_incrementally(mlp_tg):
    tg = mlp_tg[1]
    sigs_before = core.graph_sigs(tg.graph)
    n_before = len(sigs_before.sid)
    (g,) = core.parallelize(tg, core.ParallelStrategy(tensor=2), core.edge_cluster(2)).stage_graphs
    sigs_par = core.graph_sigs(g)
    assert core.graph_sigs(tg.graph) is sigs_before
    assert len(core.graph_sigs(tg.graph).sid) == n_before
    comm = [n for n in g.nodes if g.nodes[n].op_class == "comm"]
    assert comm and all(n in sigs_par.sid for n in comm)
    assert sigs_par.static < sigs_before.static
    (rg,) = ref.parallelize(mlp_tg[0], ref.ParallelStrategy(tensor=2),
                            ref.edge_cluster(2)).stage_graphs
    assert (sigs_par.static, sigs_par.tb) == (ref.graph_sigs(rg).static, ref.graph_sigs(rg).tb)


def test_replace_tensor_updates_static_and_bytes(mlp_tg):
    out = []
    for m, tg in zip((ref, core), mlp_tg, strict=True):
        g = tg.graph.copy()
        sigs = m.graph_sigs(g)
        w = next(t for t, s in g.tensors.items() if s.is_param)
        old, old_static = g.tensors[w], sigs.static
        g.replace_tensor(m.TensorSpec(w, (old.shape[0] // 2,) + old.shape[1:], old.dtype,
                                      is_param=True))
        sigs2 = m.graph_sigs(g)
        assert sigs2 is sigs
        assert sigs2.static == old_static - old.bytes // 2
        assert sigs2.tb[w] == old.bytes // 2
        a = m.schedule(g, m.edge_tpu())
        b = m.schedule(g, m.edge_tpu(), use_engine=False)
        assert a.peak_mem == b.peak_mem and a.latency == b.latency
        out.append((a, b))
    same(out[1], out[0])


def test_unrelated_chips_share_comm_cost_entries(mlp_tg):
    chip_a = core.with_interconnect(core.edge_tpu(), bw=8.0, latency=1000.0)
    chip_b = core.with_interconnect(core.edge_tpu(x_pes=2, y_pes=2), bw=8.0, latency=1000.0)
    assert chip_a.offchip_bw == chip_b.offchip_bw
    eng_a, eng_b = EvalEngine(chip_a), EvalEngine(chip_b)
    assert eng_a._ck_comm == eng_b._ck_comm
    core.evaluate_parallel(mlp_tg[1], core.ClusterSpec(chip_a, 2), core.ParallelStrategy(data=2),
                           engine=eng_a)
    comm_keys = {k for k in _NODE_COSTS if k[0] == eng_a._ck_comm}
    assert comm_keys
    core.evaluate_parallel(mlp_tg[1], core.ClusterSpec(chip_b, 2), core.ParallelStrategy(data=2),
                           engine=eng_b)
    assert {k for k in _NODE_COSTS if k[0] == eng_b._ck_comm} == comm_keys


def test_repeated_parallel_eval_hits_schedule_memo(rn_tg):
    cl = core.datacenter_cluster(2)
    eng = EvalEngine(cl.chip)
    a = core.evaluate_parallel(rn_tg[1], cl, core.ParallelStrategy(data=2), engine=eng)
    hits = eng.stats["sched_hits"]
    b = core.evaluate_parallel(rn_tg[1], cl, core.ParallelStrategy(data=2), engine=eng)
    assert eng.stats["sched_hits"] > hits
    assert_equal_results(a, b)
    same(b, a)


# -- composition semantics + sweep drivers ----------------------------------------------


def test_pipeline_bubble_accounting(mlp_tg):
    r = {m: core.evaluate_parallel(mlp_tg[1], core.edge_cluster(2),
                                   core.ParallelStrategy(pipeline=2, microbatches=m))
         for m in (2, 8)}

    def expected(res, m, pp):
        t_body = max(b.latency for b in res.body_results)
        tail = max(max(f.latency - b.latency, 0.0)
                   for f, b in zip(res.stage_results, res.body_results, strict=True))
        return (m + pp - 1) * t_body + tail

    assert r[2].latency == expected(r[2], 2, 2)
    assert r[8].latency == expected(r[8], 8, 2)
    assert r[8].throughput > r[2].throughput
    for m, res in r.items():
        same(res, ref.evaluate_parallel(mlp_tg[0], ref.edge_cluster(2),
                                        ref.ParallelStrategy(pipeline=2, microbatches=m)))


def test_iteration_tail_charged_once(mlp_tg):
    cl = core.edge_cluster(2)
    r1 = core.evaluate_parallel(mlp_tg[1], cl, core.ParallelStrategy(data=2, microbatches=1))
    r4 = core.evaluate_parallel(mlp_tg[1], cl, core.ParallelStrategy(data=2, microbatches=4))
    assert r4.wire_bytes == r1.wire_bytes
    assert r4.latency > r1.latency
    want_plan, plan = plans(mlp_tg, "edge_cluster", 2, data=2, microbatches=4)
    body = parallel._strip_iteration_tail(plan.stage_graphs[0])
    assert body is not None
    assert not [n for n in body.nodes.values()
                if n.kind == "opt" or (n.op_class == "comm" and
                                       n.outputs[0].endswith((".dpar", ".dprs", ".dpag")))]
    assert any(n.kind in ("bwd_data", "bwd_weight") for n in body.nodes.values())
    assert canonical(body) == \
        canonical(ref_parallel._strip_iteration_tail(want_plan.stage_graphs[0]))


def test_memory_ceiling_feasibility(rn_tg):
    for mem_mb, feasible in ((16, False), (4096, True)):
        got = core.evaluate_parallel(rn_tg[1], core.edge_cluster(2, mem_mb=mem_mb),
                                     core.ParallelStrategy(data=2))
        assert got.feasible is feasible
        same(got, ref.evaluate_parallel(rn_tg[0], ref.edge_cluster(2, mem_mb=mem_mb),
                                        ref.ParallelStrategy(data=2)))


def test_local_batch_and_samples(rn_tg):
    assert _local_batch(rn_tg[1].graph) == 2 == ref_parallel._local_batch(rn_tg[0].graph)
    r = core.evaluate_parallel(rn_tg[1], core.edge_cluster(4),
                               core.ParallelStrategy(data=4, microbatches=2))
    assert r.samples_per_iter == 2 * 4 * 2
    assert r.as_row() == ref.evaluate_parallel(rn_tg[0], ref.edge_cluster(4),
                                               ref.ParallelStrategy(data=4, microbatches=2)
                                               ).as_row()


def test_wire_bytes_consistency(mlp_tg):
    want, plan = plans(mlp_tg, "edge_cluster", 4, data=4)
    (g,) = plan.stage_graphs
    wb = core.graph_wire_bytes(g, plan.cluster.chip.ici_topology)
    grad_bytes = sum(mlp_tg[1].graph.tensors[dg].bytes for dg in mlp_tg[1].param_grads.values())
    assert wb == pytest.approx(2 * 3 / 4 * grad_bytes)
    assert wb == ref.graph_wire_bytes(want.stage_graphs[0], want.cluster.chip.ici_topology)


def test_sweep_parallel_rows(mlp_tg):
    pts = core.sweep_parallel({"mlp": mlp_tg[1]}, core.edge_cluster, [2])
    assert len(pts) == len(core.strategy_space(2))
    row = pts[0].row()
    for k in ("chips", "strategy", "mlp_latency", "mlp_throughput", "mlp_feasible"):
        assert k in row
    want = ref.sweep_parallel({"mlp": mlp_tg[0]}, ref.edge_cluster, [2])
    same(pts, want)
    assert [p.row() for p in pts] == [p.row() for p in want]


def test_nsga2_int_respects_bounds():
    def ev(x):
        return (float(x[0]), float((x[1] - 3) ** 2))

    res = core.nsga2_int(ev, [(0, 4), (1, 5)], pop_size=12, generations=6, seed=3)
    assert res.X.min() >= 0 and res.X[:, 0].max() <= 4
    assert res.X[:, 1].min() >= 1 and res.X[:, 1].max() <= 5
    assert res.pareto_F[:, 0].min() == 0.0 and res.pareto_F[:, 1].min() == 0.0
    same(res, ref.nsga2_int(ev, [(0, 4), (1, 5)], pop_size=12, generations=6, seed=3))


# -- strategy-keyed rewrite cache -------------------------------------------------------


def test_parallel_rewrite_cache_warm_bit_for_bit(mlp_tg, monkeypatch):
    """A repeat ``evaluate_parallel`` is served from the rewrite cache, bit for
    bit, with shared stage graphs (the sanitizer is held off here, which is
    what the reference's test needs to run)."""
    monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    cluster = core.edge_cluster(4)
    s = core.ParallelStrategy(data=2, pipeline=2, microbatches=4)
    engine = core.get_engine(cluster.chip)
    r0 = core.evaluate_parallel(mlp_tg[1], cluster, s, engine=engine)
    h0 = rewrite_cache_stats["hits"]
    r1 = core.evaluate_parallel(mlp_tg[1], cluster, s, engine=engine)
    assert rewrite_cache_stats["hits"] > h0
    same(r1, r0)
    p0 = core.parallelize(mlp_tg[1], s, cluster)
    p1 = core.parallelize(mlp_tg[1], s, cluster)
    assert [id(sg) for sg in p0.stage_graphs] == [id(sg) for sg in p1.stage_graphs]


def test_rewrite_cache_invalidates_on_graph_mutation():
    tg = core.build_training_graph(core.mlp_graph(8), "adam")
    cluster = core.edge_cluster(2)
    p0 = core.parallelize(tg, core.ParallelStrategy(data=2), cluster)
    nd = next(n for n in tg.graph.nodes.values() if n.op == "gemm")
    tg.graph.retune_node(nd.name, dims=dict(nd.dims), flops=nd.flops + 1)
    p1 = core.parallelize(tg, core.ParallelStrategy(data=2), cluster)
    assert p1.stage_graphs[0] is not p0.stage_graphs[0]
    rtg = ref.build_training_graph(ref.mlp_graph(8), "adam")
    rnd = rtg.graph.nodes[nd.name]
    rtg.graph.retune_node(nd.name, dims=dict(rnd.dims), flops=rnd.flops + 1)
    same(p1, ref.parallelize(rtg, ref.ParallelStrategy(data=2), ref.edge_cluster(2)))


def test_rewrite_cache_bypassed_under_sanitizer(mlp_tg, monkeypatch):
    cluster = core.edge_cluster(2)
    s = core.ParallelStrategy(data=2)
    r0 = core.evaluate_parallel(mlp_tg[1], cluster, s)
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    misses = rewrite_cache_stats["misses"]
    p_a = core.parallelize(mlp_tg[1], s, cluster)
    p_b = core.parallelize(mlp_tg[1], s, cluster)
    assert p_a.stage_graphs[0] is not p_b.stage_graphs[0]
    assert rewrite_cache_stats["misses"] == misses     # nothing served, nothing stored
    r1 = core.evaluate_parallel(mlp_tg[1], cluster, s)
    assert (r1.latency, r1.energy, r1.peak_mem) == (r0.latency, r0.energy, r0.peak_mem)


def test_module_state_is_the_ports_own(mlp_tg, monkeypatch):
    """The rewrite cache, its counters and the signing counter the port's
    ``parallel`` reaches are the port's: a cold port rewrite misses in the
    port's cache, signs in the port's engine, and leaves the reference's
    counters where they were."""
    monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    core.clear_engines()
    ref.clear_engines()
    ref_stats = dict(ref_parallel.rewrite_cache_stats)
    ref_signed = ref_engine.sign_count()
    misses, signed = rewrite_cache_stats["misses"], sign_count()
    tg = core.build_training_graph(core.mlp_graph(8), "adam")
    core.evaluate_parallel(tg, core.edge_cluster(2), core.ParallelStrategy(data=2, microbatches=2))
    assert rewrite_cache_stats["misses"] == misses + 1
    assert sign_count() > signed
    assert ref_parallel.rewrite_cache_stats == ref_stats
    assert ref_engine.sign_count() == ref_signed
    assert parallel.rewrite_cache_stats is rewrite_cache_stats is not \
        ref_parallel.rewrite_cache_stats


# -- ga_parallel (test_nsga2.py, test_engine_batch.py) ----------------------------------


@pytest.fixture(scope="module")
def tiny_tg():
    return both(lambda m: m.build_training_graph(m.mlp_graph(4, widths=(16, 16)), "adam"))


def test_ga_parallel_seed_determinism(tiny_tg):
    kw = dict(chip_counts=[1, 2], pop_size=6, generations=2, seed=5)
    r1, decode = core.ga_parallel(tiny_tg[1], core.edge_cluster, **kw)
    r2, _ = core.ga_parallel(tiny_tg[1], core.edge_cluster, **kw)
    np.testing.assert_array_equal(r1.pareto_X, r2.pareto_X)
    np.testing.assert_array_equal(r1.pareto_F, r2.pareto_F)
    r3, _ = core.ga_parallel(tiny_tg[1], core.edge_cluster, **{**kw, "seed": 6})
    assert (r3.X.shape != r1.X.shape) or not np.array_equal(r3.X, r1.X)
    want, ref_decode = ref.ga_parallel(tiny_tg[0], ref.edge_cluster, **kw)
    same(r1, want)
    for x in r1.pareto_X:
        same(decode(x), ref_decode(x))


def test_ga_parallel_resume_passthrough(tiny_tg, tmp_path):
    path = str(tmp_path / "ga.json")
    kw = dict(chip_counts=[1, 2], pop_size=6, generations=4, seed=1)
    full, _ = core.ga_parallel(tiny_tg[1], core.edge_cluster, **kw)
    core.ga_parallel(tiny_tg[1], core.edge_cluster, snapshot_every=2, snapshot_path=path,
                     **{**kw, "generations": 2})
    resumed, _ = core.ga_parallel(tiny_tg[1], core.edge_cluster, resume=path, **kw)
    np.testing.assert_array_equal(resumed.pareto_F, full.pareto_F)
    np.testing.assert_array_equal(resumed.X, full.X)
    # the reference resumes from the port's snapshot to the same front
    ref_resumed, _ = ref.ga_parallel(tiny_tg[0], ref.edge_cluster, resume=path, **kw)
    same(resumed, ref_resumed)


def test_ga_parallel_batched_equals_scalar(mlp_tg):
    kw = dict(chip_counts=[1, 2], pop_size=6, generations=2, seed=5)
    rb, _ = core.ga_parallel(mlp_tg[1], core.edge_cluster, use_batch=True, **kw)
    rs, _ = core.ga_parallel(mlp_tg[1], core.edge_cluster, use_batch=False, **kw)
    np.testing.assert_array_equal(rb.pareto_X, rs.pareto_X)
    np.testing.assert_array_equal(rb.pareto_F, rs.pareto_F)
    np.testing.assert_array_equal(rb.F, rs.F)
    same(rb, ref.ga_parallel(mlp_tg[0], ref.edge_cluster, use_batch=True, **kw)[0])


# -- dse.sweep, pareto_front, spread ----------------------------------------------------


def test_dse_sweep_batched_equals_scalar(mlp_tg):
    space = {"x_pes": [2, 4], "simd_units": [32, 64]}
    pb = core.sweep(core.edge_tpu, space, {"train": mlp_tg[1].graph}, use_batch=True)
    ps = core.sweep(core.edge_tpu, space, {"train": mlp_tg[1].graph}, use_batch=False)
    assert [p.config for p in pb] == [p.config for p in ps]
    for a, b in zip(pb, ps, strict=True):
        ra, rb_ = a.results["train"], b.results["train"]
        assert (ra.latency, ra.energy, ra.peak_mem) == (rb_.latency, rb_.energy, rb_.peak_mem)
        assert ra.mem_breakdown == rb_.mem_breakdown
    same(pb, ref.sweep(ref.edge_tpu, space, {"train": mlp_tg[0].graph}, use_batch=True))


def test_dse_sample_front_and_spread_equal_reference():
    """``sweep(sample=)`` draws its configs with ``random.Random(seed)`` over
    the dict order of ``space``: the same points as the reference's, the same
    Pareto front, ``spread`` and ``compute_resource``."""
    space = {"x_pes": [2, 4, 8], "y_pes": [2, 4], "simd_units": [32, 64, 128], "lanes": [4]}
    got = core.sweep(core.edge_tpu, space, {"mlp": core.mlp_graph()}, sample=5, seed=3)
    want = ref.sweep(ref.edge_tpu, space, {"mlp": ref.mlp_graph()}, sample=5, seed=3)
    assert len(got) == 5
    same(got, want)
    objs = (lambda p: p.results["mlp"].latency, lambda p: p.results["mlp"].energy)
    front = core.pareto_front(got, objs)
    assert front and [p.config for p in front] == \
        [p.config for p in ref.pareto_front(want, objs)]
    lat = [p.results["mlp"].latency for p in got]
    assert core.spread(lat) == ref.spread(lat)
    assert [core.compute_resource(p.config) for p in got] == \
        [ref.compute_resource(p.config) for p in want]
