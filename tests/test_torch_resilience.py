"""The port's copy of MONET's resilience model (``repro_torch.core.resilience``:
checkpoint interval, goodput, degraded-mode rescheduling) and the resilience
sweep, held against ``repro.core``.

Each test of ``tests/test_resilience.py`` has a counterpart here that runs
the port's function, asserts the same property and, on the same inputs,
equality with the reference: ``CheckpointPlan``, ``GoodputResult`` and
``DegradeResult`` field by field, exactly.

Trap held here: ``degrade``'s warm path is asserted through the port's
``engine.sign_count``.  A copy that reached the reference's engine (one
symbol imported from the wrong package) would pass every value check and
sign in the wrong counter; both sides' engines are cleared first and the
reference's counter must not move while the port degrades."""

import importlib
import math

import pytest
from test_torch_parallel import both, cold_rewrite_caches, same  # noqa: F401

import repro.core as ref
import repro_torch.core as core
from repro_torch.core.engine import sign_count
from repro_torch.core.fusion_search import fusion_partition

resilience = importlib.import_module("repro_torch.core.resilience")
ref_engine = importlib.import_module("repro.core.engine")


@pytest.fixture(scope="module")
def mlp_tg():
    return both(lambda m: m.build_training_graph(m.mlp_graph(8), "adam"))


def interval(*args, **kw):
    got = core.optimal_checkpoint_interval(*args, **kw)
    same(got, ref.optimal_checkpoint_interval(*args, **kw))
    return got


# -- checkpoint-interval selection ------------------------------------------------------


def test_interval_matches_young_daly_analytic():
    plan = interval(t_step_s=1.0, write_s=5.0, recovery_s=30.0, mtbf_s=20_000.0)
    tau_yd = math.sqrt(2 * 5.0 * 20_000.0)
    assert plan.tau_yd_s == pytest.approx(tau_yd)
    assert abs(plan.interval_s - tau_yd) / tau_yd < 0.05
    assert 0.0 < plan.efficiency < 1.0
    assert plan.interval_steps * 1.0 == plan.interval_s


def test_interval_discrete_search_beats_neighbors():
    plan = interval(t_step_s=2.0, write_s=3.0, recovery_s=10.0, mtbf_s=5_000.0)
    k = plan.interval_steps

    def eff(steps):
        return float(resilience._segment_efficiency(steps * 2.0, 3.0, 10.0, 5_000.0))

    assert eff(k) >= eff(k + 1)
    if k > 1:
        assert eff(k) >= eff(k - 1)


def test_interval_wide_range_geomspace_close_to_exact():
    plan = interval(t_step_s=1e-4, write_s=0.5, recovery_s=5.0, mtbf_s=1e7)
    exact = interval(t_step_s=1e-4, write_s=0.5, recovery_s=5.0, mtbf_s=1e7,
                     max_steps=plan.interval_steps * 2)
    assert abs(plan.efficiency - exact.efficiency) < 1e-6


def test_interval_rejects_degenerate_inputs():
    for args in ((0.0, 1.0, 1.0, 100.0), (1.0, 1.0, 1.0, 0.0)):
        for m in (core, ref):
            with pytest.raises(ValueError):
                m.optimal_checkpoint_interval(*args)


# -- fault models on clusters -----------------------------------------------------------


def test_cluster_factories_attach_fault_models():
    e, d = core.edge_cluster(2), core.datacenter_cluster(2)
    assert e.fault == core.edge_fault_model()
    assert d.fault == core.datacenter_fault_model()
    assert d.fault.mtbf_s == d.fault.mtbf_hours * 3600.0
    assert d.fault.cluster_mtbf_s(4) == pytest.approx(d.fault.mtbf_s / 4)
    custom = core.FaultModel(mtbf_hours=1.0)
    assert core.edge_cluster(2, fault=custom).fault is custom
    assert core.resolve_fault(e, custom) is custom
    assert core.resolve_fault(e) is e.fault
    same(core.resolve_fault(core.ClusterSpec(core.edge_tpu(), 2, fault=None)),
         ref.resolve_fault(ref.ClusterSpec(ref.edge_tpu(), 2, fault=None)))


# -- goodput ----------------------------------------------------------------------------


def test_goodput_below_raw_and_breakdown_conserves(mlp_tg):
    kw = dict(data=2, pipeline=2, microbatches=4)
    res = core.evaluate_goodput(mlp_tg[1], core.datacenter_cluster(4), core.ParallelStrategy(**kw))
    assert 0.0 < res.goodput < res.raw_throughput
    assert 0.0 < res.efficiency < 1.0
    assert res.goodput == pytest.approx(res.raw_throughput * res.efficiency)
    assert sum(res.breakdown.values()) == pytest.approx(1.0)
    assert all(v >= 0.0 for v in res.breakdown.values())
    assert res.ckpt_bytes > 0.0
    row = res.as_row()
    assert row["frac_useful"] == pytest.approx(res.breakdown["useful"])
    assert row["ckpt_interval_steps"] == res.ckpt.interval_steps
    want = ref.evaluate_goodput(mlp_tg[0], ref.datacenter_cluster(4), ref.ParallelStrategy(**kw))
    same(res, want)
    assert row == want.as_row()


def test_goodput_reuses_precomputed_result(mlp_tg):
    cluster = core.datacenter_cluster(2)
    engine = core.get_engine(cluster.chip)
    pres = core.evaluate_parallel(mlp_tg[1], cluster, core.ParallelStrategy(data=2), engine=engine)
    a = core.evaluate_goodput(mlp_tg[1], cluster, core.ParallelStrategy(data=2), engine=engine,
                              result=pres)
    b = core.evaluate_goodput(mlp_tg[1], cluster, core.ParallelStrategy(data=2), engine=engine)
    assert a.goodput == b.goodput
    assert a.ckpt.interval_steps == b.ckpt.interval_steps
    assert a.result is pres
    same(a, b)


def test_goodput_efficiency_decreases_with_failure_rate(mlp_tg):
    effs = []
    for mtbf in (50_000.0, 500.0, 5.0):
        got = core.evaluate_goodput(mlp_tg[1], core.datacenter_cluster(2),
                                    core.ParallelStrategy(data=2),
                                    fault=core.FaultModel(mtbf_hours=mtbf))
        same(got, ref.evaluate_goodput(mlp_tg[0], ref.datacenter_cluster(2),
                                       ref.ParallelStrategy(data=2),
                                       fault=ref.FaultModel(mtbf_hours=mtbf)))
        effs.append(got.efficiency)
    assert effs[0] > effs[1] > effs[2]


def test_goodput_ideal_fault_model_is_nearly_lossless(mlp_tg):
    kw = dict(mtbf_hours=1e12, transient_per_hour=0.0, dma_stall_frac=0.0, restart_s=0.0)
    res = core.evaluate_goodput(mlp_tg[1], core.datacenter_cluster(2),
                                core.ParallelStrategy(data=2), fault=core.FaultModel(**kw))
    assert res.efficiency > 1.0 - 1e-6
    assert res.breakdown["useful"] == pytest.approx(1.0, abs=1e-6)
    same(res, ref.evaluate_goodput(mlp_tg[0], ref.datacenter_cluster(2),
                                   ref.ParallelStrategy(data=2), fault=ref.FaultModel(**kw)))


# -- degraded-mode rescheduling ---------------------------------------------------------


def test_nearest_strategy_prefers_minimal_change():
    s = core.ParallelStrategy(data=2, tensor=2, pipeline=2, microbatches=4)
    d = core.nearest_strategy(s, 6)
    assert d.chips == 6 and d.tensor == 2
    assert core.nearest_strategy(s, 7).chips == 7
    dz = core.nearest_strategy(core.ParallelStrategy(data=4, zero=True), 2)
    assert dz.zero and dz.data == 2
    assert core.nearest_strategy(s, 8) == s
    rs = ref.ParallelStrategy(data=2, tensor=2, pipeline=2, microbatches=4)
    for n in range(1, 9):
        same(core.nearest_strategy(s, n), ref.nearest_strategy(rs, n))


def test_degrade_is_coherent_and_stays_warm(mlp_tg):
    """A degraded plan verifies clean, and re-scheduling its stage graphs
    signs nothing fresh in the port's engine (nor anything at all in the
    reference's)."""
    core.clear_engines()
    ref.clear_engines()
    kw = dict(data=2, pipeline=2, microbatches=4)
    cluster = core.datacenter_cluster(4)
    engine = core.get_engine(cluster.chip)
    core.evaluate_parallel(mlp_tg[1], cluster, core.ParallelStrategy(**kw), engine=engine)
    ref_signed = ref_engine.sign_count()
    d = core.degrade(mlp_tg[1], cluster, core.ParallelStrategy(**kw), 1, engine=engine)
    assert d.cluster.n_chips == 3 and d.strategy.chips == 3
    assert d.findings == []
    assert d.result.feasible in (True, False)
    before = sign_count()
    for sg in d.plan.stage_graphs:
        part, _ = fusion_partition(sg, d.cluster.chip, "manual", None, engine)
        core.schedule(sg, d.cluster.chip, part, engine=engine)
    assert sign_count() == before
    assert ref_engine.sign_count() == ref_signed
    same(d, ref.degrade(mlp_tg[0], ref.datacenter_cluster(4), ref.ParallelStrategy(**kw), 1))


def test_degrade_on_cached_rewrite_signs_nothing_fresh(mlp_tg, monkeypatch):
    """A repeat degrade is a warm lookup: zero fresh signings, the same
    objectives and findings, shared stage graphs (the sanitizer held off, as
    the reference's test needs)."""
    monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    core.clear_engines()
    ref.clear_engines()
    kw = dict(data=2, pipeline=2, microbatches=4)
    cluster = core.datacenter_cluster(4)
    engine = core.get_engine(cluster.chip)
    d0 = core.degrade(mlp_tg[1], cluster, core.ParallelStrategy(**kw), 1, engine=engine)
    before = sign_count()
    d1 = core.degrade(mlp_tg[1], cluster, core.ParallelStrategy(**kw), 1, engine=engine)
    assert sign_count() == before
    assert d1.strategy == d0.strategy
    assert (d1.result.latency, d1.result.energy, d1.result.peak_mem) == \
        (d0.result.latency, d0.result.energy, d0.result.peak_mem)
    assert d1.findings == d0.findings == []
    assert [id(sg) for sg in d1.plan.stage_graphs] == [id(sg) for sg in d0.plan.stage_graphs]
    same(d1, ref.degrade(mlp_tg[0], ref.datacenter_cluster(4), ref.ParallelStrategy(**kw), 1))


def test_degrade_rejects_impossible_losses(mlp_tg):
    for failed in (2, -1):
        msgs = []
        for m, tg in zip((ref, core), mlp_tg, strict=True):
            with pytest.raises(ValueError) as e:
                m.degrade(tg, m.edge_cluster(2), m.ParallelStrategy(data=2), failed)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


# -- sweep composition ------------------------------------------------------------------


def test_sweep_resilience_rows(mlp_tg):
    pts = core.sweep_resilience({"mlp": mlp_tg[1]}, core.edge_cluster, [1, 2])
    assert {p.n_chips for p in pts} == {1, 2}
    assert len(pts) == len(core.strategy_space(1)) + len(core.strategy_space(2))
    for p in pts:
        r = p.results["mlp"]
        assert 0.0 < r.efficiency <= 1.0
        row = p.row()
        assert row["chips"] == p.n_chips
        assert row["mlp_goodput"] == pytest.approx(r.goodput)
    want = ref.sweep_resilience({"mlp": mlp_tg[0]}, ref.edge_cluster, [1, 2])
    same(pts, want)
    assert [p.row() for p in pts] == [p.row() for p in want]
