"""The port's copies of MONET's activation-checkpointing search
(``repro_torch.core``: checkpointing, batch) held against ``repro.core``, and
the bridge from its keep-sets to the port's training step.

Each reference test of these modules has a counterpart here that runs the
port's function, asserts the same property and, on the same inputs, equality
with the reference: exact for keep-sets, Pareto fronts, latencies, energies
and bytes (the copies run the same numpy in the same order).  The bridge runs
the search of ``repro_torch.launch.ac_search`` on a small gemma3 shape, maps
its keep-sets to ``save:`` policies and trains a small gemma3 under them."""

import itertools
from dataclasses import replace

import numpy as np
import pytest
import torch
from jax._src.ad_checkpoint import name_p
from test_torch_core import as_plain, canonical

import repro.core as ref
import repro_torch.configs as configs
import repro_torch.core as core
from repro.core import batch as ref_batch
from repro.core import remat_policy as ref_rp
from repro_torch.convert import tree_flatten_with_path
from repro_torch.core import batch
from repro_torch.core import remat_policy as rp
from repro_torch.core.engine import sign_count
from repro_torch.launch import ac_search
from repro_torch.launch.train import Trainer
from repro_torch.models.transformer import init_params
from repro_torch.training import loss


def same(got, want):
    assert as_plain(got) == as_plain(want)


@pytest.fixture(scope="module")
def tg():
    return (core.build_training_graph(core.mlp_graph(batch=16, widths=(64, 64, 64))),
            ref.build_training_graph(ref.mlp_graph(batch=16, widths=(64, 64, 64))))


@pytest.fixture(scope="module")
def rn_tg():
    return (core.build_training_graph(core.resnet18_graph(1, 32), "adam"),
            ref.build_training_graph(ref.resnet18_graph(1, 32), "adam"))


@pytest.fixture(scope="module")
def mlp_tg():
    return (core.build_training_graph(core.mlp_graph(4, widths=(16, 16)), "adam"),
            ref.build_training_graph(ref.mlp_graph(4, widths=(16, 16)), "adam"))


# -- checkpointing: the linear baseline -------------------------------------------------


def test_knapsack_exact_vs_bruteforce(tg):
    g = tg[0].graph
    acts = core.activation_set(tg[0])[:8]
    m = [g.tensors[a].bytes for a in acts]
    r = [core.recompute_flops(g, a) for a in acts]
    budget = sum(m) // 2

    class FakeTG:
        graph = g
        activations = acts

    kept, rc = core.knapsack_baseline(FakeTG(), budget, granularity=1)
    best = min(sum(ri for ri, x in zip(r, mask, strict=True) if not x)
               for mask in itertools.product([0, 1], repeat=len(acts))
               if sum(mi for mi, x in zip(m, mask, strict=True) if x) <= budget)
    assert rc == best

    class RefTG:
        graph = tg[1].graph
        activations = acts

    assert (kept, rc) == ref.knapsack_baseline(RefTG(), budget, granularity=1)


def test_knapsack_budget_respected(tg):
    total = core.stored_activation_bytes(tg[0], core.activation_set(tg[0]))
    assert total == ref.stored_activation_bytes(tg[1], ref.activation_set(tg[1]))
    for frac in (0.25, 0.5, 0.75):
        kept, rc = core.knapsack_baseline(tg[0], int(total * frac))
        assert core.stored_activation_bytes(tg[0], kept) <= int(total * frac) + 4096
        assert (kept, rc) == ref.knapsack_baseline(tg[1], int(total * frac))


@pytest.mark.parametrize("which", ["mlp", "resnet18"])
def test_knapsack_at_half_and_its_evaluation_equal_reference(which, tg, rn_tg):
    """The Fig. 12 bench's knapsack (half of the activation bytes) keeps the
    reference's tensors, and ``evaluate_checkpointing`` of it on
    ``edge_tpu()`` is the reference's, schedule included."""
    mine, want = tg if which == "mlp" else rn_tg
    half = core.stored_activation_bytes(mine, core.activation_set(mine)) // 2
    kept, rc = core.knapsack_baseline(mine, half)
    assert (kept, rc) == ref.knapsack_baseline(want, half)
    same(core.evaluate_checkpointing(mine, core.edge_tpu(), set(kept)),
         ref.evaluate_checkpointing(want, ref.edge_tpu(), set(kept)))


# -- checkpointing: the rewrite pass ----------------------------------------------------


def test_rewrite_validity_and_rewiring(tg):
    acts = core.activation_set(tg[0])
    keep = set(acts[: len(acts) // 2])
    g2 = core.apply_checkpointing(tg[0], keep)
    g2.validate()
    for a in set(acts) - keep:
        for c in g2.consumers.get(a, []):
            assert not g2.nodes[c].kind.startswith("bwd"), f"{c} still reads {a}"
    assert [n for n in g2.nodes.values() if n.kind == "recompute"]
    assert canonical(g2) == canonical(ref.apply_checkpointing(tg[1], keep))


def test_rewrite_noop_when_keep_all(tg):
    g2 = core.apply_checkpointing(tg[0], set(core.activation_set(tg[0])))
    assert len(g2) == len(tg[0].graph)
    assert canonical(g2) == canonical(ref.apply_checkpointing(tg[1],
                                                              set(ref.activation_set(tg[1]))))


def test_recompute_shared_not_duplicated():
    mine, want = (m.build_training_graph(m.mlp_graph(batch=4, widths=(32, 32)))
                  for m in (core, ref))
    g2 = core.apply_checkpointing(mine, set())
    rc = [n for n in g2.nodes if n.endswith(".rc")]
    assert rc and len(rc) == len(set(rc))
    assert canonical(g2) == canonical(ref.apply_checkpointing(want, set()))


def test_discard_increases_flops_decreases_act_bytes(tg):
    acts = core.activation_set(tg[0])
    hda, ref_hda = core.edge_tpu(), ref.edge_tpu()
    base = core.evaluate_checkpointing(tg[0], hda, set(acts))
    half = core.evaluate_checkpointing(tg[0], hda, set(acts[: len(acts) // 2]))
    assert half.act_bytes < base.act_bytes
    same((base, half), (ref.evaluate_checkpointing(tg[1], ref_hda, set(acts)),
                        ref.evaluate_checkpointing(tg[1], ref_hda, set(acts[: len(acts) // 2]))))


def test_nonlinearity_hook_exists():
    """Joint recompute shares clones: the extra FLOPs of discarding two
    activations are at most the sum of discarding each, as in the reference."""
    deltas = []
    for mod in (core, ref):
        t = mod.build_training_graph(mod.resnet18_graph(1, 32))
        acts = mod.activation_set(t)
        a0 = "bn1.out" if "bn1.out" in acts else acts[0]
        a1 = "conv1.out" if "conv1.out" in acts else acts[1]
        full = mod.apply_checkpointing(t, set(acts)).total_flops()
        deltas.append([mod.apply_checkpointing(t, set(acts) - drop).total_flops() - full
                       for drop in ({a0}, {a1}, {a0, a1})])
    d10, d01, d11 = deltas[0]
    assert d11 <= d10 + d01 + 1
    assert deltas[0] == deltas[1]


# -- checkpointing: the searches --------------------------------------------------------


def ac_fields(res) -> tuple:
    return (as_plain(res.baseline), as_plain(res.pareto), as_plain(res.ga), res.activations)


def test_ga_checkpointing_pareto(tg):
    res = core.ga_checkpointing(tg[0], core.edge_tpu(), pop_size=10, generations=5, seed=0)
    assert len(res.pareto) >= 1
    F = np.array([[s.latency, s.energy, s.act_bytes] for s in res.pareto])
    assert len(core.fast_non_dominated_sort(F)[0]) == len(F)
    assert min(s.act_bytes for s in res.pareto) < res.baseline.act_bytes
    assert ac_fields(res) == ac_fields(
        ref.ga_checkpointing(tg[1], ref.edge_tpu(), pop_size=10, generations=5, seed=0))


@pytest.mark.parametrize("use_batch", [True, False], ids=["batched", "scalar"])
def test_fig12_ga_on_resnet18_equals_reference(rn_tg, use_batch):
    """``benchmarks/bench_checkpointing.py``'s GA (resnet18, ``edge_tpu()``,
    pop 16, gen 8, seed 0): baseline, front (keep, latency, energy, bytes)
    and ``ga.pareto_F`` are the reference's, batched and scalar alike."""
    kw = dict(pop_size=16, generations=8, seed=0)
    got = core.ga_checkpointing(rn_tg[0], core.edge_tpu(), use_batch=use_batch, **kw)
    want = ref.ga_checkpointing(rn_tg[1], ref.edge_tpu(), use_batch=True, **kw)
    assert [(s.keep, s.latency, s.energy, s.act_bytes) for s in got.pareto] == \
        [(s.keep, s.latency, s.energy, s.act_bytes) for s in want.pareto]
    np.testing.assert_array_equal(got.ga.pareto_F, want.ga.pareto_F)
    assert ac_fields(got) == ac_fields(want)
    assert min(s.act_bytes for s in got.pareto) < got.baseline.act_bytes


def test_ga_policy_with_offload_batched_scalar_and_reference():
    """``ga_policy`` (KEEP / RECOMPUTE / OFFLOAD genes) on the ``mlp_graph()``
    training graph: batched ≡ scalar ≡ the reference, every Pareto point with
    its verifier findings."""
    mine, want = (m.build_training_graph(m.mlp_graph(), "adam") for m in (core, ref))
    kw = dict(pop_size=8, generations=4, seed=2)
    rb = core.ga_policy(mine, core.edge_tpu(), use_batch=True, **kw)
    rs = core.ga_policy(mine, core.edge_tpu(), use_batch=False, **kw)
    rw = ref.ga_policy(want, ref.edge_tpu(), **kw)
    same(rb, rs)
    same(rb, rw)


def test_ga_policy_seed_determinism(mlp_tg):
    kw = dict(pop_size=6, generations=2, seed=5)
    r1 = core.ga_policy(mlp_tg[0], core.edge_tpu(), **kw)
    r2 = core.ga_policy(mlp_tg[0], core.edge_tpu(), **kw)
    np.testing.assert_array_equal(r1.ga.pareto_F, r2.ga.pareto_F)
    assert [s.peak_mem for s in r1.pareto] == [s.peak_mem for s in r2.pareto]


def test_ga_policy_resume_across_batched_boundary(mlp_tg, tmp_path):
    """A snapshot inside a batched run resumed with ``use_batch`` toggled (both
    ways) ends at the uninterrupted run's front, which is the reference's."""
    kw = dict(pop_size=6, generations=4, seed=7)
    full = core.ga_policy(mlp_tg[0], core.edge_tpu(), use_batch=True, **kw)
    np.testing.assert_array_equal(
        full.ga.pareto_F, core.ga_policy(mlp_tg[0], core.edge_tpu(), use_batch=False,
                                         **kw).ga.pareto_F)
    for crash_batch, resume_batch in [(True, False), (False, True)]:
        path = str(tmp_path / f"pol_{crash_batch}.json")
        core.ga_policy(mlp_tg[0], core.edge_tpu(), snapshot_every=2, snapshot_path=path,
                       use_batch=crash_batch, **{**kw, "generations": 2})
        assert core.load_snapshot(path)["generation"] == 2
        resumed = core.ga_policy(mlp_tg[0], core.edge_tpu(), resume=path,
                                 use_batch=resume_batch, **kw)
        for key in ("X", "F", "pareto_F"):
            np.testing.assert_array_equal(getattr(resumed.ga, key), getattr(full.ga, key))
        assert [(s.latency, s.energy, s.peak_mem) for s in resumed.pareto] == \
            [(s.latency, s.energy, s.peak_mem) for s in full.pareto]
    same(full, ref.ga_policy(mlp_tg[1], ref.edge_tpu(), **kw))


# -- batch: PopulationEvaluator against the scalar oracle and the reference -------------


def keep_of(acts, mask):
    return {a for i, a in enumerate(acts) if mask[i]}


def test_score_keep_bit_for_bit(rn_tg):
    hda = core.edge_tpu()
    eng = core.get_engine(hda)
    ev = batch.PopulationEvaluator(rn_tg[0], hda, engine=eng)
    ref_ev = ref_batch.PopulationEvaluator(rn_tg[1], ref.edge_tpu())
    acts = core.activation_set(rn_tg[0])
    rng = np.random.default_rng(3)
    for _ in range(8):
        mask = rng.random(len(acts)) < rng.random()
        got = ev.score_keep(mask)
        s = core.evaluate_checkpointing(rn_tg[0], hda, keep_of(acts, mask), engine=eng)
        assert got == (s.latency, s.energy, float(s.act_bytes)) == ref_ev.score_keep(mask)
    assert ev.stats["soa"] > 0


def test_score_policy_bit_for_bit(rn_tg):
    hda = core.edge_tpu()
    eng = core.get_engine(hda)
    ev = batch.PopulationEvaluator(rn_tg[0], hda, engine=eng)
    ref_ev = ref_batch.PopulationEvaluator(rn_tg[1], ref.edge_tpu())
    acts = core.activation_set(rn_tg[0])
    rng = np.random.default_rng(4)
    genomes = [rng.integers(0, 2, len(acts)) for _ in range(4)]
    genomes += [rng.integers(0, 3, len(acts)) for _ in range(2)]
    for genome in genomes:
        pol = {acts[i]: core.ActivationPolicy(int(genome[i])) for i in range(len(acts))}
        s = core.evaluate_policy(rn_tg[0], hda, pol, engine=eng)
        assert ev.score_policy(genome) == (s.latency, s.energy, float(s.peak_mem)) == \
            ref_ev.score_policy(genome)


def test_score_batch_equals_scalar_loop_elementwise(rn_tg):
    hda = core.edge_tpu()
    ev = batch.PopulationEvaluator(rn_tg[0], hda, engine=core.get_engine(hda))
    rng = np.random.default_rng(5)
    pop = [rng.random(len(ev.acts)) < 0.5 for _ in range(6)]
    got = ev.score_keep_batch(pop)
    assert got == [ev.score_keep(m) for m in pop]
    assert got == ref_batch.PopulationEvaluator(rn_tg[1], ref.edge_tpu()).score_keep_batch(pop)


def test_batch_dedup_signs_unique_phenotypes_once(rn_tg):
    hda = core.edge_tpu()
    ev = batch.PopulationEvaluator(rn_tg[0], hda, engine=core.get_engine(hda))
    rng = np.random.default_rng(6)
    uniq = [rng.random(len(ev.acts)) < 0.5 for _ in range(3)]
    pop = uniq + [u.copy() for u in uniq] + [uniq[0].copy()]
    ev.score_keep_batch(pop)
    assert ev.stats["soa"] + ev.stats["scalar"] <= len(uniq)
    assert ev.stats["hits"] == len(pop) - len(uniq)
    s0, hits0 = sign_count(), ev.stats["hits"]
    out1 = ev.score_keep_batch(pop)
    assert sign_count() == s0
    assert ev.stats["hits"] == hits0 + len(pop)
    assert out1 == ev.score_keep_batch(pop)


def test_population_evaluator_memoized_on_engine(rn_tg):
    eng = core.get_engine(core.edge_tpu())
    ev1 = eng.population_evaluator(rn_tg[0])
    assert isinstance(ev1, batch.PopulationEvaluator)
    assert eng.population_evaluator(rn_tg[0]) is ev1
    eng.clear()
    assert eng.population_evaluator(rn_tg[0]) is not ev1


@pytest.mark.parametrize("gene", ["keep_mask", "offload"])
def test_sanitize_forces_scalar_and_disables_memo(rn_tg, monkeypatch, gene):
    """``REPRO_SANITIZE=1`` sends every evaluation through the scalar pipeline,
    none served from the memo, with the clean run's objectives, which are the
    reference's under the same environment."""
    hda = core.edge_tpu()
    eng = core.get_engine(hda)
    n = len(core.activation_set(rn_tg[0]))
    if gene == "keep_mask":
        x = np.zeros(n, dtype=bool)
        x[::2] = True
        score = "score_keep"
    else:
        x = np.full(n, int(core.ActivationPolicy.OFFLOAD))
        score = "score_policy"
    clean = getattr(batch.PopulationEvaluator(rn_tg[0], hda, engine=eng), score)(x)
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    ev = batch.PopulationEvaluator(rn_tg[0], hda, engine=eng)
    a = getattr(ev, score)(x)
    ref_ev = ref_batch.PopulationEvaluator(rn_tg[1], ref.edge_tpu())
    assert a == clean == getattr(ref_ev, score)(x)
    if gene == "keep_mask":
        assert getattr(ev, score)(x) == clean
        assert ev.stats["scalar"] == 2
    else:
        assert ev.stats["scalar_sanitize"] == 1
    assert ev.stats["soa"] == 0 and ev.stats["hits"] == 0


def test_score_policy_offload_soa_parity(rn_tg):
    hda = core.edge_tpu()
    eng = core.get_engine(hda)
    ev = batch.PopulationEvaluator(rn_tg[0], hda, engine=eng)
    acts = core.activation_set(rn_tg[0])
    n = len(acts)
    rng = np.random.default_rng(7)
    genomes = [np.full(n, int(core.ActivationPolicy.OFFLOAD))]
    genomes += [rng.integers(0, 3, n) for _ in range(6)]
    ref_ev = ref_batch.PopulationEvaluator(rn_tg[1], ref.edge_tpu())
    for genome in genomes:
        pol = {acts[i]: core.ActivationPolicy(int(genome[i])) for i in range(n)}
        s = core.evaluate_policy(rn_tg[0], hda, pol, engine=eng)
        assert ev.score_policy(genome) == (s.latency, s.energy, float(s.peak_mem)) == \
            ref_ev.score_policy(genome)
    assert ev.stats["soa"] > 0 and ev.stats["scalar_offload"] == 0


def test_policy_batch_cross_phenotype_parity(rn_tg):
    hda = core.edge_tpu()
    eng = core.get_engine(hda)
    ev = batch.PopulationEvaluator(rn_tg[0], hda, engine=eng)
    rng = np.random.default_rng(8)
    pop = [rng.integers(0, 3, len(ev.acts)) for _ in range(8)]
    batched = ev.score_policy_batch(pop)
    assert batched == [batch.PopulationEvaluator(rn_tg[0], hda, engine=eng).score_policy(g)
                       for g in pop]
    assert batched == ref_batch.PopulationEvaluator(rn_tg[1],
                                                    ref.edge_tpu()).score_policy_batch(pop)


def test_scalar_fallback_reason_counters(rn_tg):
    hda = core.edge_tpu()
    eng = core.get_engine(hda)
    ev = batch.PopulationEvaluator(rn_tg[0], hda, engine=eng)
    n = len(ev.acts)
    ev.score_policy(np.zeros(n, dtype=np.int64))
    assert ev.stats["scalar_baseline"] == 1 and ev.scalar_share() == 0.0
    ev.score_policy(np.full(n, int(core.ActivationPolicy.RECOMPUTE)))
    assert ev.stats["soa"] == 1 and ev.scalar_share() == 0.0
    ev3 = batch.PopulationEvaluator(rn_tg[0], hda, engine=eng, fusion="none")
    got = ev3.score_policy(np.full(n, int(core.ActivationPolicy.RECOMPUTE)))
    assert ev3.stats["scalar_fusion"] == 1 and ev3.scalar_share() == 1.0
    assert got == ref_batch.PopulationEvaluator(rn_tg[1], ref.edge_tpu(), fusion="none") \
        .score_policy(np.full(n, int(core.ActivationPolicy.RECOMPUTE)))


def test_ga_checkpointing_batched_equals_scalar(mlp_tg):
    kw = dict(pop_size=6, generations=3, seed=2)
    rb = core.ga_checkpointing(mlp_tg[0], core.edge_tpu(), use_batch=True, **kw)
    rs = core.ga_checkpointing(mlp_tg[0], core.edge_tpu(), use_batch=False, **kw)
    assert ac_fields(rb) == ac_fields(rs)
    assert ac_fields(rb) == ac_fields(ref.ga_checkpointing(mlp_tg[1], ref.edge_tpu(), **kw))


def test_ga_policy_batched_equals_scalar(mlp_tg):
    kw = dict(pop_size=6, generations=2, seed=2)
    rb = core.ga_policy(mlp_tg[0], core.edge_tpu(), use_batch=True, **kw)
    rs = core.ga_policy(mlp_tg[0], core.edge_tpu(), use_batch=False, **kw)
    same(rb, rs)
    same(rb, ref.ga_policy(mlp_tg[1], ref.edge_tpu(), **kw))


def test_fusion_search_batched_equals_scalar(mlp_tg):
    kw = dict(pop_size=6, generations=3, seed=1)
    rb = core.search_fusion(mlp_tg[0].graph, core.edge_tpu(),
                            core.FusionSearchConfig(use_batch=True, **kw))
    rs = core.search_fusion(mlp_tg[0].graph, core.edge_tpu(),
                            core.FusionSearchConfig(use_batch=False, **kw))
    want = ref.search_fusion(mlp_tg[1].graph, ref.edge_tpu(), ref.FusionSearchConfig(**kw))
    for r in (rs, want):
        assert rb.best.partition == r.best.partition
        assert rb.best.objectives == r.best.objectives
        assert [c.objectives for c in rb.pareto] == [c.objectives for c in r.pareto]
        for key in ("genome_evals", "unique_partitions", "memo_hits"):
            assert rb.stats[key] == r.stats[key]


def test_ga_checkpointing_batched_clean_under_sanitizer(mlp_tg, monkeypatch):
    kw = dict(pop_size=4, generations=2, seed=0)
    clean = core.ga_checkpointing(mlp_tg[0], core.edge_tpu(), use_batch=True, **kw)
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    shadow = core.ga_checkpointing(mlp_tg[0], core.edge_tpu(), use_batch=True, **kw)
    assert ac_fields(shadow) == ac_fields(clean)


def test_population_evaluator_scores_equal_reference_on_mlp_graph():
    """``EvalEngine.population_evaluator`` of the ``mlp_graph()`` training
    graph scores keep-masks and ternary genomes as the reference's does."""
    mine, want = (m.build_training_graph(m.mlp_graph(), "adam") for m in (core, ref))
    ev = core.get_engine(core.tpu_v5e_like()).population_evaluator(mine)
    ref_ev = ref.get_engine(ref.tpu_v5e_like()).population_evaluator(want)
    rng = np.random.default_rng(9)
    n = len(ev.acts)
    masks = [rng.random(n) < 0.5 for _ in range(4)] + [np.zeros(n, bool), np.ones(n, bool)]
    genomes = [rng.integers(0, 3, n) for _ in range(4)]
    assert ev.score_keep_batch(masks) == ref_ev.score_keep_batch(masks)
    assert ev.score_policy_batch(genomes) == ref_ev.score_policy_batch(genomes)


# -- the bridge: MONET's search picks the policy a gemma3 trains under -------------------

#: gemma3 at a small shape: ``gpt2_graph(1, 256, 128, 4, 4, 512)`` in the search
SMALL_SEARCH = dict(d_model=128, n_layers=4, vocab=512)


@pytest.fixture(scope="module")
def searched():
    cfg = replace(configs.get_config("gemma3-1b"), **SMALL_SEARCH)
    tg, reduced = ac_search.search_graph(cfg, 1, 256)
    want_tg = ref.build_training_graph(ref.gpt2_graph(1, 256, 128, 4, 4, 512), "adam")
    return ac_search.search(tg, core.tpu_v5e_like()), tg, want_tg, reduced


def test_search_graph_is_the_references(searched):
    _, tg, want_tg, reduced = searched
    assert canonical(tg.graph) == canonical(want_tg.graph)
    assert tg.activations == want_tg.activations
    assert "GPT-2 builder" in reduced and "kv heads" in reduced


def test_searched_keepsets_equal_reference_legs(searched):
    """The knapsack at half the keep-all bytes and the GA's fastest point
    within the knapsack's bytes (``run_milp_vs_ga``), run again with the
    reference's functions: the same keep-sets and modelled numbers."""
    got, _, want_tg, _ = searched
    hda = ref.tpu_v5e_like()
    acts = ref.activation_set(want_tg)
    kept, _ = ref.knapsack_baseline(want_tg, ref.stored_activation_bytes(want_tg, acts) // 2)
    ks = ref.evaluate_checkpointing(want_tg, hda, set(kept))
    res = ref.ga_checkpointing(want_tg, hda, seed=0)
    ga = min((s for s in res.pareto if s.act_bytes <= ks.act_bytes), key=lambda s: s.latency)
    for leg, want in (("knapsack", ks), ("ga", ga)):
        c = got[leg]
        assert (c.keep, c.latency, c.energy, c.act_bytes) == \
            (want.keep, want.latency, want.energy, want.act_bytes), leg
    assert got["ga"].latency <= got["knapsack"].latency


def ref_families(keep) -> set:
    """The families the reference's ``keepset_to_policy`` saves."""
    policy = ref_rp.keepset_to_policy(keep)
    return {n for n in ref_rp.KNOWN_SITES if policy(name_p, name=n)}


def test_keepsets_map_to_the_reference_families(searched):
    got = searched[0]
    for leg in ("knapsack", "ga"):
        keep = got[leg].keep
        families = set(got[leg].policy.removeprefix("save:").split(","))
        assert families == set(rp.keepset_to_policy(keep).names) == ref_families(keep)
        assert rp.resolve_remat(got[leg].policy)[1].names == families
    assert got["knapsack"].policy != got["ga"].policy
    # a family-level bridge: every point of the front is one of few policies
    assert got["ga"].policy in got["front"]
    assert len(set(got["front"])) <= 2


def test_policy_of_nothing_is_save_nothing():
    assert ac_search.policy_of({"tokens", "wte.table"}) == "save:"
    use, policy = rp.resolve_remat("save:")
    assert use and policy.names == frozenset()


SHAPE = configs.ShapeConfig("t", seq_len=64, global_batch=2, kind="train")


def loss_and_grads(cfg, params, x, y):
    leaves = tree_flatten_with_path(params)
    for t in leaves.values():
        t.requires_grad_(True)
    value, _ = loss.lm_loss(params, cfg, x, y)
    return value.detach(), torch.autograd.grad(value, list(leaves.values()))


def train_small_gemma3(remat: str) -> tuple:
    """A small gemma3 (its smoke config, bf16) under ``remat``: (loss, the
    gradients of every leaf, one ``Trainer.fit`` step's log, the weights after
    it)."""
    cfg = replace(configs.smoke_config("gemma3-1b"), remat=remat)
    rng = np.random.default_rng(0)
    x, y = (torch.from_numpy(rng.integers(0, cfg.vocab, (2, 64)).astype(np.int64))
            for _ in range(2))
    value, grads = loss_and_grads(cfg, init_params(cfg, 0, "cpu"), x, y)
    tr = Trainer(cfg, SHAPE, lr=1e-3, device="cpu")
    (log,) = tr.fit(1)
    return value, grads, log, tree_flatten_with_path(tr._last_state[0])


@pytest.fixture(scope="module")
def no_remat():
    return train_small_gemma3("none")


@pytest.mark.parametrize("leg", ["knapsack", "ga"])
def test_small_gemma3_under_the_searched_policy_equals_no_remat(searched, no_remat, leg):
    """A small gemma3 under the leg's ``save:`` policy: loss and every
    gradient equal ``remat="none"``'s exactly, and one ``Trainer.fit`` step
    logs the same loss and grad norm and leaves the same weights."""
    (v0, g0, l0, p0), (v1, g1, l1, p1) = no_remat, train_small_gemma3(searched[0][leg].policy)
    assert torch.equal(v0, v1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1, strict=True))
    assert (l0["loss"], l0["grad_norm"]) == (l1["loss"], l1["grad_norm"])
    assert list(p0) == list(p1) and all(torch.equal(p0[k], p1[k]) for k in p0)
