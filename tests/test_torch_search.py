"""The port's copies of MONET's search layer (``repro_torch.core``: nsga2,
builders, zoo, fusion, fusion_search) held against ``repro.core``.

Each reference test of these modules has a counterpart here that runs the
port's function, asserts the same property and, on the same inputs, equality
with the reference: exact for graphs, partitions, Pareto fronts, latencies,
energies and bytes (the copies run the same numpy in the same order)."""

import importlib

import numpy as np
import pytest
from test_torch_core import as_plain, canonical

import repro.core as ref
import repro_torch.core as core
from repro.core import dse as ref_dse
from repro.core import fusion as ref_fusion
from repro_torch.core import fusion
from repro_torch.core.engine import EvalEngine, sign_count

# the packages export the function ``nsga2``, which hides the module
nsga2 = importlib.import_module("repro_torch.core.nsga2")
ref_nsga2 = importlib.import_module("repro.core.nsga2")


def same(got, want):
    assert as_plain(got) == as_plain(want)


# -- nsga2 ------------------------------------------------------------------------------


def _eval_bool(mask):
    x = mask.astype(float)
    return (float(x.sum()), float((x[::2].sum() - x[1::2].sum()) ** 2),)


def _eval_int(genome):
    g = genome.astype(float)
    return (float(((g - 3.0) ** 2).sum()), float(np.abs(g).sum()))


BOUNDS = [(0, 7)] * 5
RUNNERS = {"bool": ("nsga2", _eval_bool, dict(n_var=8)),
           "int": ("nsga2_int", _eval_int, dict(bounds=BOUNDS))}


def test_snapshot_round_trip_reads_on_both_sides(tmp_path):
    path = str(tmp_path / "snap.json")
    state = {"format": nsga2.SNAPSHOT_FORMAT, "generation": 3, "dtype": "int",
             "X": [[1, 2]], "F": [[0.5, 1.5]], "history": [1.0],
             "rng_state": np.random.default_rng(0).bit_generator.state}
    assert nsga2.SNAPSHOT_FORMAT == ref_nsga2.SNAPSHOT_FORMAT
    core.save_snapshot(path, state)
    assert core.load_snapshot(path) == state == ref.load_snapshot(path)
    assert not (tmp_path / "snap.json.tmp").exists()   # atomic rename


def test_load_snapshot_rejects_unknown_format(tmp_path):
    path = str(tmp_path / "bad.json")
    core.save_snapshot(path, {"format": "something-else"})
    with pytest.raises(ValueError):
        core.load_snapshot(path)


@pytest.mark.parametrize("kind", list(RUNNERS))
def test_resume_reproduces_uninterrupted_run(tmp_path, kind):
    """Stop after 6 of 9 generations (a snapshot every 3), resume: the
    uninterrupted run's result bit for bit, and that is the reference's."""
    name, evaluate, extra = RUNNERS[kind]
    runner = getattr(core, name)
    kw = dict(pop_size=12, generations=9, seed=11, **extra)
    full = runner(evaluate, **kw)
    same(full, getattr(ref, name)(evaluate, **kw))

    path = str(tmp_path / "snap.json")
    runner(evaluate, snapshot_every=3, snapshot_path=path, **{**kw, "generations": 6})
    assert core.load_snapshot(path)["generation"] == 6
    resumed = runner(evaluate, resume=path, **kw)
    for key in ("X", "F", "pareto_F"):
        np.testing.assert_array_equal(getattr(resumed, key), getattr(full, key))
    assert resumed.history == full.history
    assert resumed.generations_run == full.generations_run == 9
    assert resumed.n_evals == 3 * 12 and full.n_evals == (9 + 1) * 12
    # the reference resumes from the port's snapshot to the same result
    same(getattr(ref, name)(evaluate, resume=path, **kw), resumed)


def test_snapshot_knobs_do_not_perturb_search(tmp_path):
    plain = core.nsga2_int(_eval_int, BOUNDS, pop_size=8, generations=5, seed=3)
    snapped = core.nsga2_int(_eval_int, BOUNDS, pop_size=8, generations=5, seed=3,
                             snapshot_every=1, snapshot_path=str(tmp_path / "s.json"),
                             max_seconds=1e9, max_evals=10**9)
    np.testing.assert_array_equal(plain.X, snapped.X)
    np.testing.assert_array_equal(plain.pareto_F, snapped.pareto_F)
    same(plain, ref.nsga2_int(_eval_int, BOUNDS, pop_size=8, generations=5, seed=3))


def test_max_evals_bounds_the_search():
    kw = dict(pop_size=10, generations=50, seed=0, max_evals=35)
    res = core.nsga2_int(_eval_int, BOUNDS, **kw)
    assert res.n_evals == 30 and res.generations_run == 2 and len(res.pareto_F) >= 1
    same(res, ref.nsga2_int(_eval_int, BOUNDS, **kw))


def test_max_seconds_zero_returns_initial_front():
    kw = dict(n_var=6, pop_size=8, generations=40, seed=0, max_seconds=0.0)
    res = core.nsga2(_eval_bool, **kw)
    assert res.generations_run == 0 and res.n_evals == 8 and len(res.pareto_F) >= 1
    same(res, ref.nsga2(_eval_bool, **kw))


def test_nds_and_crowding_equal_reference():
    F = np.array([[1, 5], [2, 4], [3, 3], [2, 6], [4, 4]], float)
    assert sorted(core.fast_non_dominated_sort(F)[0].tolist()) == [0, 1, 2]
    rng = np.random.default_rng(0)
    for F in (F, rng.integers(0, 4, (40, 3)).astype(float), rng.random((33, 2))):
        same(core.fast_non_dominated_sort(F), ref.fast_non_dominated_sort(F))
        same(core.crowding_distance(F), ref.crowding_distance(F))


def test_nsga2_on_zdt1():
    def evaluate(mask):
        x = mask.astype(float)
        f1 = x[0]
        g = 1 + 9 * x[1:].mean()
        return (f1, g * (1 - np.sqrt(f1 / g) if g > 0 else 1))

    res = core.nsga2(evaluate, 20, pop_size=24, generations=20, seed=1)
    assert res.pareto_F[:, 0].min() == 0.0 and len(res.pareto_F) >= 2
    same(res, ref.nsga2(evaluate, 20, pop_size=24, generations=20, seed=1))


# -- builders and zoo -------------------------------------------------------------------

TINY = dict(d_model=64, n_layers=2, n_heads=4, vocab=256)
ZOO = {
    "mlp": ("mlp_graph", (), {}),
    "mlp_small": ("mlp_graph", (4,), dict(d_in=16, widths=(16,), n_classes=4)),
    "resnet18": ("resnet18_graph", (1, 32), {}),
    "resnet18_imagenet": ("resnet18_graph", (2, 224), dict(num_classes=100)),
    "gpt2": ("gpt2_graph", (1, 64, 128, 2, 4, 512), {}),
    "gpt2_fp32": ("gpt2_graph", (2, 32, 64, 1, 2, 128), dict(dtype="float32")),
    "prefill": ("gpt2_prefill_graph", (), dict(batch=1, seq=64, **TINY)),
    "prefill_tp": ("gpt2_prefill_graph", (), dict(batch=1, seq=64, tp=2, commit_kv=False,
                                                  **TINY)),
    "decode": ("gpt2_decode_graph", (), dict(batch=4, past=64, **TINY)),
    "decode_paged": ("gpt2_decode_graph", (), dict(batch=4, past=64, kv_paged=True, **TINY)),
}


@pytest.mark.parametrize("kind", list(ZOO))
def test_zoo_graph_equals_reference(kind):
    """The port's zoo (through its ``GraphBuilder``) builds the reference's
    graph field by field; its training graph is the reference's too."""
    fn, args, kw = ZOO[kind]
    mine, want = getattr(core, fn)(*args, **kw), getattr(ref, fn)(*args, **kw)
    assert canonical(mine) == canonical(want)
    mine.validate()
    assert getattr(core, fn)(*args, **kw) is not mine        # a fresh copy each call
    if kw.get("with_loss", fn in ("mlp_graph", "resnet18_graph", "gpt2_graph")):
        tg, ref_tg = core.build_training_graph(mine, "adam"), ref.build_training_graph(want,
                                                                                      "adam")
        assert canonical(tg.graph) == canonical(ref_tg.graph)
        assert tg.activations == ref_tg.activations


def test_builder_layers_equal_reference():
    """Every ``GraphBuilder`` layer the zoo does not use, on both sides."""
    graphs = []
    for mod in (core, ref):
        b = mod.GraphBuilder("layers", "float32")
        x = b.input("x", (2, 4, 8, 8))
        y = b.silu(b.norm(b.conv(x, 8, 3, stride=2), kind="batchnorm"))
        y = b.global_avg_pool(b.pool(y, kind="avg"))
        y = b.square_relu(b.linear(y, 16, bias=False))
        y = b.scale(b.mul(y, y))
        y = b.softmax(b.norm(y, kind="rmsnorm"))
        b.all_reduce(b.transpose(b.reshape(y, (2, 4, 4)), (0, 2, 1)), 4)
        graphs.append(b.g)
    assert canonical(graphs[0]) == canonical(graphs[1])


# -- fusion -----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def rn():
    return core.resnet18_graph(1, 32), ref.resnet18_graph(1, 32)


def test_candidates_respect_constraints(rn):
    mine, want = rn
    cfg = core.FusionConfig(max_len=6, max_conv=2, max_gemm=1)
    cands = core.enumerate_candidates(mine, core.edge_tpu(), cfg)
    assert cands
    for c in cands:
        classes = [mine.nodes[n].op_class for n in c]
        assert len(c) <= cfg.max_len
        assert classes.count("conv") <= cfg.max_conv and classes.count("gemm") <= cfg.max_gemm
    assert cands == ref.enumerate_candidates(want, ref.edge_tpu(),
                                             ref.FusionConfig(max_len=6, max_conv=2,
                                                              max_gemm=1))


def test_candidates_single_external_output(rn):
    mine, want = rn
    cands = core.enumerate_candidates(mine, core.edge_tpu(), core.FusionConfig(max_len=5))
    for c in [c for c in cands if len(c) > 1][:200]:
        assert sum(1 for n in c if any(s not in set(c) for s in mine.successors(n))) <= 1
    assert cands == ref.enumerate_candidates(want, ref.edge_tpu(), ref.FusionConfig(max_len=5))


@pytest.mark.parametrize("hda", ["edge_tpu", "fusemax"])
@pytest.mark.parametrize("kind", ["resnet18", "resnet18_train"])
def test_partitions_and_schedules_equal_reference(kind, hda):
    """``solve_fusion`` (an exact cover with an acyclic quotient that beats
    layer-by-layer), ``manual_fusion``, ``greedy_sram_partition`` and
    ``layer_by_layer``: the reference's partitions, and the same schedules."""
    graphs = []
    for mod in (core, ref):
        g = mod.resnet18_graph(1, 32)
        graphs.append(mod.build_training_graph(g, "adam").graph if kind.endswith("train")
                      else g)
    mine, want = graphs
    h, ref_h = getattr(core, hda)(), getattr(ref, hda)()
    cfg, ref_cfg = core.FusionConfig(max_len=6, time_limit_s=3), \
        ref.FusionConfig(max_len=6, time_limit_s=3)
    parts = {"solver": core.solve_fusion(mine, h, cfg), "manual": core.manual_fusion(mine),
             "greedy": core.greedy_sram_partition(mine, h), "lbl": core.layer_by_layer(mine)}
    want_parts = {"solver": ref.solve_fusion(want, ref_h, ref_cfg),
                  "manual": ref.manual_fusion(want),
                  "greedy": ref.greedy_sram_partition(want, ref_h),
                  "lbl": ref.layer_by_layer(want)}
    assert parts == want_parts
    assert sorted(n for sg in parts["solver"] for n in sg) == sorted(mine.nodes)
    core.quotient_dag(mine, parts["solver"])
    core.quotient_dag(mine, parts["manual"])
    results = {k: core.schedule(mine, h, p) for k, p in parts.items()}
    for k, p in want_parts.items():
        same(results[k], ref.schedule(want, ref_h, p))
    assert results["manual"].n_subgraphs < len(mine)
    assert results["solver"].energy <= results["lbl"].energy
    if kind == "resnet18":
        assert results["solver"].latency < results["lbl"].latency
        assert results["solver"].n_subgraphs < results["lbl"].n_subgraphs


def test_fusion_on_training_graph():
    hda = core.edge_tpu()
    tg = core.build_training_graph(core.mlp_graph(batch=16, widths=(64, 64))).graph
    part = core.solve_fusion(tg, hda, core.FusionConfig(max_len=6, time_limit_s=3))
    assert core.schedule(tg, hda, part).energy <= core.schedule(tg, hda).energy
    core.quotient_dag(tg, part)
    ref_tg = ref.build_training_graph(ref.mlp_graph(batch=16, widths=(64, 64))).graph
    assert part == ref.solve_fusion(ref_tg, ref.edge_tpu(),
                                    ref.FusionConfig(max_len=6, time_limit_s=3))


def test_solve_cover_minimality():
    cands = [("a", "b"), ("c", "d"), ("a",), ("b",), ("c",), ("d",), ("b", "c")]
    idx = {k: i for i, k in enumerate("abcd")}
    sol = core.solve_cover(4, cands, idx, time_limit_s=2)
    assert len(sol) == 2 and sol == ref.solve_cover(4, cands, idx, time_limit_s=2)
    # the branch-and-bound fallback alone gives the same cover
    assert fusion._solve_cover_bnb(4, cands, idx, 2) == \
        ref_fusion._solve_cover_bnb(4, cands, idx, 2)


def test_gpt2_fusion_runs():
    g, want = core.gpt2_graph(1, 64, 64, 2, 2, 256), ref.gpt2_graph(1, 64, 64, 2, 2, 256)
    part = core.solve_fusion(g, core.fusemax(), core.FusionConfig(max_len=5, time_limit_s=3))
    res = core.schedule(g, core.fusemax(), part)
    assert res.latency > 0
    want_part = ref.solve_fusion(want, ref.fusemax(), ref.FusionConfig(max_len=5,
                                                                        time_limit_s=3))
    assert part == want_part
    same(res, ref.schedule(want, ref.fusemax(), want_part))


def test_tarjan_matches_networkx_and_reference():
    nx = pytest.importorskip("networkx")
    import random

    rng = random.Random(7)
    n = 60
    succ = [set() for _ in range(n)]
    for _ in range(150):
        a, b = rng.randrange(n), rng.randrange(n)
        if a != b:
            succ[a].add(b)
    got = fusion.tarjan_sccs(n, succ)
    assert got == ref_fusion.tarjan_sccs(n, succ)
    g = nx.DiGraph()
    g.add_nodes_from(range(n))
    g.add_edges_from((a, b) for a in range(n) for b in succ[a])
    assert {frozenset(c) for c in got} == \
        {frozenset(c) for c in nx.strongly_connected_components(g)}


def test_repair_partition_quotient_consistency():
    g = core.build_training_graph(core.resnet18_graph(1, 32), "adam").graph
    part, quotient = fusion.repair_partition(g, core.manual_fusion(g), return_quotient=True)
    _, succ = core.quotient_dag(g, part)
    for i in range(len(part)):
        assert set(quotient[i]) == set(succ.get(i, ()))
    want_g = ref.build_training_graph(ref.resnet18_graph(1, 32), "adam").graph
    want = ref_fusion.repair_partition(want_g, ref.manual_fusion(want_g),
                                       return_quotient=True)
    assert (part, quotient) == want


# -- fusion_search ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def tg():
    return (core.build_training_graph(core.mlp_graph(batch=8, widths=(32, 32)), "adam"),
            ref.build_training_graph(ref.mlp_graph(batch=8, widths=(32, 32)), "adam"))


def test_ones_genome_decodes_to_layer_by_layer(tg):
    g = tg[0].graph
    checker = core.GroupChecker(g, core.edge_tpu())
    part = core.decode_genome(g.topo_order(), np.ones(len(g) - 1, bool), checker)
    assert part == core.layer_by_layer(g)


def test_zeros_genome_decodes_to_greedy_growth(tg):
    g, want = tg[0].graph, tg[1].graph
    part = core.decode_genome(g.topo_order(), np.zeros(len(g) - 1, bool),
                              core.GroupChecker(g, core.edge_tpu()))
    assert part == core.greedy_sram_partition(g, core.edge_tpu())
    assert any(len(sg) > 1 for sg in part)
    assert part == ref.decode_genome(want.topo_order(), np.zeros(len(want) - 1, bool),
                                     ref.GroupChecker(want, ref.edge_tpu()))


def test_encode_decode_roundtrip(tg):
    g = tg[0].graph
    order = g.topo_order()
    part = core.greedy_sram_partition(g, core.edge_tpu())
    genome = core.encode_partition(order, part)
    assert core.decode_genome(order, genome, core.GroupChecker(g, core.edge_tpu())) == part
    np.testing.assert_array_equal(genome, ref.encode_partition(order, part))


def test_random_genomes_decode_to_valid_partitions(tg):
    g, want = tg[0].graph, tg[1].graph
    order = g.topo_order()
    checker = core.GroupChecker(g, core.edge_tpu())
    ref_checker = ref.GroupChecker(want, ref.edge_tpu())
    rng = np.random.default_rng(0)
    for _ in range(16):
        genome = rng.random(len(order) - 1) < 0.5
        part = core.decode_genome(order, genome, checker)
        assert sorted(n for sg in part for n in sg) == sorted(g.nodes)
        core.quotient_dag(g, part)
        assert all(checker.feasible(sg) for sg in part)
        assert part == ref.decode_genome(order, genome, ref_checker)


def test_decoded_groups_respect_constraints(tg):
    g = tg[0].graph
    checker = core.GroupChecker(g, core.edge_tpu())
    cfg = checker.cfg
    for sg in core.decode_genome(g.topo_order(), np.zeros(len(g) - 1, bool), checker):
        classes = [g.nodes[n].op_class for n in sg]
        assert len(sg) <= cfg.max_len
        assert classes.count("conv") <= cfg.max_conv and classes.count("gemm") <= cfg.max_gemm


def test_second_evaluation_costs_zero_fresh_signings(tg):
    g, hda = tg[0].graph, core.edge_tpu()
    eng = EvalEngine(hda)
    part = core.greedy_sram_partition(g, hda)
    first = core.evaluate_partition(g, hda, part, engine=eng)
    signs0, stats0 = sign_count(), dict(eng.stats)
    second = core.evaluate_partition(g, hda, part, engine=eng)
    assert sign_count() - signs0 == 0
    assert eng.stats["node_misses"] == stats0["node_misses"]
    assert eng.stats["sg_misses"] == stats0["sg_misses"]
    assert eng.stats["sched_hits"] == stats0["sched_hits"] + 1
    assert second.objectives == first.objectives
    same(first, ref.evaluate_partition(tg[1].graph, ref.edge_tpu(), part))


def test_partition_sig_distinguishes_boundaries(tg):
    g, hda = tg[0].graph, core.edge_tpu()
    bound = EvalEngine(hda).bind(g)
    p1, p2 = core.layer_by_layer(g), core.greedy_sram_partition(g, hda)
    assert bound.partition_sig(p1) != bound.partition_sig(p2)
    assert bound.partition_sig(p2) == bound.partition_sig(list(p2))


def search_fields(res) -> tuple:
    """What a ``FusionSearchResult`` says of the search; ``stats`` only
    its own evaluator's counters (the engine's depend on what ran before)."""
    return (as_plain(res.baseline), as_plain(res.greedy), as_plain(res.best),
            as_plain(res.pareto), as_plain(res.ga), res.order, as_plain(res.findings),
            {k: res.stats[k] for k in ("genome_evals", "unique_partitions", "memo_hits")})


def test_search_deterministic_under_fixed_seed(tg):
    g = tg[0].graph
    r1 = core.search_fusion(g, core.edge_tpu(), core.FusionSearchConfig(pop_size=8,
                                                                         generations=4, seed=7))
    r2 = core.search_fusion(g, core.edge_tpu(), core.FusionSearchConfig(pop_size=8,
                                                                         generations=4, seed=7))
    assert r1.best.partition == r2.best.partition
    assert [c.objectives for c in r1.pareto] == [c.objectives for c in r2.pareto]
    want = ref.search_fusion(tg[1].graph, ref.edge_tpu(),
                             ref.FusionSearchConfig(pop_size=8, generations=4, seed=7))
    assert search_fields(r1) == search_fields(want)


def test_search_matches_exhaustive_on_tiny_graph():
    hda = core.edge_tpu()
    g = core.mlp_graph(batch=4, d_in=16, widths=(16,), n_classes=4)
    exact = core.exhaustive_fusion(g, hda)
    found = core.search_fusion(g, hda, core.FusionSearchConfig(pop_size=8, generations=6))
    assert found.best.latency == exact.best.latency
    assert min(c.peak_mem for c in found.pareto) == min(c.peak_mem for c in exact.pareto)
    assert found.best.partition == exact.best.partition
    want = ref.exhaustive_fusion(ref.mlp_graph(batch=4, d_in=16, widths=(16,), n_classes=4),
                                 ref.edge_tpu())
    same((exact.baseline, exact.greedy, exact.best, exact.pareto, exact.order, exact.stats),
         (want.baseline, want.greedy, want.best, want.pareto, want.order, want.stats))


def test_searched_best_dominates_unfused_baseline():
    cfg = dict(pop_size=12, generations=4)
    res = core.search_fusion(core.build_training_graph(core.resnet18_graph(1, 32),
                                                       "adam").graph,
                             core.edge_tpu(), core.FusionSearchConfig(**cfg))
    assert len(res.pareto) >= 3 and res.best_dominates_baseline
    assert res.best.latency < res.baseline.latency
    assert res.best.peak_mem <= res.baseline.peak_mem
    for c in res.pareto:         # the front is mutually non-dominated
        assert not any(
            all(a <= b for a, b in zip(o.objectives, c.objectives, strict=True))
            and any(a < b for a, b in zip(o.objectives, c.objectives, strict=True))
            for o in res.pareto if o is not c)
    want = ref.search_fusion(ref.build_training_graph(ref.resnet18_graph(1, 32),
                                                      "adam").graph,
                             ref.edge_tpu(), ref.FusionSearchConfig(**cfg))
    assert search_fields(res) == search_fields(want)


@pytest.mark.parametrize("hda", ["edge_tpu", "fusemax"])
def test_search_fusion_on_small_gpt2_equals_reference(hda):
    """``search_fusion`` on the small GPT-2's training graph: the reference's
    front, best, baseline and GA arrays."""
    cfg = dict(pop_size=8, generations=4, seed=3)
    g = core.build_training_graph(core.gpt2_graph(1, 64, 128, 2, 4, 512), "adam").graph
    want_g = ref.build_training_graph(ref.gpt2_graph(1, 64, 128, 2, 4, 512), "adam").graph
    got = core.search_fusion(g, getattr(core, hda)(), core.FusionSearchConfig(**cfg))
    want = ref.search_fusion(want_g, getattr(ref, hda)(), ref.FusionSearchConfig(**cfg))
    assert search_fields(got) == search_fields(want)
    assert got.best.latency <= got.baseline.latency


def test_policy_composed_search_keeps_dma_singleton(tg):
    my_tg, ref_tg = tg
    cfg = dict(pop_size=6, generations=2)
    res = core.search_fusion_policy(my_tg, core.edge_tpu(),
                                    core.uniform_policy(my_tg, core.ActivationPolicy.OFFLOAD),
                                    core.FusionSearchConfig(**cfg))
    dma = {n for sg in res.best.partition for n in sg if n.startswith(("offload:", "fetch:"))}
    assert dma
    for sg in res.best.partition:
        if any(n in dma for n in sg):
            assert len(sg) == 1
    want = ref.search_fusion_policy(ref_tg, ref.edge_tpu(),
                                    ref.uniform_policy(ref_tg, ref.ActivationPolicy.OFFLOAD),
                                    ref.FusionSearchConfig(**cfg))
    assert search_fields(res) == search_fields(want)


def test_singletons_feasible_under_degenerate_configs(tg):
    g = tg[0].graph
    for cfg in (core.FusionConfig(max_conv=0, max_gemm=0), core.FusionConfig(max_len=0)):
        part = core.greedy_sram_partition(g, core.edge_tpu(), cfg)
        assert sorted(n for sg in part for n in sg) == sorted(g.nodes)


def test_unknown_fusion_mode_raises(tg):
    with pytest.raises(ValueError, match="unknown fusion mode"):
        core.fusion_partition(tg[0].graph, core.edge_tpu(), "greed")
    with pytest.raises(ValueError, match="unknown fusion mode"):
        core.evaluate_policy(tg[0], core.edge_tpu(), {}, fusion="solvr")


def test_fusion_modes_as_the_reference_sweep_schedules_them():
    """``tests/test_fusion_search.py::test_sweep_fusion_modes`` without
    ``dse`` (not in the port yet): each mode's partition from
    ``fusion_partition`` scheduled on the sweep's one design point gives the
    latency the reference's ``sweep`` reports, and fusing is no slower."""
    space = {"x_pes": [4], "y_pes": [4], "simd_units": [64], "lanes": [4]}
    cfg = dict(pop_size=6, generations=2)
    lat = {}
    for mode in ("none", "greedy", "search"):
        g, hda = core.mlp_graph(), core.edge_tpu(x_pes=4, y_pes=4, simd_units=64, lanes=4)
        part, quotient = core.fusion_partition(g, hda, mode, core.FusionSearchConfig(**cfg))
        lat[mode] = core.schedule(g, hda, part, quotient=quotient).latency
        (pt,) = ref_dse.sweep(ref.edge_tpu, space, {"mlp": ref.mlp_graph()}, fusion=mode,
                              fusion_cfg=ref.FusionSearchConfig(**cfg))
        assert lat[mode] == pt.results["mlp"].latency, mode
    assert lat["greedy"] <= lat["none"] and lat["search"] <= lat["none"]
