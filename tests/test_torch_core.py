"""The port's copies of MONET's analytic core (``repro_torch.core``: graph,
accelerators, cost_model, training_transform, memory, engine, verify,
scheduling) held bit for bit against ``repro.core``.

Each reference graph is copied field by field into the port's classes
(``to_port``), so these modules are held apart from the port's own ``zoo``
(``tests/test_torch_search.py``); every comparison is exact."""

import dataclasses

import numpy as np
import pytest

import repro.core as ref
import repro_torch.core as core
from repro.core import zoo
from repro_torch.core import accelerators, cost_model, graph, memory, scheduling
from repro_torch.core import training_transform as tt
from repro_torch.core import verify

GRAPHS = {
    "mlp": lambda: zoo.mlp_graph(),
    "resnet18": lambda: zoo.resnet18_graph(),
    "gpt2": lambda: zoo.gpt2_graph(batch=1, seq=64, d_model=128, n_layers=2, n_heads=4,
                                   vocab=512),
}
HDAS = ("edge_tpu", "fusemax", "tpu_v5e_like")


def to_port(g) -> graph.WorkloadGraph:
    """A reference ``WorkloadGraph`` rebuilt in the port's classes, tensors
    and nodes in the reference's insertion order."""
    out = graph.WorkloadGraph(g.name)
    for spec in g.tensors.values():
        out.add_tensor(graph.TensorSpec(**{f.name: getattr(spec, f.name)
                                           for f in dataclasses.fields(spec)}))
    for nd in g.nodes.values():
        out.add_node(graph.Node(nd.name, nd.op, nd.kind, dict(nd.dims), list(nd.inputs),
                                list(nd.outputs), nd.flops, nd.source, dict(nd.meta)))
    return out


def canonical(g) -> tuple:
    """Every field of every tensor and node, in insertion order, and the
    derived producer / consumer maps."""
    return (g.name,
            [dataclasses.astuple(s) for s in g.tensors.values()],
            [(n.name, n.op, n.kind, sorted(n.dims.items()), n.inputs, n.outputs, n.flops,
              n.source, sorted(n.meta.items(), key=str), n.op_class, n.macs)
             for n in g.nodes.values()],
            dict(g.producer), {t: list(c) for t, c in g.consumers.items()},
            g.topo_order(), g.total_flops())


def pair(kind: str):
    """(reference graph, port graph): a zoo graph, or (``<name>_train``) the
    training graph each side's ``build_training_graph`` makes of it."""
    name, _, train = kind.partition("_")
    ref_g = GRAPHS[name]()
    mine = to_port(ref_g)
    if train:
        ref_tg = ref.build_training_graph(ref_g, "adam")
        my_tg = tt.build_training_graph(mine, "adam")
        assert my_tg.param_grads == ref_tg.param_grads
        assert my_tg.activations == ref_tg.activations
        assert my_tg.optimizer == ref_tg.optimizer
        return ref_tg.graph, my_tg.graph
    return ref_g, mine


KINDS = [k + t for k in GRAPHS for t in ("", "_train")]


def as_plain(x):
    """Dataclasses, numpy arrays and dicts as comparable plain values."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: as_plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, np.ndarray):
        return ("ndarray", x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, dict):
        return {k: as_plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(as_plain(v) for v in x)
    return x


@pytest.mark.parametrize("kind", KINDS)
def test_graph_copy_and_training_transform_are_the_references(kind):
    ref_g, mine = pair(kind)
    assert canonical(mine) == canonical(ref_g)
    mine.validate()
    assert memory.static_breakdown(mine) == ref.static_breakdown(ref_g)
    assert [memory.tensor_category(mine, t) for t in mine.tensors] == \
        [ref.tensor_category(ref_g, t) for t in ref_g.tensors]


@pytest.mark.parametrize("use_engine", [True, False], ids=["engine", "reference_path"])
@pytest.mark.parametrize("hda", HDAS)
@pytest.mark.parametrize("kind", KINDS)
def test_schedule_equals_reference(kind, hda, use_engine):
    """Every ``ScheduleResult`` field, ``mem_breakdown`` and
    ``per_core_busy`` included, equal to the reference's, exactly."""
    ref_g, mine = pair(kind)
    want = ref.schedule(ref_g, getattr(ref, hda)(), use_engine=use_engine)
    got = core.schedule(mine, getattr(core, hda)(), use_engine=use_engine)
    assert as_plain(got) == as_plain(want)
    assert got.mac_utilization == want.mac_utilization
    assert got.ckpt_bytes == want.ckpt_bytes
    assert got.as_row() == want.as_row()


@pytest.mark.parametrize("hda", HDAS)
@pytest.mark.parametrize("kind", ["mlp_train", "resnet18", "gpt2_train"])
def test_cost_model_per_node_equals_reference(kind, hda):
    ref_g, mine = pair(kind)
    ref_cm = ref.CostModel(ref_g, getattr(ref, hda)())
    my_cm = cost_model.CostModel(mine, getattr(core, hda)())
    for name in ref_g.topo_order():
        assert as_plain(my_cm.node_cost(mine.nodes[name])) == \
            as_plain(ref_cm.node_cost(ref_g.nodes[name])), name
        assert my_cm.core_for(mine.nodes[name]).name == ref_cm.core_for(ref_g.nodes[name]).name
    part = [tuple(ref_g.topo_order()[i:i + 3]) for i in range(0, len(ref_g), 3)]
    for sg in part[:40]:
        assert as_plain(my_cm.subgraph_cost(list(sg))) == \
            as_plain(ref_cm.subgraph_cost(list(sg))), sg


@pytest.mark.parametrize("kind", ["mlp_train", "gpt2_train", "resnet18_train"])
def test_lifetime_plan_and_profile_equal_reference(kind):
    ref_g, mine = pair(kind)
    order = ref_g.topo_order()
    part = [(n,) for n in order]
    ref_plan = ref.build_lifetime_plan(ref_g, part)
    my_plan = memory.build_lifetime_plan(mine, part)
    assert as_plain(my_plan) == as_plain(ref_plan)
    rng = np.random.default_rng(0)
    for perm in (np.arange(len(part)), rng.permutation(len(part))):
        assert as_plain(memory.lifetime_profile(my_plan, perm)) == \
            as_plain(ref.lifetime_profile(ref_plan, perm))
    assert memory.schedule_priorities(mine, part) == ref.schedule_priorities(ref_g, part)


@pytest.mark.parametrize("kind", ["gpt2_train", "resnet18_train"])
def test_verifier_and_batch_scoring_equal_reference(kind):
    ref_g, mine = pair(kind)
    assert as_plain(verify.verify_graph(mine)) == as_plain(ref.verify_graph(ref_g))
    hdas = [(getattr(ref, h)(), getattr(core, h)()) for h in HDAS]
    part = [(n,) for n in ref_g.topo_order()]
    got = scheduling.schedule_batch([(mine, h, part) for _, h in hdas])
    want = ref.scheduling.schedule_batch([(ref_g, h, part) for h, _ in hdas])
    assert as_plain(got) == as_plain(want)
    eng = core.get_engine(hdas[2][1])
    assert as_plain(eng.score_batch([(mine, None, part)])) == \
        as_plain(ref.get_engine(hdas[2][0]).score_batch([(ref_g, None, part)]))
    res = core.schedule(mine, hdas[2][1], part)
    assert as_plain(verify.verify_result(mine, hdas[2][1], part, res)) == \
        as_plain(ref.verify_result(ref_g, hdas[2][0], part,
                                   ref.schedule(ref_g, hdas[2][0], part)))


SPECS = [
    ("edge_tpu", ()), ("fusemax", ()), ("tpu_v5e_like", ()), ("tpu_v5e_like", (1.5,)),
    ("edge_tpu", (8, 8, 32)), ("edge_fault_model", ()), ("datacenter_fault_model", ()),
    ("edge_cluster", ()), ("datacenter_cluster", (16,)),
]


@pytest.mark.parametrize("fn,args", SPECS, ids=[f"{f}{a}" for f, a in SPECS])
def test_spec_dataclasses_equal_reference(fn, args):
    assert as_plain(getattr(accelerators, fn)(*args)) == as_plain(getattr(ref, fn)(*args))


def test_spaces_grid_and_interconnect_equal_reference():
    for space in ("EDGE_TPU_SPACE", "FUSEMAX_SPACE"):
        assert getattr(core, space) == getattr(ref, space)
        assert core.grid(getattr(core, space)) == ref.grid(getattr(ref, space))
    assert as_plain(core.TPU_V5E) == as_plain(ref.TPU_V5E)
    assert as_plain(core.with_interconnect(core.fusemax(), 64.0, 500.0)) == \
        as_plain(ref.with_interconnect(ref.fusemax(), 64.0, 500.0))
    assert as_plain(core.MEM_CATEGORIES) == as_plain(ref.MEM_CATEGORIES)
    assert core.OPTIMIZERS == ref.OPTIMIZERS
    assert sorted(core.RULES) == sorted(ref.RULES)
    assert graph.OP_CLASS == ref.graph.OP_CLASS


def test_exports_are_the_references_for_the_copied_modules():
    """``repro_torch.core`` exports what ``repro.core`` exports from the
    modules it holds (the search layer among them), each name as the
    reference exports it, and nothing of the modules it has not copied."""
    copied = {"graph", "accelerators", "cost_model", "training_transform", "memory",
              "engine", "verify", "scheduling", "trace", "remat_policy", "nsga2", "builders",
              "zoo", "fusion", "fusion_search", "checkpointing", "batch"}
    want = {k for k in ref.__all__
            if getattr(getattr(ref, k), "__module__", "").rsplit(".", 1)[-1] in copied
            or k in {"EDGE_TPU_SPACE", "FUSEMAX_SPACE", "TPU_V5E", "MEM_CATEGORIES",
                     "OPTIMIZERS", "RULES"}}
    assert want <= set(core.__all__), sorted(want - set(core.__all__))
    for k in want:
        mine, theirs = getattr(core, k), getattr(ref, k)
        assert type(mine).__name__ == type(theirs).__name__, k
        assert getattr(mine, "__module__", "").rsplit(".", 1)[-1] == \
            getattr(theirs, "__module__", "").rsplit(".", 1)[-1], k
    assert {"GraphBuilder", "ga_checkpointing", "gpt2_graph", "search_fusion",
            "nsga2"} <= set(core.__all__)
    assert not {"sweep", "evaluate_serve", "ga_parallel", "degrade", "inject"} & \
        set(core.__all__)


def test_population_evaluator_waits_for_batch():
    """``EvalEngine.population_evaluator``, which waited for ``core/batch.py``,
    returns the port's ``PopulationEvaluator``; it scores the ``mlp_graph()``
    training graph's keep-masks and genomes as the reference's does."""
    from repro_torch.core.batch import PopulationEvaluator
    tg = tt.build_training_graph(to_port(zoo.mlp_graph()), "adam")
    ref_tg = ref.build_training_graph(zoo.mlp_graph(), "adam")
    ev = core.get_engine(core.tpu_v5e_like()).population_evaluator(tg)
    want = ref.get_engine(ref.tpu_v5e_like()).population_evaluator(ref_tg)
    assert isinstance(ev, PopulationEvaluator)
    rng = np.random.default_rng(0)
    n = len(ev.acts)
    assert ev.acts == want.acts
    masks = [rng.random(n) < 0.5 for _ in range(3)]
    genomes = [rng.integers(0, 3, n) for _ in range(3)]
    assert ev.score_keep_batch(masks) == want.score_keep_batch(masks)
    assert ev.score_policy_batch(genomes) == want.score_policy_batch(genomes)
