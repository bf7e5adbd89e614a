"""Vectorized, cache-aware evaluation engine for the schedule/cost hot paths.

Every MONET experiment — DSE sweeps, the fusion solver, the NSGA-II
activation-checkpointing GA — bottoms out in thousands of near-identical
calls to ``schedule()`` → ``subgraph_cost()`` → ``node_cost()``.  This module
makes repeated evaluation cheap *by construction*:

1.  **Structure-of-arrays signature precomputation.**  Per graph (cached on
    the graph, keyed by its structural version) every node is reduced to a
    canonical *cost signature* ``(op_class, sorted dims, flops, per-input
    bytes + duplicate pattern, per-output bytes, element bytes)``.  Repeated
    transformer blocks and ``.rc`` recompute clones share signatures, so a
    GPT-2 training graph collapses to a few dozen unique cost evaluations.

2.  **Signature-keyed memoization with explicit invalidation.**  An
    ``EvalEngine`` is bound to one ``(HDASpec, tensor_parallel)`` pair and
    caches

    * compute cycles per signature,
    * ``NodeCost`` per ``(signature, residency mask, internal mask)``,
    * fused-subgraph ``NodeCost`` per subgraph signature (the tuple of node
      triples plus link/internal byte totals),
    * full ``ScheduleResult`` per ``(graph fingerprint, partition)``.

    Because keys are *content* signatures — never node names or graph
    identities — the caches stay valid across graph rewrites: the
    checkpointing GA only pays for the delta each keep-mask introduces,
    and DSE sweeps share per-graph signature tables across every
    architecture in the grid.  Graph-side tables invalidate automatically
    via ``WorkloadGraph._version`` (bumped on every mutation).

The engine is numerically *identical* to ``CostModel`` — both call the same
pure arithmetic kernels in ``cost_model`` (see ``tests/test_engine_parity``).

The port's own copy of ``repro.core.engine`` (numpy and plain Python):
names, signatures and numeric code are the reference's, held bit for
bit against it by ``tests/test_torch_core.py``.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field

from .accelerators import CoreSpec, HDASpec
from .cost_model import (KV_FREE_OPS, NodeCost, collective_wire,
                         comm_node_cost, comm_payload, compute_cycles,
                         dma_node_cost, kv_free_node_cost, node_cost_arith,
                         subgraph_tail)
from .graph import Node, WorkloadGraph, dtype_bytes
from .memory import MEM_CATEGORIES, category_code

# ---------------------------------------------------------------------------
# signature interning
# ---------------------------------------------------------------------------

#: signature tuple -> small int id, shared process-wide.  Interning makes the
#: per-call cache keys tiny (ints + bool masks) instead of large tuples.
_SIG_IDS: dict[tuple, int] = {}
_SIG_GEN = 0          # bumped when the intern table is cleared
_SIG_LIMIT = 1 << 21  # safety valve for very long-lived processes

#: (CoreSpec, tp, offchip_bw, offchip_e) -> small int id.  Node costs depend
#: on the HDA only through this tuple, so architectures that share a core
#: (e.g. every Edge-TPU config has the same SIMD core) share cost entries
#: across an entire DSE sweep.
_CORE_KEYS: dict[tuple, int] = {}

#: shared cost caches, keyed by interned ids — survive across engines
_CYC: dict[tuple, float] = {}           # (core id, sig id) -> compute cycles
_NODE_COSTS: dict[tuple, NodeCost] = {}  # (core id, sid, rmask, imask)


#: fresh node signings since process start (``_sign_node`` invocations).
#: Monotonic — the delta across a code region measures how much signature
#: work it forced, e.g. the fusion-search tests assert a second evaluation
#: of an identical partition signs zero nodes.
_SIGN_COUNT = 0


def sign_count() -> int:
    """Total fresh node signings so far (monotonic counter)."""
    return _SIGN_COUNT


def _sig_id(sig: tuple) -> int:
    i = _SIG_IDS.get(sig)
    if i is None:
        global _SIG_GEN
        if len(_SIG_IDS) >= _SIG_LIMIT:
            _SIG_IDS.clear()
            _CYC.clear()          # keyed by sig ids: ids are reassigned
            _NODE_COSTS.clear()
            _SIG_GEN += 1         # invalidates every dependent cache
        i = len(_SIG_IDS)
        _SIG_IDS[sig] = i
    return i


def _core_key(core: CoreSpec, tp: int, hda: HDASpec) -> int:
    k = (core, tp, hda.offchip_bw, hda.offchip_e)
    i = _CORE_KEYS.get(k)
    if i is None:
        i = len(_CORE_KEYS)
        _CORE_KEYS[k] = i
    return i


def _comm_key(hda: HDASpec) -> int:
    """Interned id of the facts a collective's cost depends on: interconnect
    + off-chip memory.  Chips with different compute cores but the same
    interconnect share collective cost entries across a sweep."""
    k = ("comm", hda.offchip_bw, hda.offchip_e, hda.ici_bw,
         hda.ici_latency, hda.ici_topology, hda.ici_e)
    i = _CORE_KEYS.get(k)
    if i is None:
        i = len(_CORE_KEYS)
        _CORE_KEYS[k] = i
    return i


def _dma_key(hda: HDASpec) -> int:
    """Interned id of the facts an activation-offload DMA transfer depends
    on: off-chip bandwidth + energy only, so chips differing in compute
    cores or interconnect still share DMA cost entries across a sweep."""
    k = ("dma", hda.offchip_bw, hda.offchip_e)
    i = _CORE_KEYS.get(k)
    if i is None:
        i = len(_CORE_KEYS)
        _CORE_KEYS[k] = i
    return i


def tiling_factor(op_class: str, dims: dict) -> int:
    """Outer temporal loop extent used as the intra-core tiling factor
    (shared with the fusion solver's candidate enumeration)."""
    if op_class == "conv":
        return max(dims.get("OY", 1), 1)
    if op_class == "gemm":
        return max(dims.get("M", 1), 1)
    return 1  # element-wise ops tile freely


# ---------------------------------------------------------------------------
# per-graph signature tables (SoA precomputation)
# ---------------------------------------------------------------------------


@dataclass
class GraphSigs:
    """Structure-of-arrays view of one graph, cached per structural version.

    Updated *incrementally*: ``WorkloadGraph`` mutators record dirty node
    names, ``copy()`` clones the tables, so a checkpointing rewrite (clone +
    a few ``.rc`` nodes + rewired consumers) re-signs only its delta."""

    version: int
    gen: int
    tb: dict = field(default_factory=dict)        # tensor -> bytes
    sid: dict = field(default_factory=dict)       # node -> signature id
    zmask: dict = field(default_factory=dict)     # node -> (sid, 0-rmask, 0-imask)
    io_bytes: dict = field(default_factory=dict)  # node -> unique in+out bytes
    tiling: dict = field(default_factory=dict)    # node -> tiling factor
    node_macs: dict = field(default_factory=dict)  # node -> macs
    fp_entry: dict = field(default_factory=dict)  # node -> fingerprint entry
    static: int = 0                # Σ bytes of param/state/input tensors
    static_names: dict = field(default_factory=dict)  # name -> counted bytes
    cat: dict = field(default_factory=dict)       # tensor -> mem category code
    static_by_cat: dict = field(default_factory=dict)  # W/S/I static split
    macs_total: int = 0
    _fp: "Fingerprint | None" = None              # lazy schedule fingerprint

    def clone(self, version: int) -> "GraphSigs":
        return GraphSigs(version, self.gen, dict(self.tb), dict(self.sid),
                         dict(self.zmask), dict(self.io_bytes),
                         dict(self.tiling), dict(self.node_macs),
                         dict(self.fp_entry), self.static,
                         dict(self.static_names), dict(self.cat),
                         dict(self.static_by_cat), self.macs_total, self._fp)


_NO_MASK = ((), ())     # shared empty masks


def _sign_node(graph: WorkloadGraph, s: GraphSigs, name: str) -> None:
    global _SIGN_COUNT
    _SIGN_COUNT += 1
    nd = graph.nodes[name]
    tensors = graph.tensors
    tb = s.tb
    ins, outs = nd.inputs, nd.outputs
    for t in ins:
        if t not in tb:
            tb[t] = tensors[t].bytes
    for t in outs:
        if t not in tb:
            tb[t] = tensors[t].bytes
    in_bytes = tuple(tb[t] for t in ins)
    first: dict[str, int] = {}
    in_pat = tuple(first.setdefault(t, i) for i, t in enumerate(ins))
    out_bytes = tuple(tb[t] for t in outs)
    for t in outs:
        # memory category of produced tensors, cached for plan builds
        s.cat[t] = category_code(tensors[t], nd.kind)
    eb = dtype_bytes(tensors[outs[0]].dtype) if outs else 2
    cls = nd.op_class
    # comm ops differ in wire/hop formulas per collective (and dma ops in
    # transfer direction), so the concrete op is part of the signature;
    # KV bookkeeping ops are free unlike every other move op
    sig = (nd.op if cls in ("comm", "dma") or nd.op in KV_FREE_OPS else cls,
           tuple(sorted(nd.dims.items())), nd.flops,
           in_bytes, in_pat, out_bytes, eb)
    i = _sig_id(sig)
    s.sid[name] = i
    s.zmask[name] = (i, (False,) * len(ins), (False,) * len(outs))
    s.fp_entry[name] = (name, nd.kind, i, tuple(ins), tuple(outs))
    macs = nd.macs
    s.macs_total += macs - s.node_macs.get(name, 0)
    s.node_macs[name] = macs
    seen: set = set()
    tot = 0
    for t in ins:
        if t not in seen:
            seen.add(t)
            tot += tb[t]
    for t in outs:
        if t not in seen:
            seen.add(t)
            tot += tb[t]
    s.io_bytes[name] = tot
    s.tiling[name] = tiling_factor(cls, nd.dims)


def _static_cat(spec) -> str:
    """Static-footprint category via the memory model's single rule set."""
    return MEM_CATEGORIES[category_code(spec, None)]


def _count_static(graph: WorkloadGraph, s: GraphSigs, names) -> None:
    tensors = graph.tensors
    seen = s.static_names
    by_cat = s.static_by_cat
    for t in names:
        if t in seen:
            continue
        spec = tensors[t]
        if spec.is_param or spec.is_state or spec.is_input:
            s.static += spec.bytes
            seen[t] = spec.bytes
            c = _static_cat(spec)
            by_cat[c] = by_cat.get(c, 0) + spec.bytes


def graph_sigs(graph: WorkloadGraph) -> GraphSigs:
    cached = graph._derived.get("engine_sigs")
    if cached is not None and cached.gen == _SIG_GEN:
        if cached.version == graph._version:
            return cached
        # incremental: refresh byte tables for re-specced tensors
        # (``replace_tensor``), then re-sign only the mutated nodes
        for t in graph._dirty_tensors:
            spec = graph.tensors.get(t)
            if spec is None:
                continue
            nb = spec.bytes
            if cached.tb.get(t, nb) != nb:
                cached.tb[t] = nb
            ob = cached.static_names.get(t)
            if ob is not None and ob != nb:
                cached.static += nb - ob
                cached.static_names[t] = nb
                c = _static_cat(spec)
                cached.static_by_cat[c] = \
                    cached.static_by_cat.get(c, 0) + nb - ob
        for name in graph._dirty_nodes:
            _sign_node(graph, cached, name)
        _count_static(graph, cached, graph._dirty_tensors)
        cached.version = graph._version
        cached._fp = None
        graph._dirty_nodes = set()
        graph._dirty_tensors = set()
        return cached

    s = GraphSigs(graph._version, _SIG_GEN)
    for name in graph.nodes:
        _sign_node(graph, s, name)
    _count_static(graph, s, graph.tensors)
    graph._dirty_nodes = set()
    graph._dirty_tensors = set()
    graph._derived["engine_sigs"] = s
    return s


class Fingerprint:
    """Exact content fingerprint with a precomputed hash, so memo lookups
    hash the full node-entry tuple once instead of on every dict access."""

    __slots__ = ("key", "h")

    def __init__(self, key: tuple):
        self.key = key
        self.h = hash(key)

    def __hash__(self) -> int:
        return self.h

    def __eq__(self, other) -> bool:
        return self is other or (isinstance(other, Fingerprint)
                                 and self.h == other.h
                                 and self.key == other.key)


def _fingerprint(graph: WorkloadGraph, sigs: GraphSigs) -> Fingerprint:
    """Content fingerprint determining every ``ScheduleResult`` field for a
    fixed engine: node structure + signatures + static tensor footprint."""
    if sigs._fp is None:
        fe = sigs.fp_entry
        sigs._fp = Fingerprint(
            (tuple(fe[n] for n in graph.topo_order()), sigs.static))
    return sigs._fp


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


class EvalEngine:
    """Cost-evaluation caches bound to one ``(HDASpec, tensor_parallel)``.

    Cache invalidation rules (see docs/engine.md):
    * graph mutation      → ``WorkloadGraph._version`` bump → signature
      tables rebuilt on next bind; cost caches stay valid (content-keyed);
    * different HDA       → different engine (``get_engine`` registry);
    * intern-table clear  → generation bump → engine caches flushed.
    """

    def __init__(self, hda: HDASpec, tensor_parallel: bool = True):
        self.hda = hda
        self.tensor_parallel = tensor_parallel
        self._compute = (hda.compute_cores() or list(hda.cores))[0]
        simd = hda.simd_cores()
        self._simd = simd[0] if simd else self._compute
        self._gen = _SIG_GEN
        tp = self._compute.count if tensor_parallel else 1
        # interned (core, tp, offchip) ids: the only HDA facts node costs see
        self._ck_compute = _core_key(self._compute, tp, hda)
        self._ck_simd = _core_key(self._simd, 1, hda)
        self._ck_comm = _comm_key(hda)
        self._ck_dma = _dma_key(hda)
        self._sg: dict[tuple, NodeCost] = {}      # subgraph signature
        self._sched: OrderedDict = OrderedDict()  # (fingerprint, partition)
        self._sched_cap = 256
        self._pop_evals: OrderedDict = OrderedDict()  # (fp, acts, fusion)
        self._pop_evals_cap = 8
        self.stats = dict(node_hits=0, node_misses=0, sg_hits=0,
                          sg_misses=0, sched_hits=0, sched_misses=0)

    # -- plumbing -----------------------------------------------------------

    def _check_gen(self) -> None:
        if self._gen != _SIG_GEN:   # intern table was cleared: ids reassigned
            self._sg.clear()
            self._sched.clear()
            self._pop_evals.clear()
            self._gen = _SIG_GEN

    def clear(self) -> None:
        """Explicitly drop this engine's caches (testing / memory pressure)."""
        self._sg.clear()
        self._sched.clear()
        self._pop_evals.clear()

    def core_for_class(self, op_class: str) -> CoreSpec:
        if op_class in ("conv", "gemm"):
            return self._compute
        return self._simd

    def resource_for_class(self, op_class: str) -> str:
        """Scheduling resource a node class occupies: collectives on 'ici',
        offload transfers on 'dma', everything else on its core."""
        if op_class == "comm":
            return "ici"
        if op_class == "dma":
            return "dma"
        return self.core_for_class(op_class).name

    def ckey_for_class(self, op_class: str) -> int:
        if op_class in ("conv", "gemm"):
            return self._ck_compute
        if op_class == "comm":
            return self._ck_comm
        if op_class == "dma":
            return self._ck_dma
        return self._ck_simd

    def tp_for_class(self, op_class: str, core: CoreSpec) -> int:
        if not self.tensor_parallel or op_class not in ("conv", "gemm"):
            return 1
        return core.count

    def bind(self, graph: WorkloadGraph) -> "BoundEngine":
        self._check_gen()
        return BoundEngine(self, graph, graph_sigs(graph))

    # -- schedule memo ------------------------------------------------------

    def sched_get(self, key: tuple):
        hit = self._sched.get(key)
        if hit is not None:
            self._sched.move_to_end(key)
            self.stats["sched_hits"] += 1
        else:
            self.stats["sched_misses"] += 1
        return hit

    def sched_put(self, key: tuple, result) -> None:
        self._sched[key] = result
        if len(self._sched) > self._sched_cap:
            self._sched.popitem(last=False)

    # -- batched population scoring -----------------------------------------

    def population_evaluator(self, tg, fusion: str = "manual"):
        """Memoized :class:`~repro.core.batch.PopulationEvaluator` for one
        training graph.  Keyed on the graph's content fingerprint (plus the
        activation list and fusion mode), so successive searches over the
        same workload — GA restarts, DSE sweep rows, min-of-N benchmark
        repeats — reuse already-scored phenotypes exactly like the schedule
        memo reuses schedules (docs/engine.md, batched evaluation)."""
        from .batch import PopulationEvaluator
        self._check_gen()
        key = (self.bind(tg.graph).fingerprint(),
               tuple(tg.activations), fusion)
        ev = self._pop_evals.get(key)
        if ev is None:
            ev = PopulationEvaluator(tg, self.hda, engine=self,
                                     fusion=fusion)
            self._pop_evals[key] = ev
            if len(self._pop_evals) > self._pop_evals_cap:
                self._pop_evals.popitem(last=False)
        else:
            self._pop_evals.move_to_end(key)
        return ev

    def score_batch(self, jobs: list, processes: int | None = None) -> list:
        """Score ``(graph, hda-or-None, partition[, quotient])`` jobs in one
        vectorized pass — the engine-level entry to
        :func:`repro.core.scheduling.schedule_batch` (jobs with ``None`` HDA
        run on this engine's HDA).  Bit-for-bit equal to the scalar loop."""
        from .scheduling import schedule_batch
        full = []
        for job in jobs:
            g, hda, part = job[0], job[1], job[2]
            q = job[3] if len(job) > 3 else None
            full.append((g, hda if hda is not None else self.hda, part, q))
        # this engine serves the whole batch only when every job runs on its
        # HDA; mixed-architecture batches resolve engines per job
        same = all(h is self.hda for (_, h, _, _) in full)
        return schedule_batch(full, engine=self if same else None,
                              tensor_parallel=self.tensor_parallel,
                              processes=processes)


class BoundEngine:
    """An :class:`EvalEngine` bound to one graph's signature tables."""

    def __init__(self, engine: EvalEngine, graph: WorkloadGraph,
                 sigs: GraphSigs):
        self.engine = engine
        self.graph = graph
        self.sigs = sigs

    def fingerprint(self) -> tuple:
        return _fingerprint(self.graph, self.sigs)

    def partition_sig(self, partition) -> tuple:
        """Interned content signature of a partition: one small int per
        fused group, derived from the member nodes' cost-signature ids in
        order (the same process-wide intern table the node signatures use).
        Two groups share an id iff they are content-identical, so search
        memo tables keyed by this tuple are tiny and hit across
        rename-equivalent graphs (e.g. ``.rc`` recompute clones) — the
        fusion-configuration search keys its genome-evaluation cache on
        this (see docs/fusion_search.md)."""
        sid = self.sigs.sid
        return tuple(_sig_id(("grp",) + tuple(sid[n] for n in sg))
                     for sg in partition)

    # -- node cost ----------------------------------------------------------

    def _cycles(self, ckey: int, sid: int, nd: Node) -> float:
        eng = self.engine
        k = (ckey, sid)
        cyc = _CYC.get(k)
        if cyc is None:
            if nd.op in KV_FREE_OPS:   # bookkeeping: no data movement
                cyc = 1.0
            else:
                core = eng.core_for_class(nd.op_class)
                cyc = compute_cycles(nd, core,
                                     eng.tp_for_class(nd.op_class, core),
                                     eng.hda)
            _CYC[k] = cyc
        return cyc

    def node_cost(self, nd: Node, sid: int, rmask: tuple,
                  imask: tuple) -> NodeCost:
        eng = self.engine
        ckey = eng.ckey_for_class(nd.op_class)
        key = (ckey, sid, rmask, imask)
        c = _NODE_COSTS.get(key)
        if c is not None:
            eng.stats["node_hits"] += 1
            return c
        eng.stats["node_misses"] += 1
        tb = self.sigs.tb
        core = eng.core_for_class(nd.op_class)
        if nd.op in KV_FREE_OPS:    # bookkeeping node: free (see
            c = kv_free_node_cost(core.name)   # cost_model.KV_FREE_OPS)
            _NODE_COSTS[key] = c
            return c
        cyc = self._cycles(ckey, sid, nd)
        seen: set = set()
        inb = 0
        for i, t in enumerate(nd.inputs):
            if rmask[i] or t in seen:
                continue
            seen.add(t)
            inb += tb[t]
        outb = 0
        for i, t in enumerate(nd.outputs):
            if not imask[i]:
                outb += tb[t]
        if nd.op_class == "dma":
            c = dma_node_cost(cyc, inb, outb, eng.hda)
            _NODE_COSTS[key] = c
            return c
        if nd.op_class == "comm":
            d = nd.dims
            wire, _ = collective_wire(nd.op, comm_payload(d),
                                      int(d.get("P", 1)),
                                      eng.hda.ici_topology)
            c = comm_node_cost(cyc, inb, outb, wire, eng.hda)
            _NODE_COSTS[key] = c
            return c
        stationary = streamed = None
        if nd.op_class in ("conv", "gemm") and len(nd.inputs) >= 2:
            if core.dataflow == "ws":
                stationary = tb[nd.inputs[1]]             # weights
                streamed = inb - (stationary if not rmask[1] else 0)
            else:                                         # output-stationary
                stationary = sum(tb[t] for t in nd.outputs)
                streamed = inb
        eb = dtype_bytes(self.graph.tensors[nd.outputs[0]].dtype) \
            if nd.outputs else 2
        c = node_cost_arith(cyc, inb, outb, stationary, streamed or 0,
                            nd.macs, eb, core, eng.hda)
        _NODE_COSTS[key] = c
        return c

    # -- fused subgraph cost ------------------------------------------------

    def subgraph_cost(self, sg) -> NodeCost:
        """Numerically identical to ``CostModel.subgraph_cost`` but memoized
        on the subgraph's content signature."""
        eng = self.engine
        g = self.graph
        nodes = g.nodes
        sid_of = self.sigs.sid
        tb = self.sigs.tb
        consumers = g.consumers

        if len(sg) == 1:
            # fast path: a singleton has no internal tensors (a node cannot
            # consume its own output in a DAG), no residency and no link
            nd = nodes[sg[0]]
            tri = self.sigs.zmask[nd.name]
            key = ((tri,), 0.0, 0)
            cached = eng._sg.get(key)
            if cached is not None:
                eng.stats["sg_hits"] += 1
                return cached
            eng.stats["sg_misses"] += 1
            c = self.node_cost(nd, *tri)
            cname = eng.resource_for_class(nd.op_class)
            res = subgraph_tail({cname: self._cycles(
                eng.ckey_for_class(nd.op_class), tri[0], nd)},
                c.offchip_bytes, c.local_bytes, 0.0, c.energy_pj, 0,
                eng._compute, eng._simd, eng.hda)
            eng._sg[key] = res
            return res

        node_objs = [nodes[n] for n in sg]

        nodeset = set(sg)
        internal: set = set()
        for nd in node_objs:
            for t in nd.outputs:
                cs = consumers.get(t)
                if cs and all(c in nodeset for c in cs):
                    internal.add(t)

        triples = []
        resident: set = set()
        for nd in node_objs:
            rmask = tuple((t in resident or t in internal) for t in nd.inputs)
            imask = tuple((t in internal) for t in nd.outputs)
            triples.append((sid_of[nd.name], rmask, imask))
            resident.update(nd.outputs)

        link = 0.0
        for t in internal:
            pc = eng.core_for_class(nodes[g.producer[t]].op_class).name
            for c in consumers.get(t, []):
                if eng.core_for_class(nodes[c].op_class).name != pc:
                    link += tb[t]
        internal_bytes = sum(tb[t] for t in internal)

        key = (tuple(triples), link, internal_bytes)
        cached = eng._sg.get(key)
        if cached is not None:
            eng.stats["sg_hits"] += 1
            return cached
        eng.stats["sg_misses"] += 1

        per_core: dict[str, float] = {}
        offchip = local = energy = 0.0
        for nd, tri in zip(node_objs, triples, strict=True):
            c = self.node_cost(nd, *tri)
            cls = nd.op_class
            cname = eng.resource_for_class(cls)
            cyc = self._cycles(eng.ckey_for_class(cls), tri[0], nd)
            per_core[cname] = per_core.get(cname, 0.0) + cyc
            offchip += c.offchip_bytes
            local += c.local_bytes
            energy += c.energy_pj
        res = subgraph_tail(per_core, offchip, local, link, energy,
                            internal_bytes, eng._compute, eng._simd, eng.hda)
        eng._sg[key] = res
        return res

    def subgraph_cost_many(self, groups) -> list:
        """Batched :meth:`subgraph_cost` — bit-for-bit equal to
        ``[self.subgraph_cost(sg) for sg in groups]``.  One pass over the
        SoA signature tables probes the subgraph cache for every singleton
        group up front (the overwhelmingly common case in a population
        batch); only the remaining groups go through the scalar kernel.
        Because keys are content signatures, duplicates across the batch —
        and across phenotypes in the batched population evaluator — are
        computed exactly once."""
        eng = self.engine
        sg_cache = eng._sg
        zmask = self.sigs.zmask
        hits = 0
        out: list = [None] * len(groups)
        misses: list = []
        for i, sg in enumerate(groups):
            if len(sg) == 1:
                cached = sg_cache.get(((zmask[sg[0]],), 0.0, 0))
                if cached is not None:
                    hits += 1
                    out[i] = cached
                    continue
            misses.append(i)
        eng.stats["sg_hits"] += hits
        for i in misses:
            out[i] = self.subgraph_cost(groups[i])
        return out


def dma_group_cost(engine: EvalEngine, op: str, size: int,
                   ebytes: int) -> NodeCost:
    """Fused-group cost of one spliced DMA transfer node (``op`` is
    ``"offload"`` or ``"fetch"``) for a payload of ``size`` elements ×
    ``ebytes`` bytes/element — bit-identical to ``_sign_node`` +
    ``BoundEngine.subgraph_cost`` on the node's singleton group (same
    signature tuple, same interned ids, same shared ``_CYC`` /
    ``_NODE_COSTS`` / ``_sg`` entries), without materializing the spliced
    graph.  This is how the batched evaluator's OFFLOAD lowering
    (``repro.core.batch``) keeps the engine caches coherent with the scalar
    oracle: an ``apply_offload`` rewrite evaluated later hits these exact
    entries and signs nothing fresh."""
    payload = size * ebytes         # == TensorSpec.bytes of the activation
    if op == "offload":             # activation in, 1-byte marker out
        in_b, out_b, eb, inb, outb = (payload,), (1,), 1, payload, 1
    else:                           # marker in, re-materialized tensor out
        in_b, out_b, eb, inb, outb = (1,), (payload,), ebytes, 1, payload
    dims = {"N": size, "E": ebytes}
    sig = (op, tuple(sorted(dims.items())), 0, in_b, (0,), out_b, eb)
    sid = _sig_id(sig)
    tri = (sid, (False,), (False,))
    key = ((tri,), 0.0, 0)
    cached = engine._sg.get(key)
    if cached is not None:
        engine.stats["sg_hits"] += 1
        return cached
    engine.stats["sg_misses"] += 1
    ck = engine._ck_dma
    cyc = _CYC.get((ck, sid))
    if cyc is None:
        nd = Node(f"{op}:<soa>", op, "dma", dims, [], [], 0, None)
        cyc = compute_cycles(nd, engine.core_for_class("dma"), 1, engine.hda)
        _CYC[(ck, sid)] = cyc
    nkey = (ck, sid, (False,), (False,))
    c = _NODE_COSTS.get(nkey)
    if c is not None:
        engine.stats["node_hits"] += 1
    else:
        engine.stats["node_misses"] += 1
        c = dma_node_cost(cyc, inb, outb, engine.hda)
        _NODE_COSTS[nkey] = c
    res = subgraph_tail({"dma": cyc}, c.offchip_bytes, c.local_bytes, 0.0,
                        c.energy_pj, 0, engine._compute, engine._simd,
                        engine.hda)
    engine._sg[key] = res
    return res


# ---------------------------------------------------------------------------
# engine registry
# ---------------------------------------------------------------------------

_ENGINES: OrderedDict = OrderedDict()
_ENGINE_CAP = 512      # DSE sweeps create one engine per architecture


def get_engine(hda: HDASpec, tensor_parallel: bool = True) -> EvalEngine:
    """Process-wide engine registry keyed by ``(HDASpec, tensor_parallel)``
    (HDASpec is a frozen dataclass, so value-identical specs share an
    engine).  Bounded LRU so unbounded sweeps cannot leak memory."""
    key = (hda, tensor_parallel)
    e = _ENGINES.get(key)
    if e is None:
        while len(_ENGINES) >= _ENGINE_CAP:
            _ENGINES.popitem(last=False)
        e = _ENGINES[key] = EvalEngine(hda, tensor_parallel)
    else:
        _ENGINES.move_to_end(key)
    return e


def clear_engines() -> None:
    """Drop every registered engine (testing / benchmarking cold paths)."""
    _ENGINES.clear()
