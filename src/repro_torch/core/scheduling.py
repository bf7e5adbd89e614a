"""Multi-core list scheduler over a fused-subgraph partition.

Given a WorkloadGraph, an HDA and a partition of the graph into fused
subgraphs (default: one node per subgraph = layer-by-layer), produce the
latency / energy / traffic / peak-memory estimate for one iteration.

Pipeline parallelism across heterogeneous engines emerges naturally: each
subgraph occupies its dominant engine (MAC array vs. vector core), so
conv/GEMM work and element-wise work overlap — the deployment style the
paper uses for both the Edge TPU and FuseMax studies (§IV).

The port's own copy of ``repro.core.scheduling`` (numpy and plain Python):
names, signatures and numeric code are the reference's, held bit for
bit against it by ``tests/test_torch_core.py``.
"""

from __future__ import annotations

import heapq
from collections import OrderedDict, defaultdict, deque
from dataclasses import dataclass, field, replace

from .accelerators import HDASpec
from .cost_model import CostModel
from .engine import get_engine
from .graph import GraphError, WorkloadGraph
from .memory import (MEM_CATEGORIES, build_lifetime_plan, lifetime_profile,
                     lifetime_profile_batch, schedule_priorities)


@dataclass
class ScheduleResult:
    latency: float                 # cycles (makespan)
    energy: float                  # pJ, incl. leakage
    offchip_bytes: float
    peak_mem: float                # peak live tensor footprint (bytes)
    activation_bytes: float        # Σ stored fwd→bwd activations (paper metric)
    per_core_busy: dict = field(default_factory=dict)
    n_subgraphs: int = 0
    total_macs: int = 0
    hda_name: str = ""
    # unified memory model (repro.core.memory — see docs/memory.md)
    mem_breakdown: dict = field(default_factory=dict)  # category -> bytes @peak
    act_peak: float = 0.0          # peak live activation-category bytes
    spill_bytes: float = 0.0       # DMA offload traffic per iteration (bytes)
    spill_cycles: float = 0.0      # busy cycles on the 'dma' resource

    @property
    def mac_utilization(self) -> float:
        return self.total_macs / max(self.latency, 1.0)

    @property
    def ckpt_bytes(self) -> float:
        """Checkpoint payload resident on this chip: the weights +
        optimizer-state categories of the memory breakdown.  Both are
        statically live for the whole iteration, so the at-peak breakdown
        always carries their full footprint (``repro.core.resilience``)."""
        return (self.mem_breakdown.get("weights", 0.0)
                + self.mem_breakdown.get("optimizer_state", 0.0))

    def as_row(self) -> dict:
        row = dict(latency=self.latency, energy=self.energy,
                   offchip_bytes=self.offchip_bytes, peak_mem=self.peak_mem,
                   activation_bytes=self.activation_bytes,
                   n_subgraphs=self.n_subgraphs, hda=self.hda_name,
                   spill_bytes=self.spill_bytes,
                   spill_cycles=self.spill_cycles)
        for cat in MEM_CATEGORIES:
            row[f"mem_{cat}"] = self.mem_breakdown.get(cat, 0)
        return row


def quotient_dag(graph: WorkloadGraph, partition: list) -> tuple[dict, dict]:
    """Map node→subgraph-index and subgraph adjacency.  Raises on a cyclic
    quotient (non-convex partition)."""
    sg_of: dict[str, int] = {}
    for i, sg in enumerate(partition):
        for n in sg:
            if n in sg_of:
                raise GraphError(f"node {n} in two subgraphs")
            sg_of[n] = i
    if len(sg_of) != len(graph.nodes):
        missing = set(graph.nodes) - set(sg_of)
        raise GraphError(f"partition does not cover {sorted(missing)[:5]}")

    succ: dict[int, set] = defaultdict(set)
    pred_count: dict[int, int] = defaultdict(int)
    succs_of = graph.adjacency()[1]
    for n in graph.nodes:
        for s in succs_of[n]:
            a, b = sg_of[n], sg_of[s]
            if a != b and b not in succ[a]:
                succ[a].add(b)
    for bs in succ.values():
        for b in bs:
            pred_count[b] += 1
    # acyclicity check
    q = deque(i for i in range(len(partition)) if pred_count[i] == 0)
    seen = 0
    pc = dict(pred_count)
    while q:
        x = q.popleft()
        seen += 1
        for y in succ.get(x, ()):
            pc[y] -= 1
            if pc[y] == 0:
                q.append(y)
    if seen != len(partition):
        raise GraphError("partition quotient graph has a cycle "
                         "(non-convex fused subgraph)")
    return sg_of, succ


class _Plan:
    """HDA-independent schedule structure for one (graph, partition) pair:
    quotient adjacency, priorities and the lifetime arrays of the unified
    memory model (``repro.core.memory.LifetimePlan``).  Cached by
    ``(fingerprint, partition)``, so a DSE sweep evaluating the same
    workload on hundreds of architectures builds it exactly once."""

    __slots__ = ("n", "succ", "indeg", "prio", "act_bytes", "total_macs",
                 "mem")

    def __init__(self, graph: WorkloadGraph, partition: list,
                 quotient=None, sigs=None):
        if quotient is None:
            _, qsucc = quotient_dag(graph, partition)
            succ = [tuple(qsucc.get(i, ())) for i in range(len(partition))]
        else:
            succ = [tuple(s) for s in quotient]
        n = len(partition)
        indeg = [0] * n
        for bs in succ:
            for b in bs:
                indeg[b] += 1
        topo_idx = {nm: i for i, nm in enumerate(graph.topo_order())}
        self.n = n
        self.succ = succ
        self.indeg = indeg
        if sigs is not None:
            self.total_macs = sigs.macs_total
        else:
            self.total_macs = sum(nd.macs for nd in graph.nodes.values())
        self.act_bytes = graph.activation_bytes()
        # lifetime arrays (producing subgraph, bytes, category, consumers)
        # come from the shared memory model — single source of truth
        self.mem = build_lifetime_plan(graph, partition, sigs)
        self.prio = schedule_priorities(
            graph, partition, topo_idx,
            has_fetch=bool(self.mem.fetch_idx.size))


class MiniPlan:
    """Duck-typed stand-in for :class:`_Plan` carrying exactly what
    ``_list_schedule`` consumes (``n`` / ``succ`` / ``prio`` / ``indeg``).
    The batched phenotype evaluator (``repro.core.batch``) builds these
    directly from its integer array view instead of materializing a graph
    and a full plan per phenotype."""

    __slots__ = ("n", "succ", "prio", "indeg")

    def __init__(self, n, succ, prio, indeg):
        self.n = n
        self.succ = succ
        self.prio = prio
        self.indeg = indeg


_PLANS: OrderedDict = OrderedDict()
_PLAN_CAP = 128
_PLAN_STATS = {"hits": 0, "misses": 0}


def plan_cache_stats() -> dict:
    """Hit/miss counters of the (fingerprint, partition) plan cache — the
    fusion-search benchmarks report these next to the engine's cache stats."""
    return dict(_PLAN_STATS)


def clear_plan_cache(cap: int | None = None) -> None:
    """Drop every cached plan, reset the counters and optionally resize the
    cache — ``benchmarks/bench_fusion_search.py`` clears it so the search
    benchmark times cold plan builds instead of leftovers from earlier
    benchmark entries in the same process."""
    global _PLAN_CAP
    _PLANS.clear()
    _PLAN_STATS["hits"] = _PLAN_STATS["misses"] = 0
    if cap is not None:
        _PLAN_CAP = cap


def _plan_for(graph: WorkloadGraph, partition: list, memo_key: tuple,
              quotient=None, sigs=None) -> _Plan:
    plan = _PLANS.get(memo_key)
    if plan is None:
        _PLAN_STATS["misses"] += 1
        plan = _Plan(graph, partition, quotient, sigs)
        _PLANS[memo_key] = plan
        if len(_PLANS) > _PLAN_CAP:
            _PLANS.popitem(last=False)
    else:
        _PLAN_STATS["hits"] += 1
        _PLANS.move_to_end(memo_key)
    return plan


def schedule(graph: WorkloadGraph, hda: HDASpec, partition: list | None = None,
             tensor_parallel: bool = True, engine=None,
             use_engine: bool = True, quotient=None) -> ScheduleResult:
    """Evaluate one iteration of ``graph`` on ``hda`` under ``partition``.

    By default costs come from the signature-memoizing evaluation engine
    (numerically identical to ``CostModel`` — see tests/test_engine_parity);
    ``use_engine=False`` forces the direct reference path.  ``quotient``
    optionally passes a pre-validated quotient adjacency (list of successor
    sets, e.g. from ``repair_partition``) to skip rebuilding it."""
    if partition is None:
        partition = [(n,) for n in graph.topo_order()]
    partition = [tuple(sg) for sg in partition]

    if use_engine:
        eng = engine if engine is not None else get_engine(hda,
                                                           tensor_parallel)
        bound = eng.bind(graph)
        memo_key = (bound.fingerprint(), tuple(partition))
        hit = eng.sched_get(memo_key)
        if hit is not None:
            return replace(hit, per_core_busy=dict(hit.per_core_busy),
                           mem_breakdown=dict(hit.mem_breakdown))
        plan = _plan_for(graph, partition, memo_key, quotient, bound.sigs)
        costs = [bound.subgraph_cost(sg) for sg in partition]
        res = _assemble_fast(hda, plan, costs)
        eng.sched_put(memo_key, res)
        # sanitizer mode: shadow-verify every cache miss (the warm cache-hit
        # path above is never instrumented — see docs/verify.md)
        from .verify import sanitize_enabled, verify_result
        if sanitize_enabled():
            verify_result(graph, hda, partition, res, engine=eng,
                          tensor_parallel=tensor_parallel, strict=True)
        return replace(res, per_core_busy=dict(res.per_core_busy),
                       mem_breakdown=dict(res.mem_breakdown))

    cm = CostModel(graph, hda, tensor_parallel=tensor_parallel)
    sg_of, succ = quotient_dag(graph, partition)
    costs = [cm.subgraph_cost(list(sg)) for sg in partition]
    return _assemble(graph, hda, partition, succ, costs)


def _schedule_batch_worker(chunk: list) -> list:
    """Fork-pool worker: score one chunk of jobs serially.  Engines are
    re-created in the child (``get_engine``) — caches populated there never
    propagate back, only the (picklable) ``ScheduleResult`` values do."""
    return [schedule(g, hda, part, engine=None, quotient=q)
            for (g, hda, part, q) in chunk]


def schedule_batch(jobs: list, engine=None, tensor_parallel: bool = True,
                   processes: int | None = None) -> list:
    """Score a batch of schedule jobs — bit-for-bit equal to the scalar loop
    ``[schedule(g, hda, part, quotient=q) for (g, hda, part, q) in jobs]``.

    ``jobs``: sequence of ``(graph, hda, partition)`` or
    ``(graph, hda, partition, quotient)``.  Compared to the scalar loop the
    batch path (docs/engine.md):

    * dedups identical ``(engine, fingerprint, partition)`` jobs inside the
      batch — each unique job is costed once;
    * shares the HDA-independent ``_Plan`` across architectures evaluating
      the same (graph, partition) pair;
    * computes every interval-peak memory profile of a shared plan in one
      vectorized ``lifetime_profile_batch`` pass;
    * with ``processes=N`` (>1) forks a worker pool and scores independent
      jobs in parallel (results identical; child-process caches are
      discarded).  Only worthwhile for many independent architectures on a
      multi-core host.

    Under ``REPRO_SANITIZE`` the scalar oracle runs instead, so every cache
    miss keeps its shadow-verification (C-rules)."""
    jobs = [(j[0], j[1], [tuple(sg) for sg in j[2]],
             j[3] if len(j) > 3 else None) for j in jobs]

    from .verify import sanitize_enabled
    if sanitize_enabled():
        return [schedule(g, hda, part, tensor_parallel, engine, quotient=q)
                for (g, hda, part, q) in jobs]

    if processes and processes > 1 and len(jobs) > 1:
        import multiprocessing as mp
        try:
            ctx = mp.get_context("fork")
        except ValueError:          # platform without fork: stay serial
            ctx = None
        if ctx is not None:
            nw = min(processes, len(jobs))
            chunks = [jobs[i::nw] for i in range(nw)]
            with ctx.Pool(nw) as pool:
                outs = pool.map(_schedule_batch_worker, chunks)
            results = [None] * len(jobs)
            for w, out in enumerate(outs):
                for k, res in enumerate(out):
                    results[w + k * nw] = res
            return results

    n = len(jobs)
    results: list = [None] * n
    first_of: dict[tuple, int] = {}     # dedup key -> first job index
    pending: list = []                  # (job idx, eng, bound, memo_key, part, q)
    for i, (g, hda, part, q) in enumerate(jobs):
        eng = engine if engine is not None else get_engine(hda,
                                                           tensor_parallel)
        bound = eng.bind(g)
        memo_key = (bound.fingerprint(), tuple(part))
        hit = eng.sched_get(memo_key)
        if hit is not None:
            results[i] = hit
            continue
        dkey = (id(eng), memo_key)
        j = first_of.get(dkey)
        if j is not None:
            results[i] = ("dup", j)
            continue
        first_of[dkey] = i
        pending.append((i, eng, bound, memo_key, part, q))

    # cost + list-schedule phase; profiles are deferred and grouped per plan
    staged: list = []                   # (idx, eng, hda, memo, plan, costs,
    #                                      makespan, busy, perm)
    by_plan: dict[int, list] = {}       # id(plan) -> staged rows
    for (i, eng, bound, memo_key, part, q) in pending:
        g, hda = jobs[i][0], jobs[i][1]
        plan = _plan_for(g, part, memo_key, q, bound.sigs)
        costs = [bound.subgraph_cost(sg) for sg in part]
        makespan, busy, finish = _list_schedule(plan, costs)
        row = [i, eng, hda, memo_key, plan, costs, makespan, busy,
               _finish_perm(finish)]
        staged.append(row)
        by_plan.setdefault(id(plan), []).append(row)

    for rows in by_plan.values():
        profs = lifetime_profile_batch(rows[0][4].mem,
                                       [r[8] for r in rows])
        for row, prof in zip(rows, profs, strict=True):
            i, eng, hda, memo_key, plan, costs, makespan, busy, _ = row
            res = _assemble_result(hda, plan, costs, makespan, busy, prof)
            eng.sched_put(memo_key, res)
            results[i] = res

    out = []
    for r in results:
        if type(r) is tuple:            # ("dup", first-index) marker
            r = results[r[1]]
        out.append(replace(r, per_core_busy=dict(r.per_core_busy),
                           mem_breakdown=dict(r.mem_breakdown)))
    return out


def _list_schedule(plan, costs: list) -> tuple:
    """Greedy priority list scheduling over the plan's quotient DAG.  The
    ``plan`` only needs ``n`` / ``succ`` / ``prio`` / ``indeg`` — the batched
    phenotype evaluator (``repro.core.batch``) feeds a lightweight stand-in
    instead of a full ``_Plan``.  Returns ``(makespan, busy, finish)``."""
    n = plan.n
    succ = plan.succ
    prio = plan.prio
    remaining = list(plan.indeg)
    core_free: dict[str, float] = {}
    busy: dict[str, float] = {}
    finish = [0.0] * n
    ready_time = [0.0] * n
    makespan = 0.0

    heap = [(prio[i], i) for i in range(n) if remaining[i] == 0]
    heapq.heapify(heap)
    scheduled = 0
    while heap:
        _, i = heapq.heappop(heap)
        c = costs[i]
        core = c.core
        start = ready_time[i]
        cf = core_free.get(core, 0.0)
        if cf > start:
            start = cf
        end = start + c.cycles
        finish[i] = end
        core_free[core] = end
        busy[core] = busy.get(core, 0.0) + c.cycles
        if end > makespan:
            makespan = end
        scheduled += 1
        for j in succ[i]:
            if end > ready_time[j]:
                ready_time[j] = end
            remaining[j] -= 1
            if remaining[j] == 0:
                heapq.heappush(heap, (prio[j], j))
    if scheduled != n:
        raise GraphError("scheduler deadlock (cycle?)")
    return makespan, busy, finish


def _finish_perm(finish: list):
    """``perm[subgraph] = step`` from the finish times (stable on ties)."""
    import numpy as np
    n = len(finish)
    order = sorted(range(n), key=finish.__getitem__)
    perm = np.empty(n, dtype=np.int64)
    perm[np.asarray(order, dtype=np.int64)] = np.arange(n, dtype=np.int64)
    return perm


def _assemble_result(hda: HDASpec, plan: _Plan, costs: list, makespan: float,
                     busy: dict, prof) -> ScheduleResult:
    energy = sum(c.energy_pj for c in costs) + makespan * hda.leak_per_cycle()
    return ScheduleResult(
        latency=makespan,
        energy=energy,
        offchip_bytes=sum(c.offchip_bytes for c in costs),
        peak_mem=prof.peak,
        activation_bytes=plan.act_bytes,
        per_core_busy=busy,
        n_subgraphs=plan.n,
        total_macs=plan.total_macs,
        hda_name=hda.name,
        mem_breakdown=prof.breakdown,
        act_peak=prof.act_peak,
        spill_bytes=plan.mem.spill_bytes,
        spill_cycles=busy.get("dma", 0.0),
    )


def _assemble_fast(hda: HDASpec, plan: _Plan, costs: list) -> ScheduleResult:
    """Array-indexed twin of ``_assemble`` operating on a cached ``_Plan``
    (bit-for-bit identical results — covered by the parity tests).  Memory
    liveness goes through the unified lifetime model (topo-step granularity,
    integer byte arithmetic — exact, so bit-for-bit equal to the reference
    path, which calls the same kernel)."""
    makespan, busy, finish = _list_schedule(plan, costs)
    prof = lifetime_profile(plan.mem, _finish_perm(finish))
    return _assemble_result(hda, plan, costs, makespan, busy, prof)


def _assemble(graph: WorkloadGraph, hda: HDASpec, partition: list,
              succ: dict, costs: list) -> ScheduleResult:
    # ---- list scheduling over engines ------------------------------------
    preds: dict[int, set] = defaultdict(set)
    for a, bs in succ.items():
        for b in bs:
            preds[b].add(a)
    remaining = {i: len(preds[i]) for i in range(len(partition))}
    # priority = topo index of first node (stable, dependency-friendly);
    # just-in-time DMA fetches inherit their consumers' priority
    prio = dict(enumerate(schedule_priorities(graph, partition)))

    core_free: dict[str, float] = defaultdict(float)
    finish: dict[int, float] = {}
    ready_time: dict[int, float] = defaultdict(float)
    busy: dict[str, float] = defaultdict(float)
    makespan = 0.0

    heap = [(prio[i], i) for i in range(len(partition)) if remaining[i] == 0]
    heapq.heapify(heap)
    scheduled = 0
    while heap:
        _, i = heapq.heappop(heap)
        c = costs[i]
        start = max(ready_time[i], core_free[c.core])
        end = start + c.cycles
        finish[i] = end
        core_free[c.core] = end
        busy[c.core] += c.cycles
        makespan = max(makespan, end)
        scheduled += 1
        for j in succ.get(i, ()):
            ready_time[j] = max(ready_time[j], end)
            remaining[j] -= 1
            if remaining[j] == 0:
                heapq.heappush(heap, (prio[j], j))
    if scheduled != len(partition):
        raise GraphError("scheduler deadlock (cycle?)")

    # ---- memory liveness (topo-step granularity) --------------------------
    # through the unified lifetime model — same kernel as the engine path
    import numpy as np
    n = len(partition)
    order = sorted(range(n), key=finish.get)
    perm = np.empty(n, dtype=np.int64)
    perm[np.asarray(order, dtype=np.int64)] = np.arange(n, dtype=np.int64)
    mem = build_lifetime_plan(graph, partition)
    prof = lifetime_profile(mem, perm)

    energy = sum(c.energy_pj for c in costs) + makespan * hda.leak_per_cycle()
    return ScheduleResult(
        latency=makespan,
        energy=energy,
        offchip_bytes=sum(c.offchip_bytes for c in costs),
        peak_mem=prof.peak,
        activation_bytes=graph.activation_bytes(),
        per_core_busy=dict(busy),
        n_subgraphs=len(partition),
        total_macs=sum(graph.nodes[n].macs for n in graph.nodes),
        hda_name=hda.name,
        mem_breakdown=prof.breakdown,
        act_peak=prof.act_peak,
        spill_bytes=mem.spill_bytes,
        spill_cycles=busy.get("dma", 0.0),
    )
