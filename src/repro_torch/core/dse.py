"""Hardware design-space exploration (paper §IV, Figs. 1/8/9).

Sweeps a Table-II/III-style grid, evaluates each HDA on the given workload
graphs through the scheduler, and extracts Pareto fronts.

The port's own copy of ``repro.core.dse`` (numpy and plain Python):
names, signatures and numeric code are the reference's, held bit for
bit against it by ``tests/test_torch_parallel.py``, ``test_torch_resilience.py``
and ``test_torch_serving.py``.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field

from .accelerators import HDASpec, grid
from .engine import get_engine
from .fusion_search import FusionSearchConfig, fusion_partition
from .graph import WorkloadGraph
from .memory import local_capacity
from .scheduling import schedule, schedule_batch
from .verify import verify_result


@dataclass
class DSEPoint:
    config: dict
    hda: str
    results: dict          # workload name -> ScheduleResult
    findings: dict = field(default_factory=dict)   # workload -> verifier report

    def row(self) -> dict:
        out = dict(self.config)
        for wname, r in self.results.items():
            out[f"{wname}_latency"] = r.latency
            out[f"{wname}_energy"] = r.energy
            out[f"{wname}_peak_mem"] = r.peak_mem
            # memory-model breakdown (repro.core.memory): weights /
            # gradients / optimizer-state / activations / ... at the peak
            for cat, b in r.mem_breakdown.items():
                out[f"{wname}_mem_{cat}"] = b
            out[f"{wname}_spill_bytes"] = r.spill_bytes
        return out


def _partition_for(g: WorkloadGraph, hda: HDASpec, wname: str, fusion: str,
                   cache: dict, engine, fusion_cfg=None):
    """(partition, quotient) of ``g`` for one sweep point through the
    shared dispatcher (``fusion_search.fusion_partition``), memoized on
    exactly the HDA facts the mode depends on: ``manual`` is
    HDA-independent, ``greedy`` sees the architecture only through the
    SRAM ceiling (and the shared tiling tables), ``solver`` / ``search``
    depend on the full spec."""
    if fusion in (None, "none"):
        return None, None
    if fusion == "manual":
        key = (wname,)
    elif fusion == "greedy":
        key = (wname, local_capacity(hda))
    else:
        key = (wname, hda)
    hit = cache.get(key)
    if hit is None:
        hit = fusion_partition(
            g, hda, fusion, fusion_cfg, engine,
            search_default=FusionSearchConfig(pop_size=12, generations=6))
        cache[key] = hit
    return hit


def sweep(make_hda, space: dict, workloads: dict, sample: int | None = None,
          seed: int = 0, fusion: str = "manual",
          fusion_cfg=None, use_batch: bool = True) -> list[DSEPoint]:
    """Evaluate every (or ``sample`` random) config in ``space`` on each
    workload graph.  ``workloads``: name → WorkloadGraph.  ``fusion``
    selects the partition per point: ``none`` / ``manual`` / ``greedy``
    (SRAM-feasible growth) / ``solver`` (exact-cover IP) / ``search``
    (boundary-genome NSGA-II, budget via ``fusion_cfg`` — see
    ``repro.core.fusion_search``).  ``use_batch`` scores the whole grid in
    one :func:`~repro.core.scheduling.schedule_batch` pass (plan sharing
    across architectures, vectorized memory profiles — docs/engine.md);
    results are bit-for-bit equal to the scalar loop."""
    configs = grid(space)
    if sample is not None and sample < len(configs):
        rng = random.Random(seed)
        configs = rng.sample(configs, sample)
    parts: dict = {}
    points: list[DSEPoint] = []
    if use_batch:
        jobs: list = []
        metas: list = []               # (cfg, hda, workload -> job index)
        for cfg in configs:
            hda = make_hda(**cfg)
            engine = get_engine(hda)
            idx = {}
            for wname, g in workloads.items():
                part, quotient = _partition_for(g, hda, wname, fusion,
                                                parts, engine, fusion_cfg)
                if part is None:       # the scalar default: one node per step
                    part = [(n,) for n in g.topo_order()]
                idx[wname] = len(jobs)
                jobs.append((g, hda, part, quotient))
            metas.append((cfg, hda, idx))
        scored = schedule_batch(jobs)
        points = [DSEPoint(cfg, hda.name,
                           {w: scored[i] for w, i in idx.items()})
                  for (cfg, hda, idx) in metas]
    else:
        for cfg in configs:
            hda = make_hda(**cfg)
            # one engine per architecture; graph-side signature tables are
            # shared across every config in the sweep (cached on the
            # graphs), so only architecture-dependent cost arithmetic is
            # re-evaluated per point
            engine = get_engine(hda)
            results = {}
            for wname, g in workloads.items():
                part, quotient = _partition_for(g, hda, wname, fusion,
                                                parts, engine, fusion_cfg)
                results[wname] = schedule(g, hda, part, engine=engine,
                                          quotient=quotient)
            points.append(DSEPoint(cfg, hda.name, results))
    # certify the sweep winner per workload (min latency): one verifier
    # sweep per workload, not per config — the M/S/C findings land on the
    # winning DSEPoint (empty list = clean)
    for wname, g in workloads.items():
        if not points:
            break
        best = min(points, key=lambda p, w=wname: p.results[w].latency)
        hda = make_hda(**best.config)
        engine = get_engine(hda)
        part, _ = _partition_for(g, hda, wname, fusion, parts, engine,
                                 fusion_cfg)
        best.findings[wname] = verify_result(
            g, hda, part or [(n,) for n in g.topo_order()],
            best.results[wname], engine=engine)
    return points


@dataclass
class ParallelPoint:
    """One (chip count × strategy) cell of a parallel-training sweep."""

    n_chips: int
    strategy: object                # ParallelStrategy
    results: dict                   # workload name -> ParallelResult

    def row(self) -> dict:
        out = dict(chips=self.n_chips, strategy=self.strategy.label,
                   dp=self.strategy.data, tp=self.strategy.tensor,
                   pp=self.strategy.pipeline,
                   microbatches=self.strategy.microbatches)
        for wname, r in self.results.items():
            out[f"{wname}_latency"] = r.latency
            out[f"{wname}_energy"] = r.energy
            out[f"{wname}_peak_mem"] = r.peak_mem
            out[f"{wname}_throughput"] = r.throughput
            out[f"{wname}_wire_bytes"] = r.wire_bytes
            out[f"{wname}_feasible"] = r.feasible
        return out


def sweep_parallel(workloads: dict, make_cluster, chip_counts,
                   strategies=None, fusion: str = "manual",
                   microbatches: int | None = None) -> list:
    """Parallel-training scale sweep: evaluate every parallelism strategy of
    every chip count on each training workload.

    ``workloads``: name → TrainingGraph (built at the per-chip local batch);
    ``make_cluster(n)``: ClusterSpec factory (e.g. ``edge_cluster`` /
    ``datacenter_cluster``); ``strategies``: optional explicit list of
    ParallelStrategy (must match the chip count) — default: every
    factorization from ``strategy_space``.  One engine per cluster chip is
    shared across all strategies, so only each strategy's rewrite delta is
    re-costed (the comm nodes + rescaled layers)."""
    from .parallel import evaluate_parallel, strategy_space

    points: list[ParallelPoint] = []
    for n in chip_counts:
        cluster = make_cluster(n)
        engine = get_engine(cluster.chip)
        strats = strategies if strategies is not None else \
            strategy_space(n, microbatches=microbatches)
        for strat in strats:
            if strat.chips != n:
                continue
            results = {}
            try:
                for wname, tg in workloads.items():
                    results[wname] = evaluate_parallel(tg, cluster, strat,
                                                       fusion=fusion,
                                                       engine=engine)
            except ValueError:
                # strategy inapplicable to this workload (e.g. pipeline
                # degree exceeds its forward-node count): skip the cell
                # instead of aborting the whole sweep
                continue
            points.append(ParallelPoint(n, strat, results))
    return points


@dataclass
class ResiliencePoint:
    """One (chip count × strategy) cell of a goodput (failure-aware) sweep."""

    n_chips: int
    strategy: object                # ParallelStrategy
    results: dict                   # workload name -> GoodputResult

    def row(self) -> dict:
        out = dict(chips=self.n_chips, strategy=self.strategy.label,
                   dp=self.strategy.data, tp=self.strategy.tensor,
                   pp=self.strategy.pipeline,
                   microbatches=self.strategy.microbatches)
        for wname, r in self.results.items():
            for k, v in r.as_row().items():
                out[f"{wname}_{k}"] = v
        return out


def sweep_resilience(workloads: dict, make_cluster, chip_counts,
                     fault=None, strategies=None, fusion: str = "manual",
                     microbatches: int | None = None) -> list:
    """Failure-aware scale sweep: :func:`sweep_parallel` composed with the
    fault model — every cell's ideal-machine estimate is deflated into
    goodput via checkpoint-interval selection and expected replay
    (``repro.core.resilience``, docs/resilience.md).

    ``fault`` overrides the cluster-attached
    :class:`~repro.core.accelerators.FaultModel` (None = whatever
    ``make_cluster`` attaches).  The raw-vs-goodput spread across
    ``chip_counts`` is the headline: edge single-chip cells are
    MTBF-insensitive while datacenter-scale cells lose a growing fraction
    to checkpoints and rework."""
    from .parallel import evaluate_parallel, strategy_space
    from .resilience import evaluate_goodput

    points: list[ResiliencePoint] = []
    for n in chip_counts:
        cluster = make_cluster(n)
        engine = get_engine(cluster.chip)
        strats = strategies if strategies is not None else \
            strategy_space(n, microbatches=microbatches)
        for strat in strats:
            if strat.chips != n:
                continue
            results = {}
            try:
                for wname, tg in workloads.items():
                    r = evaluate_parallel(tg, cluster, strat, fusion=fusion,
                                          engine=engine)
                    results[wname] = evaluate_goodput(
                        tg, cluster, strat, fault=fault, engine=engine,
                        result=r)
            except ValueError:
                continue            # strategy inapplicable to this workload
            points.append(ResiliencePoint(n, strat, results))
    return points


@dataclass
class ServePoint:
    """One (chip count × slots × KV policy) cell of an inference-serving
    sweep (``repro.core.serving``, docs/serving.md)."""

    n_chips: int
    slots: int
    policy: str
    result: object                  # ServeResult

    def row(self) -> dict:
        return self.result.as_row()


def sweep_serve(make_cluster, chip_counts, slots_list=(4, 16, 64),
                policies=None, mix=None, model=None,
                dtype: str = "bfloat16") -> list:
    """Inference-serving scale sweep: evaluate every KV policy at every
    (chip count × concurrent-slot) cell of the continuous-batching model.

    ``make_cluster(n)``: ClusterSpec factory (``edge_cluster`` /
    ``datacenter_cluster``); ``slots_list``: concurrent decoding sequences
    per cell; ``policies``: KV residency policies (default: KEEP /
    RECOMPUTE / OFFLOAD — :class:`~repro.core.memory.ActivationPolicy`);
    ``mix`` / ``model``: request mix and served-model overrides
    (``serving.DEFAULT_MIX`` / ``serving.GPT2_SMALL``).  One engine per
    cluster is shared across every cell, so the sweep is dominated by
    warm-cache evaluations; cells whose chip count cannot shard the model
    (``ValueError``) are skipped like inapplicable parallel strategies.
    Typical front extraction (requests/sec × tail latency × per-chip
    memory, all minimized)::

        front = pareto_front(points, [lambda p: -p.result.rps,
                                      lambda p: p.result.p99_ms,
                                      lambda p: p.result.peak_mem])
    """
    from .memory import ActivationPolicy
    from .serving import evaluate_serve

    if policies is None:
        policies = (ActivationPolicy.KEEP, ActivationPolicy.RECOMPUTE,
                    ActivationPolicy.OFFLOAD)
    points: list[ServePoint] = []
    for n in chip_counts:
        cluster = make_cluster(n)
        engine = get_engine(cluster.chip)
        for slots in slots_list:
            for pol in policies:
                try:
                    r = evaluate_serve(cluster, mix=mix, slots=slots,
                                       policy=pol, model=model, dtype=dtype,
                                       engine=engine)
                except ValueError:
                    continue        # cell inapplicable (e.g. tp ∤ heads)
                points.append(ServePoint(n, slots, pol.name, r))
    return points


def pareto_front(points: list, metrics) -> list:
    """Non-dominated subset w.r.t. ``metrics``: callables point→float
    (minimize)."""
    vals = [[m(p) for m in metrics] for p in points]
    front = []
    for i, vi in enumerate(vals):
        dominated = False
        for j, vj in enumerate(vals):
            if i != j and all(a <= b for a, b in zip(vj, vi, strict=True)) and \
                    any(a < b for a, b in zip(vj, vi, strict=True)):
                dominated = True
                break
        if not dominated:
            front.append(points[i])
    return front


def compute_resource(cfg: dict) -> int:
    """Paper x-axis: U · L · n_PEs (Edge TPU) or array size (FuseMax)."""
    if "simd_units" in cfg:
        return (cfg["simd_units"] * 4 * cfg["lanes"] *
                cfg["x_pes"] * cfg["y_pes"])
    return cfg.get("x_pes", 1) * cfg.get("y_pes", 1)


def spread(values) -> dict:
    import numpy as np
    a = np.asarray(list(values), dtype=float)
    return dict(min=float(a.min()), p25=float(np.percentile(a, 25)),
                median=float(np.median(a)), p75=float(np.percentile(a, 75)),
                max=float(a.max()),
                rel_iqr=float((np.percentile(a, 75) - np.percentile(a, 25))
                              / max(np.median(a), 1e-30)))
