"""Layer-fusion configuration *search* for training graphs (paper §V-A).

MONET's central software knob is the fusion configuration, and picking one
"becomes more complex in neural network training": backward operators,
gradient tensors and activation policies all change which groups fit in
local SRAM.  ``repro.core.fusion`` can *validate* a partition (and its IP
solver covers the inference-style single-output setting); this module
*searches* fusion space over the full fwd+bwd(+optimizer) graph:

* **Genome** — a boundary bitmask over the topo order: bit ``i`` cuts
  between ``order[i]`` and ``order[i+1]``, so a genome encodes a partition
  into contiguous topo runs.  Every edge points forward in the topo order,
  hence every decoded quotient is acyclic by construction — no repair pass.
* **Decoder** — each run is re-grown through the shared
  :class:`~repro.core.fusion.GroupChecker` rules (SRAM inequality, tiling
  compatibility, op-type budget, length cap; collectives/DMA stay
  singleton), so every phenotype is feasible regardless of the genotype.
  The all-zeros genome decodes to exactly
  :func:`~repro.core.fusion.greedy_sram_partition` — the greedy
  SRAM-feasible seed — and the all-ones genome to the unfused
  layer-by-layer baseline.
* **Search** — NSGA-II (``repro.core.nsga2``) over the bitmask, minimizing
  ``(latency, peak_mem, energy)`` by default.  Every candidate is evaluated
  through the signature-memoizing engine: repeated sub-partitions hit the
  engine's subgraph cache, identical phenotypes from different genomes hit
  a memo keyed on ``BoundEngine.partition_sig`` (interned group content
  ids), and re-evaluating a known partition costs zero fresh node signings
  (asserted in tests/test_fusion_search.py).

The search composes with the other two optimization axes: wrap a
KEEP/RECOMPUTE/OFFLOAD :class:`~repro.core.memory.ActivationPolicy` via
:func:`search_fusion_policy`, and per-pipeline-stage searches via
``evaluate_parallel(..., fusion="search")`` (``repro.core.parallel``).
See docs/fusion_search.md for the genome encoding and the
cache-interaction rules.

The port's own copy of ``repro.core.fusion_search`` (numpy and plain Python):
names, signatures and numeric code are the reference's, held bit for
bit against it by ``tests/test_torch_search.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .accelerators import HDASpec
from .engine import get_engine, sign_count
from .fusion import (FusionConfig, GroupChecker, greedy_sram_partition,
                     manual_fusion, repair_partition, solve_fusion)
from .graph import WorkloadGraph
from .nsga2 import NSGA2Result, nsga2
from .scheduling import ScheduleResult, schedule
from .training_transform import TrainingGraph
from .verify import verify_result


@dataclass
class FusionSearchConfig:
    """Search budget + constraint set.  ``objectives`` name
    :class:`~repro.core.scheduling.ScheduleResult` attributes (minimized);
    the first two must stay ``(latency, peak_mem)`` — the domination
    report and ``best`` selection are defined on that plane.

    The snapshot/resume and budget fields mirror the
    :func:`repro.core.nsga2.nsga2` kwargs of the same names: crash-resume
    snapshots every ``snapshot_every`` generations, bit-for-bit continuation
    from ``resume``, wall-clock / evaluation bounds returning the
    best-so-far front (docs/resilience.md)."""

    pop_size: int = 24
    generations: int = 12
    seed: int = 0
    objectives: tuple = ("latency", "peak_mem", "energy")
    fusion: FusionConfig = field(default_factory=FusionConfig)
    snapshot_every: int = 0
    snapshot_path: str | None = None
    resume: dict | str | None = None
    max_seconds: float | None = None
    max_evals: int | None = None
    use_batch: bool = True         # population scoring via engine.score_batch
    #                                (bit-for-bit equal to the scalar loop)


@dataclass
class FusionCandidate:
    """One evaluated fusion configuration."""

    partition: tuple               # tuple of node-name tuples
    latency: float
    peak_mem: float
    energy: float
    n_subgraphs: int
    objectives: tuple              # in FusionSearchConfig.objectives order
    schedule: ScheduleResult | None = None

    def dominates(self, other: "FusionCandidate") -> bool:
        """Pareto domination on the (latency, peak_mem) plane."""
        return (self.latency <= other.latency
                and self.peak_mem <= other.peak_mem
                and (self.latency < other.latency
                     or self.peak_mem < other.peak_mem))

    def as_row(self) -> dict:
        return dict(latency=self.latency, peak_mem=self.peak_mem,
                    energy=self.energy, n_subgraphs=self.n_subgraphs)


@dataclass
class FusionSearchResult:
    baseline: FusionCandidate      # unfused layer-by-layer
    greedy: FusionCandidate        # greedy SRAM-feasible growth (the seed)
    best: FusionCandidate          # min latency with peak ≤ baseline peak
    pareto: list                   # FusionCandidate front, latency-sorted
    ga: NSGA2Result | None
    order: list                    # topo order the genome indexes
    stats: dict                    # evaluation / cache counters
    findings: list = field(default_factory=list)   # verifier report on best

    @property
    def best_dominates_baseline(self) -> bool:
        return self.best.dominates(self.baseline)


# ---------------------------------------------------------------------------
# genome encoding
# ---------------------------------------------------------------------------


def decode_genome(order: list, genome, checker: GroupChecker) -> list[tuple]:
    """Boundary bitmask → feasible partition: cut where ``genome`` says,
    then re-grow each contiguous run under the shared feasibility rules
    (which insert any further cuts the constraints force)."""
    part: list[tuple] = []
    state = checker.new_state()
    for i, n in enumerate(order):
        if i and genome[i - 1] and state[0]:
            part.append(state[0])
            state = checker.new_state()
        if checker.isolated(n):
            if state[0]:
                part.append(state[0])
                state = checker.new_state()
            part.append((n,))
            continue
        grown = checker.try_add(state, n)
        if grown is None:
            if state[0]:
                part.append(state[0])
            grown = checker.try_add(checker.new_state(), n)
        state = grown                 # a singleton is always feasible
    if state[0]:
        part.append(state[0])
    return part


def encode_partition(order: list, partition) -> np.ndarray:
    """Partition → boundary bitmask (the projection: a cut wherever two
    topo-adjacent nodes sit in different groups).  Exact for contiguous
    partitions; for non-contiguous ones (e.g. ``manual_fusion`` chains)
    this is the nearest contiguous genome — good enough for seeding."""
    group_of = {n: i for i, sg in enumerate(partition) for n in sg}
    return np.array([group_of[order[i]] != group_of[order[i + 1]]
                     for i in range(len(order) - 1)], dtype=bool)


# ---------------------------------------------------------------------------
# evaluation (engine-backed, partition-signature memoized)
# ---------------------------------------------------------------------------


def evaluate_partition(g: WorkloadGraph, hda: HDASpec, partition,
                       objectives: tuple = ("latency", "peak_mem", "energy"),
                       engine=None) -> FusionCandidate:
    """Cost one fusion configuration through the evaluation engine."""
    partition = tuple(tuple(sg) for sg in partition)
    res = schedule(g, hda, list(partition), engine=engine)
    return FusionCandidate(
        partition, res.latency, res.peak_mem, res.energy, len(partition),
        tuple(float(getattr(res, o)) for o in objectives), res)


class _Evaluator:
    """Two-level memo around :func:`evaluate_partition`: genome bytes →
    partition signature → candidate.  The second level is keyed on the
    engine's interned group-content ids (``BoundEngine.partition_sig``), so
    distinct genomes decoding to the same phenotype share one evaluation."""

    def __init__(self, g: WorkloadGraph, hda: HDASpec,
                 cfg: FusionSearchConfig, engine=None):
        self.g = g
        self.hda = hda
        self.cfg = cfg
        self.engine = engine if engine is not None else get_engine(hda)
        self.checker = GroupChecker(g, hda, cfg.fusion)
        self.order = g.topo_order()
        self._by_genome: dict[bytes, tuple] = {}
        self._by_part: dict[tuple, FusionCandidate] = {}
        self.stats = dict(genome_evals=0, unique_partitions=0,
                          memo_hits=0)

    def candidate(self, genome) -> FusionCandidate:
        self.stats["genome_evals"] += 1
        gkey = np.asarray(genome, dtype=bool).tobytes()
        pkey = self._by_genome.get(gkey)
        if pkey is None:
            part = decode_genome(self.order, genome, self.checker)
            pkey = self.engine.bind(self.g).partition_sig(part)
            self._by_genome[gkey] = pkey
        else:
            part = None
        cand = self._by_part.get(pkey)
        if cand is None:
            if part is None:            # genome seen, partition evicted
                part = decode_genome(self.order, genome, self.checker)
            self.stats["unique_partitions"] += 1
            cand = evaluate_partition(self.g, self.hda, part,
                                      self.cfg.objectives, self.engine)
            self._by_part[pkey] = cand
        else:
            self.stats["memo_hits"] += 1
        return cand

    def __call__(self, genome) -> tuple:
        return self.candidate(genome).objectives

    def batch(self, X) -> list:
        """Population objectives through ``engine.score_batch`` — the same
        two-level memo as :meth:`candidate` (identical hit/miss accounting,
        duplicate phenotypes inside the batch scored once), with all cache
        misses costed in one vectorized pass."""
        keys: list = []
        todo: dict[tuple, list] = {}    # pkey -> partition (unscored)
        for genome in X:
            self.stats["genome_evals"] += 1
            gkey = np.asarray(genome, dtype=bool).tobytes()
            pkey = self._by_genome.get(gkey)
            part = None
            if pkey is None:
                part = decode_genome(self.order, genome, self.checker)
                pkey = self.engine.bind(self.g).partition_sig(part)
                self._by_genome[gkey] = pkey
            if pkey in self._by_part or pkey in todo:
                self.stats["memo_hits"] += 1
            else:
                if part is None:        # genome seen, partition evicted
                    part = decode_genome(self.order, genome, self.checker)
                self.stats["unique_partitions"] += 1
                todo[pkey] = [tuple(sg) for sg in part]
            keys.append(pkey)
        if todo:
            jobs = [(self.g, self.hda, part) for part in todo.values()]
            for pkey, part, res in zip(todo, todo.values(),
                                       self.engine.score_batch(jobs),
                                       strict=True):
                self._by_part[pkey] = FusionCandidate(
                    tuple(part), res.latency, res.peak_mem, res.energy,
                    len(part),
                    tuple(float(getattr(res, o))
                          for o in self.cfg.objectives), res)
        return [self._by_part[k].objectives for k in keys]


def _pick_best(front: list, baseline: FusionCandidate) -> FusionCandidate:
    """Min-latency front point whose peak does not exceed the unfused
    baseline's; falls back to plain min latency when fusion cannot avoid a
    peak increase (tiny graphs where every boundary merge overlaps the
    peak step)."""
    fits = [c for c in front if c.peak_mem <= baseline.peak_mem]
    return min(fits or front, key=lambda c: (c.latency, c.peak_mem))


def _pareto_of(cands: list) -> list:
    """Non-dominated subset on the full objective tuple, deduped by
    partition, latency-sorted."""
    out: list = []
    seen: set = set()
    for c in cands:
        if c.partition in seen:
            continue
        seen.add(c.partition)
        dominated = any(
            all(a <= b for a, b in zip(o.objectives, c.objectives, strict=True))
            and any(a < b for a, b in zip(o.objectives, c.objectives, strict=True))
            for o in cands if o is not c)
        if not dominated:
            out.append(c)
    out.sort(key=lambda c: (c.latency, c.peak_mem))
    return out


# ---------------------------------------------------------------------------
# the search
# ---------------------------------------------------------------------------


def search_fusion(g: WorkloadGraph, hda: HDASpec,
                  cfg: FusionSearchConfig | None = None,
                  engine=None) -> FusionSearchResult:
    """NSGA-II over the boundary genome, seeded with the three reference
    configurations: unfused layer-by-layer (all-ones — also the population's
    pinned individual 0), greedy SRAM-feasible growth (all-zeros) and the
    contiguous projection of ``manual_fusion``."""
    cfg = cfg or FusionSearchConfig()
    ev = _Evaluator(g, hda, cfg, engine)
    order, n = ev.order, len(ev.order)
    eng = ev.engine
    sign0 = sign_count()
    stats0 = dict(eng.stats)

    baseline = ev.candidate(np.ones(n - 1, dtype=bool)) if n > 1 else \
        evaluate_partition(g, hda, [(order[0],)], cfg.objectives, eng)
    greedy = ev.candidate(np.zeros(n - 1, dtype=bool)) if n > 1 else baseline

    ga = None
    cands = {baseline.partition: baseline, greedy.partition: greedy}
    if n > 2:
        init = np.stack([
            np.ones(n - 1, dtype=bool),                       # layer-by-layer
            np.zeros(n - 1, dtype=bool),                      # greedy growth
            encode_partition(order, manual_fusion(g)),        # manual pattern
        ])
        ga = nsga2(ev, n - 1, pop_size=cfg.pop_size,
                   generations=cfg.generations, seed=cfg.seed, init=init,
                   snapshot_every=cfg.snapshot_every,
                   snapshot_path=cfg.snapshot_path, resume=cfg.resume,
                   max_seconds=cfg.max_seconds, max_evals=cfg.max_evals,
                   evaluate_batch=ev.batch if cfg.use_batch else None)
        for x in np.concatenate([ga.pareto_X, ga.X]):
            c = ev.candidate(x)
            cands.setdefault(c.partition, c)

    front = _pareto_of(list(cands.values()))
    best = _pick_best(front, baseline)
    stats = dict(ev.stats)
    stats["fresh_signings"] = sign_count() - sign0
    for k, v in eng.stats.items():
        stats[f"engine_{k}"] = v - stats0[k]
    # certify the winning candidate (M/S/C rule sweep — docs/verify.md);
    # runs after the stats capture so the zero-fresh-signings bars hold
    findings = verify_result(g, hda, list(best.partition), best.schedule,
                             engine=eng)
    return FusionSearchResult(baseline, greedy, best, front, ga, order,
                              stats, findings)


def exhaustive_fusion(g: WorkloadGraph, hda: HDASpec,
                      cfg: FusionSearchConfig | None = None,
                      engine=None, max_boundaries: int = 16
                      ) -> FusionSearchResult:
    """Evaluate *every* boundary genome (2^(n−1)) — the ground truth the
    search is tested against on tiny graphs (tests/test_fusion_search.py).
    Refuses graphs with more than ``max_boundaries`` boundaries."""
    cfg = cfg or FusionSearchConfig()
    ev = _Evaluator(g, hda, cfg, engine)
    n = len(ev.order)
    if n - 1 > max_boundaries:
        raise ValueError(f"{n - 1} boundaries > {max_boundaries}; "
                         "exhaustive enumeration is for tiny graphs only")
    cands: dict = {}
    genome = np.zeros(max(n - 1, 0), dtype=bool)
    for bits in range(1 << max(n - 1, 0)):
        for i in range(n - 1):
            genome[i] = (bits >> i) & 1
        c = ev.candidate(genome)
        cands.setdefault(c.partition, c)
    baseline = ev.candidate(np.ones(n - 1, dtype=bool)) if n > 1 else \
        next(iter(cands.values()))
    greedy = ev.candidate(np.zeros(n - 1, dtype=bool)) if n > 1 else baseline
    front = _pareto_of(list(cands.values()))
    return FusionSearchResult(baseline, greedy, _pick_best(front, baseline),
                              front, None, ev.order, dict(ev.stats))


def best_partition(g: WorkloadGraph, hda: HDASpec,
                   cfg: FusionSearchConfig | None = None,
                   engine=None) -> list[tuple]:
    """Searched-best partition (the ``fusion="search"`` hook used by
    ``dse.sweep``, ``evaluate_parallel`` and the policy evaluators)."""
    return list(search_fusion(g, hda, cfg, engine).best.partition)


def fusion_partition(g: WorkloadGraph, hda: HDASpec, fusion: str | None,
                     fusion_cfg=None, engine=None,
                     search_default: FusionSearchConfig | None = None,
                     solver_default: FusionConfig | None = None):
    """The one fusion-mode dispatcher behind ``dse.sweep``,
    ``evaluate_parallel`` and ``checkpointing.evaluate_*``: returns
    ``(partition, quotient)`` for a named mode and raises on an unknown
    one.

    * ``None`` / ``"none"`` — layer-by-layer (the scheduler default);
    * ``"manual"``          — hand-designed conv/GEMM + element-wise chains
      (repaired, with the quotient returned so ``schedule`` skips
      rebuilding it);
    * ``"greedy"``          — SRAM-feasible growth along the topo order
      (contiguous runs: quotient acyclic by construction);
    * ``"solver"``          — the exact-cover IP (``fusion_cfg``: a
      :class:`~repro.core.fusion.FusionConfig`; else ``solver_default``);
    * ``"search"``          — boundary-genome NSGA-II best
      (``fusion_cfg``: a :class:`FusionSearchConfig`; otherwise
      ``search_default`` or a small budget)."""
    if fusion in (None, "none"):
        return None, None
    if fusion == "manual":
        return repair_partition(g, manual_fusion(g), return_quotient=True)
    if fusion == "greedy":
        return greedy_sram_partition(g, hda), None
    if fusion == "solver":
        cfg = fusion_cfg if isinstance(fusion_cfg, FusionConfig) else \
            solver_default
        return solve_fusion(g, hda, cfg), None
    if fusion == "search":
        scfg = fusion_cfg if isinstance(fusion_cfg, FusionSearchConfig) \
            else (search_default or
                  FusionSearchConfig(pop_size=8, generations=4))
        return best_partition(g, hda, scfg, engine=engine), None
    raise ValueError(f"unknown fusion mode {fusion!r}")


# ---------------------------------------------------------------------------
# composition with the activation-policy axis (KEEP / RECOMPUTE / OFFLOAD)
# ---------------------------------------------------------------------------


def search_fusion_policy(tg: TrainingGraph, hda: HDASpec, policy: dict,
                         cfg: FusionSearchConfig | None = None,
                         engine=None) -> FusionSearchResult:
    """Fusion search on the graph rewritten under a per-activation policy
    map (``activation -> ActivationPolicy``; unlisted activations are
    KEPT): recompute clones and DMA offload/fetch nodes are part of the
    searched graph, so the genome sees the policy's true topology — DMA
    nodes stay singleton (dedicated ``dma`` resource) and recompute
    subgraphs fuse like any forward chain."""
    from .checkpointing import apply_policy
    g2 = apply_policy(tg, policy)
    return search_fusion(g2, hda, cfg, engine)
