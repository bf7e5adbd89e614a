"""Activation checkpointing and lifetime policies (paper §II-A Eq. 6, §V-B).

* ``activation_set``        — the checkpointable set 𝒜 (fwd→bwd tensors).
* ``knapsack_baseline``     — the *linear* Checkmate/Dace-AD MILP
  (min Σ r_a(1−x_a) s.t. Σ m_a x_a ≤ M).  Because the constraint matrix is a
  single knapsack row, we solve it exactly with DP — stronger than an LP
  relaxation and dependency-free.
* ``apply_checkpointing``   — the graph rewrite: discarded activations are
  replaced by *shared* minimal recompute subgraphs spliced in front of their
  backward consumers.  Sharing of common recompute ancestors is what makes
  the true cost **non-linear** (paper Fig. 11): r({a,b}) ≠ r(a)+r(b).
* ``ga_checkpointing``      — NSGA-II over the keep-bitmask with objectives
  (latency, energy, stored-activation bytes), evaluated through the full
  fusion-aware cost model (paper Fig. 12).
* ``apply_policy`` / ``ga_policy`` — the ternary generalization over
  :class:`~repro.core.memory.ActivationPolicy` (KEEP / RECOMPUTE / OFFLOAD):
  offloaded activations are drained to the off-chip pool over DMA instead of
  recomputed (NeuroTrainer-style), extending the Fig. 11/12 trade-off
  curves with recompute-vs-offload Pareto points on
  (latency, energy, peak-memory).

The port's own copy of ``repro.core.checkpointing`` (numpy and plain Python):
names, signatures and numeric code are the reference's, held bit for
bit against it by ``tests/test_torch_checkpointing.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np

from .accelerators import HDASpec
from .engine import get_engine, graph_sigs
from .fusion import FusionConfig
from .graph import Node, TensorSpec, WorkloadGraph
from .memory import ActivationPolicy, apply_offload
from .nsga2 import NSGA2Result, nsga2, nsga2_int
from .scheduling import ScheduleResult, schedule
from .training_transform import BWD_KINDS, TrainingGraph
from .verify import sanitize_enabled, verify_result


# ---------------------------------------------------------------------------
# the activation set 𝒜 and the linear model
# ---------------------------------------------------------------------------


def activation_set(tg: TrainingGraph) -> list[str]:
    return list(tg.activations)


def recompute_flops(g: WorkloadGraph, tensor: str) -> int:
    """Linear-model r_a: FLOPs of the producing node (inputs assumed live)."""
    prod = g.producer.get(tensor)
    return g.nodes[prod].flops if prod else 0


_KNAPSACK: dict = {}   # (m, r) profile -> (dp, choice, table_cap)


def knapsack_baseline(tg: TrainingGraph, memory_budget: int,
                      granularity: int = 4096) -> tuple[list[str], int]:
    """Exact DP for  max Σ r_a·x_a  s.t.  Σ m_a·x_a ≤ M  (equivalently the
    paper's min-recompute form).  Returns (kept activations, recompute
    FLOPs of the discarded ones).

    The DP table is *prefix-closed* in the capacity axis: every row update
    at index j only reads indices ≤ j, and an item skipped at a small cap
    (``m[i] > cap``) leaves the ``[:cap+1]`` prefix of a larger table
    untouched.  One table per (m, r) profile therefore serves every budget
    up to its build cap with bit-identical backtracks — budget sweeps over
    the same graph (the ``milp_vs_ga_same_budget`` bench) warm-start from
    the cached skeleton instead of rebuilding the model."""
    g = tg.graph
    acts = activation_set(tg)
    m = [max(1, g.tensors[a].bytes // granularity) for a in acts]
    r = [recompute_flops(g, a) for a in acts]
    cap = memory_budget // granularity
    n = len(acts)
    if cap <= 0 or n == 0:
        return [], sum(r)
    key = (tuple(m), tuple(r))
    ent = _KNAPSACK.get(key)
    if ent is None or ent[2] < cap:
        dp = np.full(cap + 1, 0, dtype=np.int64)
        choice = np.zeros((n, cap + 1), dtype=bool)
        for i in range(n):
            if m[i] > cap:
                continue
            new = dp.copy()
            shifted = dp[: cap + 1 - m[i]] + r[i]
            better = shifted > dp[m[i]:]
            new[m[i]:][better] = shifted[better]
            choice[i, m[i]:] = better
            dp = new
        if len(_KNAPSACK) >= 32:
            _KNAPSACK.clear()
        ent = _KNAPSACK[key] = (dp, choice, cap)
    dp, choice = ent[0], ent[1]
    # backtrack (over the requested-budget prefix of the cached table)
    kept: list[str] = []
    c = int(np.argmax(dp[: cap + 1]))
    for i in range(n - 1, -1, -1):
        if c >= m[i] and choice[i, c]:
            kept.append(acts[i])
            c -= m[i]
    kept.reverse()
    discard = set(acts) - set(kept)
    return kept, sum(r[acts.index(a)] for a in discard)


# ---------------------------------------------------------------------------
# graph rewrite: insert shared recompute subgraphs
# ---------------------------------------------------------------------------


def apply_checkpointing(tg: TrainingGraph, keep: set | frozenset
                        ) -> WorkloadGraph:
    """Return a new training graph where every activation a ∉ keep is
    discarded and regenerated by a recompute subgraph containing only the
    minimal fwd operators needed (paper §III).  Recompute nodes common to
    several discarded activations are shared."""
    # sign the base graph and build its structural caches first: the copy
    # inherits signature tables, adjacency and topo order, so the rewrite
    # below only pays for its delta (engine fast path)
    graph_sigs(tg.graph)
    tg.graph.topo_order()
    g = tg.graph.copy()
    acts = set(tg.activations)
    discard = acts - set(keep)
    if not discard:
        return g

    stored = set(keep)

    def is_stored(t: str) -> bool:
        spec = g.tensors[t]
        return (t in stored or spec.is_param or spec.is_state or spec.is_input)

    clone_of: dict[str, str] = {}     # original tensor -> recomputed tensor

    def rc_tensor(t: str) -> str:
        """Tensor name holding the recomputed value of ``t`` (cloning the
        producer chain on demand, with sharing via ``clone_of``)."""
        if is_stored(t):
            return t
        if t in clone_of:
            return clone_of[t]
        prod_name = g.producer.get(t)
        if prod_name is None:      # unproduced non-stored: keep original ref
            clone_of[t] = t
            return t
        nd = tg.graph.nodes[prod_name]   # original (pre-rewrite) node
        new_inputs = [rc_tensor(x) for x in nd.inputs]
        new_outputs = []
        for o in nd.outputs:
            spec = g.tensors[o]
            cname = f"{o}.rc"
            if cname not in g.tensors:
                g.add_tensor(TensorSpec(cname, spec.shape, spec.dtype))
            clone_of[o] = cname
            new_outputs.append(cname)
        rc_name = f"{prod_name}.rc"
        if rc_name not in g.nodes:
            g.add_node(Node(rc_name, nd.op, "recompute", dict(nd.dims),
                            new_inputs, new_outputs, nd.flops, prod_name,
                            {**nd.meta, "recompute_of": prod_name}))
        return clone_of[t]

    # rewire every backward consumer of a discarded activation
    for a in sorted(discard):
        consumers = [c for c in list(tg.graph.consumers.get(a, []))
                     if tg.graph.nodes[c].kind in BWD_KINDS]
        if not consumers:
            continue
        rc = rc_tensor(a)
        for c in consumers:
            if rc != a:
                g.rename_tensor_for(c, a, rc)

    g.validate()
    return g


def stored_activation_bytes(tg: TrainingGraph, keep) -> int:
    g = tg.graph
    return sum(g.tensors[a].bytes for a in keep)


# ---------------------------------------------------------------------------
# ternary activation policies: KEEP / RECOMPUTE / OFFLOAD
# ---------------------------------------------------------------------------


def apply_policy(tg: TrainingGraph, policy: dict) -> WorkloadGraph:
    """Rewrite ``tg`` under a per-activation policy map
    (``activation -> ActivationPolicy``; unlisted activations are KEPT):
    RECOMPUTE activations go through :func:`apply_checkpointing`'s shared
    recompute subgraphs, OFFLOAD activations through
    :func:`~repro.core.memory.apply_offload`'s DMA transfer nodes."""
    acts = set(tg.activations)
    rec = {a for a in acts
           if policy.get(a) == ActivationPolicy.RECOMPUTE}
    off = {a for a in acts
           if policy.get(a) == ActivationPolicy.OFFLOAD}
    g = apply_checkpointing(tg, acts - rec)
    if off:
        apply_offload(g, off)
        g.validate()
    return g


# ---------------------------------------------------------------------------
# NSGA-II driver (paper Fig. 12)
# ---------------------------------------------------------------------------


def _fusion_partition(g: WorkloadGraph, hda: HDASpec, fusion: str,
                      fusion_cfg, engine):
    """(partition, quotient) for one rewritten graph — the shared
    dispatcher (``fusion_search.fusion_partition``) with this module's
    historical solver budget.  ``fusion="search"`` co-optimizes fusion
    with the activation policy (budget via a ``FusionSearchConfig``
    ``fusion_cfg``)."""
    from .fusion_search import fusion_partition
    return fusion_partition(g, hda, fusion, fusion_cfg, engine,
                            solver_default=FusionConfig(time_limit_s=2.0))


@dataclass
class ACSolution:
    keep: tuple
    latency: float
    energy: float
    act_bytes: int
    schedule: ScheduleResult | None = None


@dataclass
class ACResult:
    baseline: ACSolution
    pareto: list = field(default_factory=list)
    ga: NSGA2Result | None = None
    activations: list = field(default_factory=list)


def evaluate_checkpointing(tg: TrainingGraph, hda: HDASpec, keep: set,
                           fusion: str = "manual",
                           fusion_cfg: FusionConfig | None = None,
                           engine=None) -> ACSolution:
    """Pass a shared ``engine`` (see ``repro.core.engine.get_engine``) when
    evaluating many keep-sets: signature-keyed cost caches then make each
    evaluation pay only for the delta its rewrite introduces."""
    if not set(tg.activations) - set(keep):
        # keep-everything is the identity rewrite: schedule the base graph
        # directly (read-only here) instead of paying a full graph copy
        g2 = tg.graph
    else:
        g2 = apply_checkpointing(tg, keep)
    part, quotient = _fusion_partition(g2, hda, fusion, fusion_cfg, engine)
    res = schedule(g2, hda, part, engine=engine, quotient=quotient)
    return ACSolution(tuple(sorted(keep)), res.latency, res.energy,
                      stored_activation_bytes(tg, keep), res)


def ga_checkpointing(tg: TrainingGraph, hda: HDASpec, pop_size: int = 24,
                     generations: int = 12, seed: int = 0,
                     fusion: str = "manual", use_batch: bool = True
                     ) -> ACResult:
    acts = activation_set(tg)
    n = len(acts)
    cache: dict[bytes, tuple] = {}
    engine = get_engine(hda)      # shared across every genome evaluation

    def evaluate(mask: np.ndarray) -> tuple:
        key = mask.tobytes()
        if key not in cache:
            keep = {acts[i] for i in range(n) if mask[i]}
            s = evaluate_checkpointing(tg, hda, keep, fusion, engine=engine)
            cache[key] = (s.latency, s.energy, float(s.act_bytes))
        return cache[key]

    evaluate_batch = None
    if use_batch:
        # batched population scoring on the engine's SoA signature tables —
        # bit-for-bit equal to ``evaluate`` (tests/test_engine_batch.py),
        # so toggling it never changes the search trajectory
        ev = engine.population_evaluator(tg, fusion)

        def evaluate_batch(P: np.ndarray) -> list:
            out: list = [None] * len(P)
            miss: list = []
            for j, mask in enumerate(P):
                hit = cache.get(mask.tobytes())
                if hit is None:
                    miss.append(j)
                else:
                    out[j] = hit
            if miss:
                # one call for the whole generation: the evaluator resolves
                # every group-cost lookup in a single cross-phenotype pass
                scored = ev.score_keep_batch([P[j] for j in miss])
                for j, s in zip(miss, scored, strict=True):
                    cache[P[j].tobytes()] = out[j] = s
            return out

    res = nsga2(evaluate, n, pop_size=pop_size, generations=generations,
                seed=seed, evaluate_batch=evaluate_batch)
    baseline = evaluate_checkpointing(tg, hda, set(acts), fusion,
                                      engine=engine)
    pareto = []
    for x, f in zip(res.pareto_X, res.pareto_F, strict=True):
        keep = tuple(sorted(acts[i] for i in range(n) if x[i]))
        pareto.append(ACSolution(keep, f[0], f[1], int(f[2])))
    pareto.sort(key=lambda s: s.act_bytes)
    return ACResult(baseline, pareto, res, acts)


# ---------------------------------------------------------------------------
# NSGA-II over the ternary policy genome (recompute vs offload)
# ---------------------------------------------------------------------------


@dataclass
class PolicySolution:
    """One evaluated policy assignment.  ``policy`` lists the non-KEEP
    decisions as sorted ``(activation, ActivationPolicy)`` pairs."""

    policy: tuple
    latency: float
    energy: float
    peak_mem: float
    act_bytes: int                 # stored (KEEP) activation bytes
    spill_bytes: float = 0.0       # DMA offload traffic
    schedule: ScheduleResult | None = None
    findings: list = field(default_factory=list)   # verifier report

    def n_of(self, which: ActivationPolicy) -> int:
        return sum(1 for _, p in self.policy if p == which)


@dataclass
class PolicyResult:
    baseline: PolicySolution       # all-KEEP
    pareto: list = field(default_factory=list)
    ga: NSGA2Result | None = None
    activations: list = field(default_factory=list)


#: solved-policy memo for the scalar oracle: keyed on the graph fingerprint,
#: the signature generation, the target spec, and the non-KEEP decision tuple
#: (which fully determines the rewrite — KEEP entries are no-ops).  This is
#: what turns the ``ga_policy`` *tail* — the baseline + per-Pareto-winner
#: re-evaluation with the verifier on — into a warm-path lookup on repeated
#: searches.  Bypassed under ``REPRO_SANITIZE`` so sanitizer runs always
#: re-derive (and re-verify) from scratch.
_POLICY_MEMO: dict = {}
_POLICY_MEMO_CAP = 256


def evaluate_policy(tg: TrainingGraph, hda: HDASpec, policy: dict,
                    fusion: str = "manual",
                    fusion_cfg: FusionConfig | None = None,
                    engine=None, verify: bool = False) -> PolicySolution:
    """Schedule one policy assignment through the full fusion-aware model.
    Pass a shared ``engine`` when evaluating many policies: each rewrite
    then only pays for the delta it introduces (recompute clones, DMA
    nodes), and repeated evaluations of the same decision tuple return a
    memoized solution outright.  ``verify=True`` runs the model-invariant
    verifier on the evaluated candidate and attaches the findings —
    ``ga_policy`` enables it for the baseline and the final Pareto front,
    but inner GA genome evaluations leave it off (it is opt-in so
    policy-sweep hot loops stay unperturbed)."""
    decided = tuple(sorted((a, ActivationPolicy(int(p)))
                           for a, p in policy.items()
                           if ActivationPolicy(int(p)) !=
                           ActivationPolicy.KEEP))
    memo_key = None
    if engine is not None and fusion_cfg is None and not sanitize_enabled():
        from .engine import _SIG_GEN, _fingerprint
        memo_key = (_fingerprint(tg.graph, graph_sigs(tg.graph)), _SIG_GEN,
                    hda, fusion, decided, verify)
        hit = _POLICY_MEMO.get(memo_key)
        if hit is not None:
            return replace(hit, findings=list(hit.findings))
    if all(policy.get(a, ActivationPolicy.KEEP) == ActivationPolicy.KEEP
           for a in tg.activations):
        # all-KEEP is the identity rewrite: schedule the base graph
        # directly (read-only here) instead of paying a full graph copy
        g2 = tg.graph
    else:
        g2 = apply_policy(tg, policy)
    part, quotient = _fusion_partition(g2, hda, fusion, fusion_cfg, engine)
    res = schedule(g2, hda, part, engine=engine, quotient=quotient)
    kept = [a for a in tg.activations
            if policy.get(a, ActivationPolicy.KEEP) == ActivationPolicy.KEEP]
    findings = [] if not verify else verify_result(
        g2, hda, part or [(n,) for n in g2.topo_order()], res, engine=engine)
    sol = PolicySolution(decided, res.latency, res.energy, res.peak_mem,
                         stored_activation_bytes(tg, kept),
                         res.spill_bytes, res, findings)
    if memo_key is not None:
        if len(_POLICY_MEMO) >= _POLICY_MEMO_CAP:
            _POLICY_MEMO.clear()
        _POLICY_MEMO[memo_key] = sol
    return sol


def uniform_policy(tg: TrainingGraph, which: ActivationPolicy) -> dict:
    """The corner policy assigning ``which`` to every activation in 𝒜."""
    return {a: which for a in tg.activations}


def ga_policy(tg: TrainingGraph, hda: HDASpec, pop_size: int = 24,
              generations: int = 12, seed: int = 0,
              fusion: str = "manual", snapshot_every: int = 0,
              snapshot_path: str | None = None,
              resume: dict | str | None = None,
              max_seconds: float | None = None,
              max_evals: int | None = None,
              use_batch: bool = True) -> PolicyResult:
    """NSGA-II over the ternary genome (gene i ∈ {KEEP, RECOMPUTE, OFFLOAD}
    for activation i), minimizing (latency, energy, peak memory) — the
    recompute-vs-offload generalization of :func:`ga_checkpointing`
    (extends paper Fig. 11/12).  The three corner policies seed the initial
    population so the front always brackets the trade-off.

    ``seed`` fixes the whole trajectory (same seed ⇒ identical fronts); the
    snapshot/resume and budget kwargs are forwarded to
    :func:`repro.core.nsga2.nsga2_int` (docs/resilience.md).
    ``use_batch`` routes population scoring through the batched SoA
    evaluator (docs/engine.md) — bit-for-bit equal to the scalar path, so
    resuming a snapshot with the flag toggled continues the exact run."""
    acts = activation_set(tg)
    n = len(acts)
    engine = get_engine(hda)
    cache: dict[bytes, tuple] = {}

    def evaluate(genome: np.ndarray) -> tuple:
        key = genome.astype(np.int8).tobytes()
        if key not in cache:
            pol = {acts[i]: ActivationPolicy(int(genome[i]))
                   for i in range(n)}
            s = evaluate_policy(tg, hda, pol, fusion, engine=engine)
            cache[key] = (s.latency, s.energy, float(s.peak_mem))
        return cache[key]

    evaluate_batch = None
    if use_batch:
        ev = engine.population_evaluator(tg, fusion)

        def evaluate_batch(P: np.ndarray) -> list:
            out: list = [None] * len(P)
            miss: list = []
            for j, genome in enumerate(P):
                hit = cache.get(genome.astype(np.int8).tobytes())
                if hit is None:
                    miss.append(j)
                else:
                    out[j] = hit
            if miss:
                # one call for the whole generation: OFFLOAD genes run on
                # the SoA fast path and all group costs resolve in a single
                # cross-phenotype pass (docs/engine.md)
                scored = ev.score_policy_batch([P[j] for j in miss])
                for j, s in zip(miss, scored, strict=True):
                    cache[P[j].astype(np.int8).tobytes()] = out[j] = s
            return out

    init = np.array([[int(ActivationPolicy.KEEP)] * n,
                     [int(ActivationPolicy.RECOMPUTE)] * n,
                     [int(ActivationPolicy.OFFLOAD)] * n])
    res = nsga2_int(evaluate, [(0, 2)] * n, pop_size=pop_size,
                    generations=generations, seed=seed, init=init,
                    snapshot_every=snapshot_every,
                    snapshot_path=snapshot_path, resume=resume,
                    max_seconds=max_seconds, max_evals=max_evals,
                    evaluate_batch=evaluate_batch)
    baseline = evaluate_policy(tg, hda, {}, fusion, engine=engine,
                               verify=True)
    pareto = []
    for x in res.pareto_X:
        pol = {acts[i]: ActivationPolicy(int(x[i])) for i in range(n)}
        pareto.append(evaluate_policy(tg, hda, pol, fusion, engine=engine,
                                      verify=True))
    pareto.sort(key=lambda s: s.peak_mem)
    return PolicyResult(baseline, pareto, res, acts)
