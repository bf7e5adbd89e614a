"""Constraint-based layer-fusion solver (paper §V-A).

1.  **Candidate enumeration** — bounded BFS from every node.  A node ``v``
    may join a growing subgraph S only when every predecessor of ``v`` that is
    a descendant of the seed is already in S (this guarantees *convexity*, so
    the quotient graph stays acyclic).  Backtracking constraints prune the
    search (paper):

    * memory:      Σᵢ mᵢ,c / T  ≤  M_c        (tile working set fits local SRAM)
    * tiling:      ∀ i,j:  Tᵢ | Tⱼ  or  Tⱼ | Tᵢ  (intra-core tiling compatible)
    * op types:    ≤ 3 conv  and  ≤ 2 GEMM per subgraph
    * BFS length:  |S| ≤ max_len

2.  **Post filter** — at most one node with outgoing external edges
    (Σ_{v∈g} o_v ≤ 1), so fused subgraphs never spill intermediates off-chip.

3.  **Integer program** — exact cover of V minimizing Σ x_g (number of
    subgraphs).  Solved by a memoized interval DP over the topo index
    (state = first-uncovered index + the bitmask of covered-ahead nodes;
    every usable candidate at a state starts exactly at its first-uncovered
    index), which proves optimality in tens of milliseconds where the
    legacy branch-and-bound burned its whole time budget; the BnB with a
    greedy incumbent is kept as the fallback for adversarial state spaces.

The port's own copy of ``repro.core.fusion`` (numpy and plain Python):
names, signatures and numeric code are the reference's, held bit for
bit against it by ``tests/test_torch_search.py``.
"""

from __future__ import annotations

import math
import sys
import time
from dataclasses import dataclass

from .accelerators import HDASpec
from .engine import graph_sigs
from .graph import WorkloadGraph
from .memory import local_capacity, tile_working_set


@dataclass
class FusionConfig:
    max_len: int = 6
    max_conv: int = 3
    max_gemm: int = 2
    enforce_single_output: bool = True
    enforce_memory: bool = True
    enforce_tiling: bool = True
    max_candidates: int = 40000
    max_per_seed: int = 400
    time_limit_s: float = 10.0


# ---------------------------------------------------------------------------
# graph pre-analysis
# ---------------------------------------------------------------------------


class _Idx:
    """Integer-indexed view of the graph with descendant bitsets."""

    def __init__(self, g: WorkloadGraph):
        self.g = g
        self.order = g.topo_order()
        self.idx = {n: i for i, n in enumerate(self.order)}
        n = len(self.order)
        self.preds = [[self.idx[p] for p in g.predecessors(nm)]
                      for nm in self.order]
        self.succs = [[self.idx[s] for s in g.successors(nm)]
                      for nm in self.order]
        # descendants bitmask, computed in reverse topo order
        self.desc = [0] * n
        for i in range(n - 1, -1, -1):
            m = 0
            for s in self.succs[i]:
                m |= (1 << s) | self.desc[s]
            self.desc[i] = m

    def node(self, i: int):
        return self.g.nodes[self.order[i]]


# ---------------------------------------------------------------------------
# candidate enumeration
# ---------------------------------------------------------------------------


def enumerate_candidates(g: WorkloadGraph, hda: HDASpec,
                         cfg: FusionConfig | None = None) -> list[tuple]:
    cfg = cfg or FusionConfig()
    ix = _Idx(g)
    n = len(ix.order)
    # SRAM ceiling from the unified memory model (repro.core.memory)
    cap = local_capacity(hda)

    # reuse the evaluation engine's per-graph SoA tables (tiling factors and
    # unique per-node I/O bytes) instead of recomputing them here
    sigs = graph_sigs(g)
    tiling = [sigs.tiling[ix.order[i]] for i in range(n)]
    nbytes = [sigs.io_bytes[ix.order[i]] for i in range(n)]

    candidates: set[int] = set()        # node-index bitmasks, |S| >= 2
    deadline = time.monotonic() + cfg.time_limit_s
    # per-node pred/succ bitmasks: convexity and frontier updates become
    # single big-int operations instead of per-edge Python loops
    pmask = [0] * n
    smask = [0] * n
    for v in range(n):
        for p in ix.preds[v]:
            pmask[v] |= 1 << p
        for s in ix.succs[v]:
            smask[v] |= 1 << s
    op_counts = [_op_counts(ix.node(i)) for i in range(n)]
    fusable = [ix.node(i).op_class not in ("comm", "dma") for i in range(n)]
    # collectives / DMA transfers run on their own resource (ici / dma):
    # never fused with compute
    enforce_tiling, enforce_memory = cfg.enforce_tiling, cfg.enforce_memory
    max_conv, max_gemm, max_len = cfg.max_conv, cfg.max_gemm, cfg.max_len

    for seed in range(n):
        if time.monotonic() > deadline or len(candidates) >= cfg.max_candidates:
            break
        if not fusable[seed]:
            continue
        # nodes reachable from the seed: only their preds gate convexity
        reach = ix.desc[seed] | (1 << seed)
        per_seed = 0
        t0 = tiling[seed]
        b0 = float(nbytes[seed])
        S0 = 1 << seed
        f0 = 0
        m = smask[seed]
        while m:
            low = m & -m
            m ^= low
            v = low.bit_length() - 1
            if not pmask[v] & reach & ~S0:
                f0 |= low
        # DFS over grow decisions; each state carries its bitmask, size,
        # (conv, gemm) counts, tiling factors > 1, the working-set sums
        # (s1 = Σ bytes of t==1 members, s2 = Σ bytes of t>1 members, their
        # min tiling) and the eligible-frontier bitmask — all updated in
        # O(1)/O(deg) per grow instead of rescanning the whole subgraph
        stack = [(S0, 1, op_counts[seed],
                  (t0,) if t0 > 1 else (),
                  0.0 if t0 > 1 else b0, b0 if t0 > 1 else 0.0,
                  t0 if t0 > 1 else 0, f0)]
        seen_states: set[int] = set()
        while stack and per_seed < cfg.max_per_seed:
            S, size, counts, ts, s1, s2, tmin, frontier = stack.pop()
            if size >= 2 and S not in candidates:
                candidates.add(S)
                per_seed += 1
            if size >= max_len:
                continue
            fm = frontier
            while fm:                       # frontier bits, ascending
                low = fm & -fm
                fm ^= low
                v = low.bit_length() - 1
                if not fusable[v]:
                    continue
                ca, cb = op_counts[v]
                ca += counts[0]
                cb += counts[1]
                if ca > max_conv or cb > max_gemm:
                    continue
                t = tiling[v]
                if enforce_tiling and t > 1 and \
                        any(a % t and t % a for a in ts):
                    continue
                S2 = S | low
                if S2 in seen_states:
                    continue
                b = float(nbytes[v])
                if t > 1:
                    n1, n2 = s1, s2 + b
                    nt = t if not tmin or t < tmin else tmin
                else:
                    n1, n2 = s1 + b, s2
                    nt = tmin
                if enforce_memory and \
                        n1 + (n2 / nt if nt else 0.0) > cap:
                    # shared tile-working-set constraint (memory model):
                    # same arithmetic as memory.tile_working_set
                    continue
                seen_states.add(S2)
                # grown frontier: drop v, add v's now-eligible successors
                # (adding v only ever unblocks successors of v)
                nf = frontier & ~low
                nm = smask[v] & ~S2 & ~nf
                while nm:
                    wl = nm & -nm
                    nm ^= wl
                    if not pmask[wl.bit_length() - 1] & reach & ~S2:
                        nf |= wl
                stack.append((S2, size + 1, (ca, cb),
                              ts + ((t,) if t > 1 else ()),
                              n1, n2, nt, nf))

    # post filter: ≤ 1 node with outgoing external edges
    out: list[tuple] = []
    for m in candidates:
        S: list[int] = []
        ext = 0
        mm = m
        while mm:
            low = mm & -mm
            mm ^= low
            u = low.bit_length() - 1
            S.append(u)
            if smask[u] & ~m:
                ext += 1
        if cfg.enforce_single_output and ext > 1:
            continue
        out.append(tuple(S))
    # singletons are always valid
    out.extend((i,) for i in range(n))
    out.sort(key=lambda s: (-len(s), s))
    return [tuple(ix.order[i] for i in S) for S in out]


def _op_counts(nd) -> tuple:
    return (1 if nd.op_class == "conv" else 0,
            1 if nd.op_class == "gemm" else 0)


def _add_counts(c, nd) -> tuple:
    a, b = _op_counts(nd)
    return (c[0] + a, c[1] + b)


def _external_outputs(ix: _Idx, S: frozenset) -> int:
    cnt = 0
    for u in S:
        if any(v not in S for v in ix.succs[u]):
            cnt += 1
    return cnt


# ---------------------------------------------------------------------------
# shared group-feasibility rules (enumeration + the boundary-genome search)
# ---------------------------------------------------------------------------


class GroupChecker:
    """Incremental feasibility of one growing fused group under the paper's
    backtracking constraints: the SRAM inequality Σᵢ mᵢ,c / T ≤ M_c
    (``repro.core.memory.tile_working_set``), intra-core tiling
    compatibility, the op-type budget (≤ max_conv conv, ≤ max_gemm GEMM) and
    the length cap.  Feeds :func:`greedy_sram_partition` and the
    boundary-genome decoder of ``repro.core.fusion_search`` (see
    docs/fusion_search.md); the BFS candidate enumeration above keeps its
    own inline copy of the same constraints on its hot path — keep the two
    in sync when changing a rule.

    A group is grown through an opaque *state* — ``new_state()`` →
    ``try_add(state, node) -> state | None`` — so callers pay O(1) per
    grow decision instead of re-checking the whole group.

    ``enforce_single_output`` is deliberately *not* part of the rule set:
    on a training graph nearly every forward tensor escapes to a backward
    consumer, so the inference-style spill filter would forbid all fusion.
    """

    def __init__(self, g: WorkloadGraph, hda: HDASpec,
                 cfg: FusionConfig | None = None):
        self.g = g
        self.cfg = cfg or FusionConfig()
        self.cap = local_capacity(hda)
        sigs = graph_sigs(g)
        self.tiling = sigs.tiling          # node -> tiling factor
        self.nbytes = sigs.io_bytes        # node -> unique in+out bytes

    def isolated(self, name: str) -> bool:
        """Collectives / DMA transfers run on their own resource (ici /
        dma) and never fuse with compute — always singleton groups."""
        return self.g.nodes[name].op_class in ("comm", "dma")

    def new_state(self) -> tuple:
        # (member names, (conv, gemm) counts, tiling factors > 1)
        return ((), (0, 0), ())

    def try_add(self, state: tuple, name: str):
        """State with ``name`` appended, or ``None`` if the grown group
        violates any constraint (the caller then cuts before ``name``).
        Only the isolation rule applies to an empty state: a singleton is
        always feasible (like the solver's singleton candidates), even
        under degenerate configs such as ``max_conv=0``/``max_len=0``."""
        members, counts, ts = state
        if self.isolated(name) or (members and self.isolated(members[-1])):
            return None
        cfg = self.cfg
        nd = self.g.nodes[name]
        counts = _add_counts(counts, nd)
        t = self.tiling[name]
        if members:
            if len(members) >= cfg.max_len:
                return None
            if counts[0] > cfg.max_conv or counts[1] > cfg.max_gemm:
                return None
            if cfg.enforce_tiling and t > 1 and \
                    any(a % t and t % a for a in ts):
                return None
        members = members + (name,)
        if cfg.enforce_memory and len(members) > 1:
            ws = tile_working_set((self.nbytes[m] for m in members),
                                  (self.tiling[m] for m in members))
            if ws > self.cap:
                return None
        return (members, counts, ts + ((t,) if t > 1 else ()))

    def feasible(self, group) -> bool:
        """Whole-group check (non-incremental callers / tests)."""
        group = list(group)
        if len(group) == 1:
            return True
        state = self.new_state()
        for n in group:
            state = self.try_add(state, n)
            if state is None:
                return False
        return True


def greedy_sram_partition(g: WorkloadGraph, hda: HDASpec,
                          cfg: FusionConfig | None = None,
                          checker: GroupChecker | None = None) -> list[tuple]:
    """Greedy SRAM-feasible growth along the topo order: extend the current
    group while every :class:`GroupChecker` constraint holds, cut otherwise.
    Groups are contiguous runs of the topo order, so the quotient is acyclic
    by construction (every edge points forward).  This is the seed
    individual of the fusion-configuration search
    (``repro.core.fusion_search``) and a cheap HDA-aware baseline on its
    own."""
    checker = checker or GroupChecker(g, hda, cfg)
    part: list[tuple] = []
    state = checker.new_state()
    for n in g.topo_order():
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
        state = grown                     # a singleton is always feasible
    if state[0]:
        part.append(state[0])
    return part


# ---------------------------------------------------------------------------
# exact-cover IP:  min Σ x_g   s.t.   Σ_{g∋i} x_g = 1  ∀i
# ---------------------------------------------------------------------------


class _DPOverflow(Exception):
    """Raised when the exact-cover DP exceeds its state or time budget."""


def _solve_cover_dp(n_nodes: int, cands: list[tuple], idx_of: dict,
                    time_limit_s: float, max_states: int) -> list[tuple]:
    """Memoized exact cover:  dp(i, covered) = minimum number of candidates
    partitioning nodes ``i..n`` given ``covered`` (all indices < i covered).
    Key insight: a candidate usable at the first-uncovered index ``i`` must
    *contain* i and be disjoint from ``covered``, hence its minimum index is
    exactly ``i`` — so candidates bucket by their minimum index and the memo
    key is ``(i, covered >> i)`` (an arbitrary-precision bitmask, cheap at
    these sizes).  Deterministic: ties keep the earliest candidate in the
    enumeration's canonical (-len, lexicographic) order."""
    masks: list[int] = []
    by_min: list[list[tuple]] = [[] for _ in range(n_nodes)]
    for si, c in enumerate(cands):
        s = sorted(idx_of[x] for x in c)
        m = 0
        for i in s:
            m |= 1 << i
        masks.append(m)
        by_min[s[0]].append((m, si))
    deadline = time.monotonic() + time_limit_s
    # memo[i]: ahead-bitmask (covered >> i) -> (count, chosen si)
    memo: list[dict] = [{} for _ in range(n_nodes)]
    inf = n_nodes + 1
    ticks = 0
    n_states = 0

    def dp(i: int, covered: int) -> int:
        nonlocal ticks, n_states
        while (covered >> i) & 1:
            i += 1
        if i >= n_nodes:
            return 0
        mi = memo[i]
        ahead = covered >> i
        hit = mi.get(ahead)
        if hit is not None:
            return hit[0]
        ticks += 1
        if not ticks & 0x3FF and (time.monotonic() > deadline
                                  or n_states > max_states):
            raise _DPOverflow
        best_cnt, best_si = inf, -1
        for m, si in by_min[i]:
            if m & covered:
                continue
            cnt = dp(i + 1, covered | m) + 1
            if cnt < best_cnt:
                best_cnt, best_si = cnt, si
        mi[ahead] = (best_cnt, best_si)
        n_states += 1
        return best_cnt

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, n_nodes + 200))
    try:
        if dp(0, 0) > n_nodes:
            raise _DPOverflow    # no cover (unreachable: singletons exist)
    finally:
        sys.setrecursionlimit(old_limit)
    # reconstruct the optimal cover by replaying the memoized choices
    out: list[tuple] = []
    i, covered = 0, 0
    while True:
        while (covered >> i) & 1:
            i += 1
        if i >= n_nodes:
            break
        si = memo[i][covered >> i][1]
        out.append(cands[si])
        covered |= masks[si]
    return out


def solve_cover(n_nodes: int, cands: list[tuple], idx_of: dict,
                time_limit_s: float = 10.0,
                max_states: int = 500_000) -> list[tuple]:
    """Minimum-cardinality exact cover.  ``cands`` are tuples of node names;
    returns a partition.  The memoized DP (:func:`_solve_cover_dp`) proves
    optimality fast on real fusion instances; if it exceeds its state cap or
    half the time budget, the legacy branch-and-bound with a greedy
    incumbent finishes the job within the remaining budget."""
    start = time.monotonic()
    if n_nodes <= 2000:
        try:
            return _solve_cover_dp(n_nodes, cands, _cluster_index(cands, idx_of),
                                   time_limit_s * 0.5, max_states)
        except _DPOverflow:
            pass
    remaining = max(0.05, time_limit_s - (time.monotonic() - start))
    return _solve_cover_bnb(n_nodes, cands, idx_of, remaining)


def _cluster_index(cands: list[tuple], idx_of: dict) -> dict:
    """Re-index nodes so candidate members sit contiguously where possible.
    The cover itself is index-independent — only the DP's state space cares,
    and its ahead-bitmasks feed on span locality: a candidate pairing an
    early producer with a late consumer (weight transposes, recompute
    clones) would otherwise thread a covered-ahead bit through hundreds of
    intermediate states.  Greedy first-come placement in candidate order
    (earliest original member, largest first) keeps it deterministic."""
    order = sorted(
        range(len(cands)),
        key=lambda si: (min(idx_of[x] for x in cands[si]),
                        -len(cands[si]), cands[si]))
    new_idx: dict = {}
    for si in order:
        for x in sorted(cands[si], key=idx_of.__getitem__):
            if x not in new_idx:
                new_idx[x] = len(new_idx)
    for x in idx_of:                     # nodes outside every candidate
        if x not in new_idx:
            new_idx[x] = len(new_idx)
    return new_idx


def _solve_cover_bnb(n_nodes: int, cands: list[tuple], idx_of: dict,
                     time_limit_s: float = 10.0) -> list[tuple]:
    """Branch-and-bound minimum-cardinality exact cover with a greedy
    incumbent.  ``cands`` are tuples of node names; returns a partition."""
    sets = [frozenset(idx_of[x] for x in c) for c in cands]
    by_node: dict[int, list[int]] = {i: [] for i in range(n_nodes)}
    for si, s in enumerate(sets):
        for i in s:
            by_node[i].append(si)
    # candidates covering each node, largest first
    for i in by_node:
        by_node[i].sort(key=lambda si: -len(sets[si]))

    # greedy incumbent
    def greedy() -> list[int]:
        covered: set[int] = set()
        sol = []
        for i in range(n_nodes):
            if i in covered:
                continue
            for si in by_node[i]:
                if sets[si].isdisjoint(covered):
                    sol.append(si)
                    covered |= sets[si]
                    break
        return sol

    best = greedy()
    best_len = len(best)
    max_size = max((len(s) for s in sets), default=1)
    deadline = time.monotonic() + time_limit_s

    sol_stack: list[int] = []

    def bnb(first_uncovered: int, covered: frozenset, depth: int):
        nonlocal best, best_len
        if time.monotonic() > deadline:
            return
        while first_uncovered < n_nodes and first_uncovered in covered:
            first_uncovered += 1
        if first_uncovered >= n_nodes:
            if depth < best_len:
                best, best_len = list(sol_stack), depth
            return
        remaining = n_nodes - len(covered)
        if depth + math.ceil(remaining / max_size) >= best_len:
            return
        for si in by_node[first_uncovered]:
            if not sets[si].isdisjoint(covered):
                continue
            sol_stack.append(si)
            bnb(first_uncovered + 1, covered | sets[si], depth + 1)
            sol_stack.pop()

    if n_nodes <= 2000:
        bnb(0, frozenset(), 0)
    return [cands[si] for si in best]


def tarjan_sccs(n: int, succ: list) -> list:
    """Iterative Tarjan strongly-connected components over an integer graph
    (``succ[i]`` iterable of successor indices).  Stdlib-only — this sits on
    the GA hot path, so no networkx import (kept solely as an optional
    cross-check in the tests)."""
    index = [-1] * n
    low = [0] * n
    on_stack = [False] * n
    stack: list[int] = []
    sccs: list[list[int]] = []
    counter = 0
    for root in range(n):
        if index[root] != -1:
            continue
        work = [(root, iter(succ[root]))]
        index[root] = low[root] = counter
        counter += 1
        stack.append(root)
        on_stack[root] = True
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if index[w] == -1:
                    index[w] = low[w] = counter
                    counter += 1
                    stack.append(w)
                    on_stack[w] = True
                    work.append((w, iter(succ[w])))
                    advanced = True
                    break
                if on_stack[w]:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                low[work[-1][0]] = min(low[work[-1][0]], low[v])
            if low[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack[w] = False
                    comp.append(w)
                    if w == v:
                        break
                sccs.append(comp)
    return sccs


def repair_partition(g: WorkloadGraph, partition: list,
                     return_quotient: bool = False):
    """Individually-convex subgraphs can still form *mutual* cycles in the
    quotient (A→B and B→A through disjoint diamonds).  Break any strongly
    connected quotient component by splitting its largest part into
    singletons until the quotient is a DAG.

    With ``return_quotient=True`` also returns the final (acyclic) quotient
    successor sets, so ``schedule(..., quotient=...)`` need not rebuild them.
    """
    partition = [tuple(sg) for sg in partition]
    _, succs = g.adjacency()
    while True:
        sg_of = {n: i for i, sg in enumerate(partition) for n in sg}
        qsucc: list = [set() for _ in partition]
        for n in g.nodes:
            a = sg_of[n]
            for s in succs[n]:
                b = sg_of[s]
                if a != b:
                    qsucc[a].add(b)
        # cheap Kahn pass first: quotients are almost always already acyclic,
        # so only run the full SCC decomposition when a cycle actually exists
        nq = len(partition)
        indeg = [0] * nq
        for bs in qsucc:
            for b in bs:
                indeg[b] += 1
        stack = [i for i in range(nq) if indeg[i] == 0]
        seen = 0
        while stack:
            x = stack.pop()
            seen += 1
            for y in qsucc[x]:
                indeg[y] -= 1
                if indeg[y] == 0:
                    stack.append(y)
        if seen == nq:
            return (partition, qsucc) if return_quotient else partition
        sccs = [c for c in tarjan_sccs(nq, qsucc) if len(c) > 1]
        worst = max(sccs, key=len)
        victim = max(worst, key=lambda i: len(partition[i]))
        new = [sg for i, sg in enumerate(partition) if i != victim]
        new.extend((n,) for n in partition[victim])
        partition = new


def solve_fusion(g: WorkloadGraph, hda: HDASpec,
                 cfg: FusionConfig | None = None) -> list[tuple]:
    """Full pipeline: enumerate candidates, solve the exact-cover IP, and
    repair any quotient cycles.  Returns a partition (list of node-name
    tuples) covering every node exactly once."""
    cfg = cfg or FusionConfig()
    cands = enumerate_candidates(g, hda, cfg)
    idx_of = {n: i for i, n in enumerate(g.topo_order())}
    part = solve_cover(len(idx_of), cands, idx_of,
                       time_limit_s=cfg.time_limit_s)
    return repair_partition(g, part)


# ---------------------------------------------------------------------------
# baselines
# ---------------------------------------------------------------------------


def layer_by_layer(g: WorkloadGraph) -> list[tuple]:
    return [(n,) for n in g.topo_order()]


def manual_fusion(g: WorkloadGraph) -> list[tuple]:
    """The classic hand-designed pattern: a conv/GEMM absorbs its following
    chain of element-wise ops (norm → act → add), mimicking the paper's
    manually designed Stream configuration."""
    order = g.topo_order()
    preds_of, succs_of = g.adjacency()
    taken: set[str] = set()
    part: list[tuple] = []
    for n in order:
        if n in taken:
            continue
        nd = g.nodes[n]
        grp = [n]
        taken.add(n)
        if nd.op_class in ("conv", "gemm"):
            cur = n
            while True:
                succs = [s for s in succs_of[cur] if s not in taken]
                if len(succs) != 1:
                    break
                s = succs[0]
                snd = g.nodes[s]
                if snd.op_class not in ("simd",) or \
                        any(p not in taken and p != cur and
                            g.nodes[p].kind not in () for p in
                            preds_of[s] if p not in taken):
                    break
                # only absorb if all preds already placed (convexity-safe)
                if not all(p in taken or p == cur for p in preds_of[s]):
                    break
                grp.append(s)
                taken.add(s)
                cur = s
                if len(grp) >= 4:
                    break
        part.append(tuple(grp))
    return part
