"""Batched population evaluation over the engine's SoA signature tables.

The NSGA-II population loops (``checkpointing.ga_checkpointing`` /
``ga_policy``) spend their time rebuilding near-identical rewritten graphs:
every genome pays a full ``WorkloadGraph.copy()`` + ``validate()`` +
re-partition + plan build before the engine's content-keyed caches can even
be consulted.  :class:`PopulationEvaluator` removes that per-genome graph
materialization entirely: the base training graph is lowered **once** into
flat integer arrays (tensor bytes, producer ids, unique-predecessor edges,
per-read consumer edges, node signature ids, structural depths), and each
phenotype — the rewritten graph a KEEP/RECOMPUTE/OFFLOAD assignment induces
— is then *simulated* on those arrays:

* the recompute-closure clone construction mirrors
  ``checkpointing.apply_checkpointing`` (same ``sorted(discard)`` order,
  same shared-clone recursion), but allocates ints instead of graph nodes;
* OFFLOAD genes are lowered the same way: ``memory.apply_offload``'s DMA
  splicing (an ``offload`` node draining the activation to a 1-byte
  residency marker, a ``fetch`` node re-materializing it for every late
  consumer) becomes two integer node ids per offloaded activation, costed
  through the exact engine cache chain (``engine.dma_group_cost``) and
  carried into the lifetime arrays as fetched-tensor residency windows
  (``fetch_idx`` + ``spill_bytes`` on the :class:`LifetimePlan`);
* everything downstream is patched incrementally: only the *touched halo*
  (rewired late consumers, recompute clones, spliced DMA nodes, producers
  of tensors whose consumer sets changed) gets fresh adjacency — the rest
  of the graph reuses the base arrays through copy-on-write masks;
* the canonical topo order falls out of the structural depths: without DMA
  splices a recompute clone has exactly its source node's depth, so one
  stable argsort suffices; a splice lengthens paths through the fetch, so
  the exact longest-path depths are re-derived over the patched adjacency
  (same Kahn pass ``WorkloadGraph.topo_order`` uses);
* group costing is **cross-phenotype batched**: a phenotype simulation only
  *collects* group-cost requests; ``score_keep_batch`` /
  ``score_policy_batch`` then resolve every request of the whole population
  in one pass over the engine's SoA signature tables
  (``BoundEngine.subgraph_cost_many``) — untouched groups, touched groups
  (content-keyed in the shared ``_sg`` cache) and DMA singletons alike, so
  signatures are **never** re-signed and identical groups across phenotypes
  are costed once;
* the manual-fusion walk, quotient acyclicity check, lifetime arrays and
  list schedule replicate the scalar pipeline operation-for-operation, so
  the objectives are **bit-for-bit** those of the scalar oracle (enforced
  by ``tests/test_engine_batch.py`` and the Hypothesis property suite).

The scalar oracle still runs whenever exactness cannot be replayed on the
array view, and every fallback is counted per reason in ``stats``
(``scalar_offload`` / ``scalar_cyclic`` / ``scalar_fusion`` /
``scalar_rc`` / ``scalar_sanitize`` / ``scalar_baseline``) so a hot path
silently degrading to the oracle is observable — no silent caps
(``scalar_share`` is guarded by ``scripts/check_bench_regression.py``).
Fallback reasons: non-``manual`` fusion modes, a cyclic manual quotient
(``repair_partition`` would split it), base graphs already carrying ``.rc``
/ DMA namespaces, the deliberate baseline seeding, and always under
``REPRO_SANITIZE`` so the sanitizer's shadow-verification contract is
preserved.  See docs/engine.md (batched evaluation).

The port's own copy of ``repro.core.batch`` (numpy and plain Python):
names, signatures and numeric code are the reference's, held bit for
bit against it by ``tests/test_torch_checkpointing.py``.
"""

from __future__ import annotations

import numpy as np

from .cost_model import subgraph_tail
from .engine import dma_group_cost, get_engine, graph_sigs
from .graph import dtype_bytes
from .memory import ACTIVATIONS, MEM_CATEGORIES, WORKSPACE, \
    ActivationPolicy, LifetimePlan, lifetime_profile
from .training_transform import BWD_KINDS, TrainingGraph

_ACT_CODE = MEM_CATEGORIES.index(ACTIVATIONS)
_WS_CODE = MEM_CATEGORIES.index(WORKSPACE)
_EMPTY_I64 = np.asarray([], dtype=np.int64)
_EMPTY_FS: frozenset = frozenset()
_REC = int(ActivationPolicy.RECOMPUTE)
_OFF = int(ActivationPolicy.OFFLOAD)


class _ScalarFallback(Exception):
    """Raised when a phenotype needs the scalar oracle (cyclic quotient)."""


class _Pending:
    """One simulated phenotype awaiting batched cost resolution: the
    schedule structure (quotient successors / priorities / indegrees), the
    lifetime arrays and the ordered group-cost requests."""

    __slots__ = ("NG", "succ_lists", "prio", "indeg", "mem", "reqs")

    def __init__(self, NG, succ_lists, prio, indeg, mem, reqs):
        self.NG = NG
        self.succ_lists = succ_lists
        self.prio = prio
        self.indeg = indeg
        self.mem = mem
        self.reqs = reqs


class PopulationEvaluator:
    """Batched scorer for KEEP/RECOMPUTE/OFFLOAD phenotypes of one training
    graph.

    ``score_keep`` / ``score_keep_batch`` evaluate boolean keep-masks
    (``ga_checkpointing`` objectives: latency, energy, stored activation
    bytes); ``score_policy`` / ``score_policy_batch`` evaluate ternary
    :class:`~repro.core.memory.ActivationPolicy` genomes (``ga_policy``
    objectives: latency, energy, peak memory).  Results are bit-for-bit
    identical to the scalar pipeline.  Identical phenotypes are deduped on
    their (recompute set, offload set), so a population full of duplicate
    genomes is scored once; the batch entry points additionally resolve all
    group costs of a population in one cross-phenotype pass (``stats``
    counts soa / scalar / dedup-hit evaluations, with per-reason scalar
    counters)."""

    def __init__(self, tg: TrainingGraph, hda, engine=None,
                 fusion: str = "manual"):
        self.tg = tg
        self.hda = hda
        self.engine = engine if engine is not None else get_engine(hda)
        self.fusion = fusion
        self.acts = list(tg.activations)
        self.act_bytes = [tg.graph.tensors[a].bytes for a in self.acts]
        g = tg.graph
        # ``.rc`` names are reserved by the rewrite; a base graph already
        # using them would collide with the clone namespace — oracle only
        self.supported = (fusion == "manual"
                          and not any(t.endswith(".rc") for t in g.tensors)
                          and not any(n.endswith(".rc") for n in g.nodes))
        # the OFFLOAD lowering additionally reserves the DMA namespace
        # (``.off`` / ``.fetch`` tensors, ``dma``-class or ``recompute``
        # nodes in the *base* graph would alias the splice serials)
        self.supported_off = (
            self.supported
            and not any(nd.op_class == "dma" or nd.kind == "recompute"
                        for nd in g.nodes.values())
            and not any(t.endswith((".off", ".fetch")) for t in g.tensors))
        self._cache: dict[tuple, tuple] = {}   # (rec, off) -> (lat, en, peak)
        self.stats = dict(soa=0, scalar=0, hits=0, scalar_offload=0,
                          scalar_cyclic=0, scalar_fusion=0, scalar_rc=0,
                          scalar_sanitize=0, scalar_baseline=0)
        self._unsupported_reason = "fusion" if fusion != "manual" else "rc"
        self._ready = False

    # -- population surfaces ------------------------------------------------

    def _keep_key(self, mask) -> tuple:
        rec = frozenset(i for i in range(len(self.acts)) if not mask[i])
        return (rec, _EMPTY_FS)

    def _policy_key(self, genome) -> tuple:
        rec = []
        off = []
        for i, p in enumerate(genome):
            v = int(p)
            if v == _REC:
                rec.append(i)
            elif v == _OFF:
                off.append(i)
        return (frozenset(rec), frozenset(off))

    def _stored(self, mask) -> float:
        stored = 0
        for i, b in enumerate(self.act_bytes):
            if mask[i]:
                stored += b
        return float(stored)

    def score_keep(self, mask) -> tuple:
        """Objectives of one keep-mask: (latency, energy, stored bytes)."""
        lat, en, _peak = self._eval_batch([self._keep_key(mask)])[0]
        return (lat, en, self._stored(mask))

    def score_keep_batch(self, masks) -> list:
        outs = self._eval_batch([self._keep_key(m) for m in masks])
        return [(lat, en, self._stored(m))
                for m, (lat, en, _peak) in zip(masks, outs, strict=True)]

    def score_policy(self, genome) -> tuple:
        """Objectives of one ternary genome: (latency, energy, peak mem)."""
        lat, en, peak = self._eval_batch([self._policy_key(genome)])[0]
        return (lat, en, float(peak))

    def score_policy_batch(self, genomes) -> list:
        outs = self._eval_batch([self._policy_key(g) for g in genomes])
        return [(lat, en, float(peak)) for (lat, en, peak) in outs]

    def scalar_share(self) -> float:
        """Share of evaluated (non-memoized) phenotypes that fell back to
        the scalar oracle, excluding the deliberate baseline seeding and the
        sanitizer's forced-scalar runs.  The fallback-observability metric:
        a hot path silently running >10% scalar is a regression, not a cap
        (guarded by ``scripts/check_bench_regression.py``)."""
        sc = (self.stats["scalar"] - self.stats["scalar_baseline"]
              - self.stats["scalar_sanitize"])
        tot = self.stats["soa"] + sc
        return sc / tot if tot else 0.0

    # -- phenotype dedup + dispatch -----------------------------------------

    def _eval_batch(self, keys: list) -> list:
        """Score ``(rec-set, off-set)`` phenotype keys: memo + in-batch
        dedup, then one simulation per unique key with cross-phenotype
        batched cost resolution.  Scalar-oracle fallbacks are counted per
        reason."""
        from .verify import sanitize_enabled
        if sanitize_enabled():
            # never serve (or populate) memoized phenotypes under the
            # sanitizer: every evaluation must flow through the scalar
            # pipeline so shadow verification sees the real rewrite
            return [self._scalar_pol(rec, off, "sanitize")
                    for (rec, off) in keys]
        results: list = [None] * len(keys)
        first: dict = {}
        dups: list = []
        todo: list = []
        for i, k in enumerate(keys):
            hit = self._cache.get(k)
            if hit is not None:
                self.stats["hits"] += 1
                results[i] = hit
                continue
            j = first.get(k)
            if j is not None:
                self.stats["hits"] += 1
                dups.append((i, j))
                continue
            first[k] = i
            todo.append(i)
        pendings: list = []
        for i in todo:
            rec, off = keys[i]
            if not self.supported:
                out = self._scalar_pol(rec, off, self._unsupported_reason)
            elif not rec and not off:
                # the empty rewrite goes through the oracle on purpose: it
                # seeds the engine's schedule memo with the baseline
                # fingerprint
                out = self._scalar_pol(rec, off, "baseline")
            elif off and not self.supported_off:
                out = self._scalar_pol(rec, off, "offload")
            else:
                if not self._ready:
                    self._prepare()
                try:
                    pend = self._simulate(rec, off)
                except (_ScalarFallback, RecursionError):
                    out = self._scalar_pol(rec, off, "cyclic")
                else:
                    if pend is None:
                        # the rewrite was the identity: content-equal to
                        # the baseline phenotype
                        out = self._eval_batch([(_EMPTY_FS, _EMPTY_FS)])[0]
                        self.stats["soa"] += 1
                    else:
                        pendings.append((i, pend))
                        continue
            self._cache[keys[i]] = out
            results[i] = out
        if pendings:
            # cross-phenotype batched costing: every group-cost lookup of
            # the whole population resolves in one pass over the engine's
            # SoA signature tables
            self._resolve([p for (_i, p) in pendings])
            for i, pend in pendings:
                out = self._finish(pend)
                self.stats["soa"] += 1
                self._cache[keys[i]] = out
                results[i] = out
        for i, j in dups:
            results[i] = results[j]
        return results

    # -- scalar oracle -------------------------------------------------------

    def _scalar_pol(self, rec: frozenset, off: frozenset,
                    reason: str) -> tuple:
        self.stats["scalar"] += 1
        self.stats["scalar_" + reason] += 1
        if off:
            from .checkpointing import evaluate_policy
            pol = {}
            for i, a in enumerate(self.acts):
                if i in rec:
                    pol[a] = ActivationPolicy.RECOMPUTE
                elif i in off:
                    pol[a] = ActivationPolicy.OFFLOAD
                else:
                    pol[a] = ActivationPolicy.KEEP
            s = evaluate_policy(self.tg, self.hda, pol, self.fusion,
                                engine=self.engine)
            return (s.latency, s.energy, s.peak_mem)
        from .checkpointing import _fusion_partition, apply_checkpointing
        from .scheduling import schedule
        if rec:
            keep = {a for i, a in enumerate(self.acts) if i not in rec}
            g2 = apply_checkpointing(self.tg, keep)
        else:
            # the empty rewrite is the identity: schedule the base graph
            # directly (content-identical fingerprint, bit-for-bit result)
            g2 = self.tg.graph
        part, quotient = _fusion_partition(g2, self.hda, self.fusion, None,
                                           self.engine)
        res = schedule(g2, self.hda, part, engine=self.engine,
                       quotient=quotient)
        return (res.latency, res.energy, res.peak_mem)

    # -- base-graph lowering (once) -----------------------------------------

    def _prepare(self) -> None:
        g = self.tg.graph
        eng = self.engine
        graph_sigs(g)
        g.topo_order()
        self.bound = eng.bind(g)
        sigs = self.bound.sigs
        names = list(g.nodes)
        self.names = names
        N = len(names)
        self.N = N
        nid = {n: i for i, n in enumerate(names)}
        tnames = list(g.tensors)
        T = len(tnames)
        self.T = T
        tid = {t: i for i, t in enumerate(tnames)}
        tensors = g.tensors
        tb = sigs.tb
        self.tbytes = [tb[t] if t in tb else tensors[t].bytes
                       for t in tnames]
        self.tby_np = np.asarray(self.tbytes, dtype=np.int64)
        prod = [-1] * T
        for t, p in g.producer.items():
            prod[tid[t]] = nid[p]
        self.prod = prod
        node_objs = [g.nodes[n] for n in names]
        self.node_objs = node_objs
        self.ins_l = [[tid[t] for t in nd.inputs] for nd in node_objs]
        self.outs_l = [[tid[t] for t in nd.outputs] for nd in node_objs]
        cls_l = [nd.op_class for nd in node_objs]
        self.is_cg = [c in ("conv", "gemm") for c in cls_l]
        self.is_simd = [c == "simd" for c in cls_l]
        bwd = [nd.kind in BWD_KINDS for nd in node_objs]
        cons: list = [[] for _ in range(T)]     # per-read consumer lists
        for v, ins in enumerate(self.ins_l):
            for t in ins:
                cons[t].append(v)
        cons_u: list = []                       # unique, order-free use
        for cs in cons:
            seen: set = set()
            u: list = []
            for c in cs:
                if c not in seen:
                    seen.add(c)
                    u.append(c)
            cons_u.append(u)
        self.base_cons_u = cons_u
        self.static_f = [tensors[t].is_param or tensors[t].is_state
                         or tensors[t].is_input for t in tnames]
        # unique pred/succ adjacency + canonical structural depths
        preds_u: list = []
        succs_u: list = [[] for _ in range(N)]
        for v, ins in enumerate(self.ins_l):
            seen = set()
            ps: list = []
            for t in ins:
                p = prod[t]
                if p >= 0 and p not in seen:
                    seen.add(p)
                    ps.append(p)
            preds_u.append(ps)
            for p in ps:
                succs_u[p].append(v)
        self.base_preds = preds_u
        self.base_succs = succs_u
        depth = [0] * N
        indeg = [len(ps) for ps in preds_u]
        stack = [v for v in range(N) if indeg[v] == 0]
        n_out = 0
        while stack:
            v = stack.pop()
            n_out += 1
            d = depth[v] + 1
            for s in succs_u[v]:
                if depth[s] < d:
                    depth[s] = d
                indeg[s] -= 1
                if indeg[s] == 0:
                    stack.append(s)
        assert n_out == N, "base graph must be acyclic"
        self.depth_np = np.asarray(depth, dtype=np.int64)
        # flat edge arrays: unique-pred edges and per-read consumer edges
        self.bEp = np.asarray([p for ps in preds_u for p in ps],
                              dtype=np.int64)
        self.bEv = np.asarray([v for v, ps in enumerate(preds_u)
                               for _ in ps], dtype=np.int64)
        self.brT = np.asarray([t for ins in self.ins_l for t in ins],
                              dtype=np.int64)
        self.brN = np.asarray([v for v, ins in enumerate(self.ins_l)
                               for _ in ins], dtype=np.int64)
        prod_np = np.asarray(prod, dtype=np.int64)
        self.pflag = prod_np >= 0
        self.produced0 = np.nonzero(self.pflag)[0]
        self.prod_nodes0 = prod_np[self.produced0]
        self.nbytes0 = self.tby_np[self.produced0]
        # activations
        self.act_tid = [tid[a] for a in self.acts]
        self.act_sorted = sorted(range(len(self.acts)),
                                 key=self.acts.__getitem__)
        act_bwd = []
        for a in self.acts:
            seen = set()
            cs = []
            for c in cons[tid[a]]:
                if bwd[c] and c not in seen:
                    seen.add(c)
                    cs.append(c)
            act_bwd.append(cs)
        self.act_bwd = act_bwd
        # DMA payload shape per activation (``apply_offload`` comm dims)
        self.act_dims = [(tensors[a].size, dtype_bytes(tensors[a].dtype))
                         for a in self.acts]
        # engine-side per-node lookups
        self.sid = [sigs.sid[n] for n in names]
        self.core_name = [eng.core_for_class(c).name for c in cls_l]
        self.resource = [eng.resource_for_class(c) for c in cls_l]
        self.ckey = [eng.ckey_for_class(c) for c in cls_l]
        self.leak = self.hda.leak_per_cycle()
        self.static = sigs.static
        self.static_by_cat = dict(sigs.static_by_cat)
        cat = sigs.cat
        cat_np = np.asarray([cat.get(t, _ACT_CODE) for t in tnames],
                            dtype=np.int64)
        self.cats0 = cat_np[self.produced0]
        self._cost1: list = [None] * N       # per-node singleton cost
        self._grp_cache: dict = {}           # untouched fused group -> cost
        self._dma_cost: dict = {}            # act index -> (offload, fetch)
        self._ready = True

    # -- one phenotype on the array view ------------------------------------

    def _simulate(self, rec: frozenset, off: frozenset):
        """Simulate the rewrite (recompute clones + DMA splices) on the
        integer arrays and return a :class:`_Pending` with deferred
        group-cost requests — or ``None`` when the rewrite is the identity.
        Raises :class:`_ScalarFallback` on a cyclic manual quotient."""
        N = self.N
        T = self.T
        prod = self.prod
        ins_l = self.ins_l
        outs_l = self.outs_l
        static_f = self.static_f
        act_tid = self.act_tid
        kept_t = {act_tid[i] for i in range(len(self.acts)) if i not in rec}

        # ---- recompute-closure clone construction (apply_checkpointing) ---
        clone_of: dict = {}
        new_t_src: list = []           # new tensor (tid T+j) -> source tid
        new_t_prod: list = []          # new tensor -> producing node id
        clone_src: list = []           # clone node (nid N+c) -> source nid
        clone_ins: list = []
        clone_outs: list = []

        def rc(t: int) -> int:
            if static_f[t] or t in kept_t:
                return t
            c = clone_of.get(t)
            if c is not None:
                return c
            p = prod[t]
            if p < 0:
                clone_of[t] = t
                return t
            nin = [rc(x) for x in ins_l[p]]
            cn = N + len(clone_src)
            outs: list = []
            for o in outs_l[p]:
                co = T + len(new_t_src)
                clone_of[o] = co
                new_t_src.append(o)
                new_t_prod.append(cn)
                outs.append(co)
            clone_src.append(p)
            clone_ins.append(nin)
            clone_outs.append(outs)
            return clone_of[t]

        patched_ins: dict = {}
        changed_acts: list = []
        for i in self.act_sorted:       # == sorted(discard) by name
            if i not in rec:
                continue
            consb = self.act_bwd[i]
            if not consb:
                continue
            a = act_tid[i]
            r = rc(a)
            if r == a:
                continue
            changed_acts.append(a)
            for b in consb:
                cur = patched_ins.get(b)
                if cur is None:
                    cur = ins_l[b]
                patched_ins[b] = [r if t == a else t for t in cur]

        NC = len(clone_src)
        nt_c = len(new_t_src)

        # ---- DMA splicing (memory.apply_offload, after the clone phase) ---
        splices: list = []      # (act idx, a, off_v, fet_v, marker, fetched)
        if off:
            # late readers = base backward consumers + recompute clones
            # reading the (kept) activation — _LATE_KINDS on the rewrite
            clone_readers: dict = {}
            for c, nin in enumerate(clone_ins):
                seen_r: set = set()
                for t in nin:
                    if t < T and t not in seen_r:
                        seen_r.add(t)
                        clone_readers.setdefault(t, []).append(N + c)
            for i in self.act_sorted:   # == apply_offload's sorted order
                if i not in off:
                    continue
                a = act_tid[i]
                late = list(self.act_bwd[i])
                cl = clone_readers.get(a)
                if cl:
                    late.extend(cl)
                if not late:
                    continue            # nothing to rewire: splice skipped
                k = len(splices)
                off_v = N + NC + 2 * k
                fet_v = off_v + 1
                marker = T + nt_c + 2 * k
                fetched = marker + 1
                new_t_src.append(a)
                new_t_prod.append(off_v)
                new_t_src.append(a)
                new_t_prod.append(fet_v)
                for b in late:
                    if b < N:
                        cur = patched_ins.get(b)
                        if cur is None:
                            cur = ins_l[b]
                        patched_ins[b] = [fetched if t == a else t
                                          for t in cur]
                    else:
                        clone_ins[b - N] = [fetched if t == a else t
                                            for t in clone_ins[b - N]]
                splices.append((i, a, off_v, fet_v, marker, fetched))
        ns = len(splices)

        if not NC and not patched_ins and not ns:
            # the rewrite was the identity (no discarded activation had a
            # backward consumer, no offloaded one a late consumer)
            return None
        NT = N + NC + 2 * ns

        def prodof(t: int) -> int:
            return prod[t] if t < T else new_t_prod[t - T]

        # ---- incremental adjacency: patch rows for the touched halo -------
        patchT: list = []              # phenotype read-edge patches
        patchN: list = []
        added: dict = {}               # tensor -> set of new reader nids
        pred_over: dict = {}           # node -> unique pred list (override)
        pe: list = []                  # unique-pred edge patches
        pv: list = []

        def patch_reads(v: int, nin: list) -> None:
            seen: set = set()
            pl: list = []
            for t in nin:
                patchT.append(t)
                patchN.append(v)
                s = added.get(t)
                if s is None:
                    s = added[t] = set()
                s.add(v)
                p = prodof(t)
                if p >= 0 and p not in seen:
                    seen.add(p)
                    pl.append(p)
                    pe.append(p)
                    pv.append(v)
            pred_over[v] = pl

        for b, nin in patched_ins.items():
            patch_reads(b, nin)
        for c in range(NC):
            patch_reads(N + c, clone_ins[c])
        for (_i, a, off_v, fet_v, marker, fetched) in splices:
            patch_reads(off_v, [a])
            patch_reads(fet_v, [marker])

        rew_set = set(patched_ins)
        # base tensors whose consumer set changed: rewired activations lose
        # their late readers, clone/DMA-input tensors gain new readers
        changed = set(changed_acts)
        for t in added:
            if t < T:
                changed.add(t)

        # successor overrides: producers of changed tensors + all new nodes
        base_cons_u = self.base_cons_u

        def cons_u_of(o: int):
            if o >= T:
                return added.get(o, ())
            s = added.get(o)
            out = [c for c in base_cons_u[o] if c not in rew_set]
            if s:
                out.extend(s)
            return out

        succ_over: dict = {}
        affected: set = set()
        for t in changed:
            p = prod[t]
            if p >= 0:
                affected.add(p)
        for p in affected:
            su: set = set()
            for o in outs_l[p]:
                su.update(cons_u_of(o))
            succ_over[p] = list(su)
        for c in range(NC):
            su = set()
            for o in clone_outs[c]:
                su.update(cons_u_of(o))
            succ_over[N + c] = list(su)
        for (_i, a, off_v, fet_v, marker, fetched) in splices:
            succ_over[off_v] = list(cons_u_of(marker))    # == [fetch node]
            succ_over[fet_v] = list(cons_u_of(fetched))   # the late readers

        # ---- phenotype edge arrays (copy-on-write off the base) -----------
        flag = np.ones(N, dtype=bool)
        if rew_set:
            flag[list(rew_set)] = False
        keep_e = flag[self.bEv]
        Ep = np.concatenate([self.bEp[keep_e],
                             np.asarray(pe, dtype=np.int64)])
        Ev = np.concatenate([self.bEv[keep_e],
                             np.asarray(pv, dtype=np.int64)])
        keep_r = flag[self.brN]
        rT = np.concatenate([self.brT[keep_r],
                             np.asarray(patchT, dtype=np.int64)])
        rN = np.concatenate([self.brN[keep_r],
                             np.asarray(patchN, dtype=np.int64)])
        o_srt = np.argsort(rT, kind="stable")
        rTs = rT[o_srt]
        rNs = rN[o_srt]
        nt = len(new_t_src)
        pf = np.concatenate([self.pflag, np.ones(nt, dtype=bool)])
        mprod = pf[rTs]
        crT = rTs[mprod]               # reads of produced tensors, by tid
        crN = rNs[mprod]

        # ---- canonical topo order -----------------------------------------
        if not ns:
            # clones inherit their source's structural depth, so the
            # canonical (depth, serial) order is one stable argsort
            cs_np = np.asarray(clone_src, dtype=np.int64)
            depth_ext = np.concatenate([self.depth_np, self.depth_np[cs_np]])
        else:
            # a DMA splice lengthens every path through the fetch node, so
            # exact longest-path depths are re-derived over the patched
            # adjacency (same Kahn pass the base lowering used)
            base_preds = self.base_preds
            base_succs = self.base_succs
            depth_l = [0] * NT
            indeg2 = [0] * NT
            for v in range(NT):
                pl = pred_over.get(v)
                if pl is None:
                    pl = base_preds[v]
                indeg2[v] = len(pl)
            stack = [v for v in range(NT) if indeg2[v] == 0]
            n_out = 0
            while stack:
                v = stack.pop()
                n_out += 1
                d = depth_l[v] + 1
                sl = succ_over.get(v)
                if sl is None:
                    sl = base_succs[v]
                for s in sl:
                    if depth_l[s] < d:
                        depth_l[s] = d
                    indeg2[s] -= 1
                    if indeg2[s] == 0:
                        stack.append(s)
            if n_out != NT:
                raise _ScalarFallback  # defensive: patched view has a cycle
            depth_ext = np.asarray(depth_l, dtype=np.int64)
        order_l = np.argsort(depth_ext, kind="stable").tolist()

        # ---- manual-fusion walk (fusion.manual_fusion) --------------------
        is_cg = (self.is_cg + [self.is_cg[s] for s in clone_src]
                 + [False] * (2 * ns))
        is_simd = (self.is_simd + [self.is_simd[s] for s in clone_src]
                   + [False] * (2 * ns))
        base_succ = self.base_succs
        base_pred = self.base_preds
        sget = succ_over.get
        pget = pred_over.get
        taken = bytearray(NT)
        part: list = []
        prio: list = []
        sg_l = [0] * NT
        for i, v in enumerate(order_l):
            if taken[v]:
                continue
            gi = len(part)
            grp = [v]
            taken[v] = 1
            sg_l[v] = gi
            prio.append(i)
            if is_cg[v]:
                cur = v
                while True:
                    sl = sget(cur)
                    if sl is None:
                        sl = base_succ[cur]
                    nxt = -1
                    cnt = 0
                    for s in sl:
                        if not taken[s]:
                            cnt += 1
                            if cnt > 1:
                                break
                            nxt = s
                    if cnt != 1:
                        break
                    s = nxt
                    if not is_simd[s]:
                        break
                    pl = pget(s)
                    if pl is None:
                        pl = base_pred[s]
                    ok = True
                    for p in pl:
                        if not taken[p] and p != cur:
                            ok = False
                            break
                    if not ok:
                        break
                    grp.append(s)
                    taken[s] = 1
                    sg_l[s] = gi
                    cur = s
                    if len(grp) >= 4:
                        break
            part.append(grp)
        NG = len(part)
        sg_np = np.asarray(sg_l, dtype=np.int64)

        # just-in-time fetch priority (memory.schedule_priorities): a pure
        # DMA ``fetch`` subgraph inherits its consumers' priority so the
        # re-materialized activation arrives right before its late reader
        if ns:
            pos = np.empty(NT, dtype=np.int64)
            pos[np.asarray(order_l, dtype=np.int64)] = \
                np.arange(NT, dtype=np.int64)
            for (_i, a, off_v, fet_v, marker, fetched) in splices:
                readers = succ_over[fet_v]
                if readers:
                    jit = min(int(pos[c]) for c in readers)
                    gi = sg_l[fet_v]
                    if jit > prio[gi]:
                        prio[gi] = jit

        # ---- quotient DAG + acyclicity (repair_partition's cheap pass) ----
        gb = sg_np[Ep]
        ga = sg_np[Ev]
        m = gb != ga
        uk = np.unique(gb[m] * NG + ga[m])
        qb = uk // NG
        qa = uk % NG
        indeg_l = np.bincount(qa, minlength=NG).tolist()
        offs = np.zeros(NG + 1, dtype=np.int64)
        np.cumsum(np.bincount(qb, minlength=NG), out=offs[1:])
        qa_l = qa.tolist()
        offs_l = offs.tolist()
        succ_lists = [qa_l[offs_l[i]:offs_l[i + 1]] for i in range(NG)]
        ind2 = indeg_l.copy()
        stack = [i for i in range(NG) if ind2[i] == 0]
        seen_q = 0
        while stack:
            x = stack.pop()
            seen_q += 1
            for y in succ_lists[x]:
                ind2[y] -= 1
                if ind2[y] == 0:
                    stack.append(y)
        if seen_q != NG:
            raise _ScalarFallback      # repair_partition would split groups

        # ---- lifetime arrays (memory.build_lifetime_plan) -----------------
        if nt:
            Pt = np.concatenate([self.produced0,
                                 np.arange(T, T + nt, dtype=np.int64)])
            prod_nodes = np.concatenate([
                self.prod_nodes0, np.asarray(new_t_prod, dtype=np.int64)])
            nbytes = np.concatenate([
                self.nbytes0,
                self.tby_np[np.asarray(new_t_src[:nt_c], dtype=np.int64)],
                np.asarray([1 if j % 2 == 0 else self.tbytes[sp[1]]
                            for sp in splices for j in range(2)],
                           dtype=np.int64)])
            cats = np.concatenate([
                self.cats0, np.full(nt_c, _ACT_CODE, dtype=np.int64),
                np.full(2 * ns, _WS_CODE, dtype=np.int64)])
        else:
            Pt = self.produced0
            prod_nodes = self.prod_nodes0
            nbytes = self.nbytes0
            cats = self.cats0
        prod_sg = sg_np[prod_nodes]
        lo = np.searchsorted(crT, Pt)
        hi = np.searchsorted(crT, Pt + 1)
        counts = hi - lo
        consg = sg_np[crN]
        z = counts == 0
        if z.any():                    # no consumers: freed at the prod step
            consg = np.insert(consg, lo[z], prod_sg[z])
            counts = np.where(z, 1, counts)
        cons_split = np.empty(len(counts), dtype=np.int64)
        cons_split[0] = 0
        np.cumsum(counts[:-1], out=cons_split[1:])
        nP0 = len(self.produced0)
        fetch_idx = (np.asarray([nP0 + nt_c + 2 * k + 1 for k in range(ns)],
                                dtype=np.int64) if ns else _EMPTY_I64)
        # both DMA transfers of a splice move the full payload off/on chip
        spill = sum(2 * self.tbytes[sp[1]] for sp in splices)
        mem = LifetimePlan(
            n_steps=NG,
            static=self.static,
            static_by_cat=dict(self.static_by_cat),
            prod_sg=prod_sg,
            nbytes=nbytes,
            cats=cats,
            cons_flat=consg,
            cons_split=cons_split,
            fetch_idx=fetch_idx,
            spill_bytes=spill,
        )

        # consumer-slice lookup for dirty-group costing (reads of tensor t
        # with multiplicity live at crN[lo[tindex[t]]:hi[tindex[t]]])
        tindex = np.empty(T + nt, dtype=np.int64)
        tindex[Pt] = np.arange(len(Pt), dtype=np.int64)

        # ---- deferred per-group cost requests -----------------------------
        touched = set(rew_set)
        for t in changed:
            p = prod[t]
            if p >= 0:
                touched.add(p)
        n_dma0 = N + NC
        reqs: list = []
        for grp in part:
            if len(grp) == 1:
                v = grp[0]
                if v >= n_dma0:        # spliced DMA transfer node
                    k = (v - n_dma0) // 2
                    reqs.append(("dma", splices[k][0], (v - n_dma0) % 2))
                else:
                    s = v if v < N else clone_src[v - N]
                    # a singleton's cost depends only on its zmask triple,
                    # which a clone shares with its source — node-level
                    # reuse regardless of rewiring
                    reqs.append(("c1", s))
            else:
                clean = True
                for v in grp:
                    if v >= N or v in touched:
                        clean = False
                        break
                if clean:
                    # untouched fused group ≡ the same subgraph of the
                    # base graph: cost through the base binding
                    reqs.append(("grp", tuple(grp)))
                else:
                    reqs.append(self._multi_key(
                        grp, clone_src, clone_ins, clone_outs, patched_ins,
                        prodof, tindex, lo, hi, crN, new_t_src))

        return _Pending(NG, succ_lists, prio, indeg_l, mem, reqs)

    # -- cross-phenotype cost resolution ------------------------------------

    def _dma_pair(self, i: int) -> tuple:
        """(offload, fetch) group costs of activation ``i``'s DMA splice,
        through the exact engine cache chain (``engine.dma_group_cost``)."""
        out = self._dma_cost.get(i)
        if out is None:
            size, eb = self.act_dims[i]
            out = self._dma_cost[i] = (
                dma_group_cost(self.engine, "offload", size, eb),
                dma_group_cost(self.engine, "fetch", size, eb))
        return out

    def _resolve(self, pendings: list) -> None:
        """Resolve every deferred group-cost request of ``pendings`` in one
        cross-phenotype pass: untouched groups through
        ``BoundEngine.subgraph_cost_many`` (one probe of the SoA signature
        tables for the whole population), touched groups deduped on their
        content key in the shared ``_sg`` cache, DMA singletons through the
        per-activation memo."""
        eng = self.engine
        bound = self.bound
        names = self.names
        cost1 = self._cost1
        gc = self._grp_cache
        need: list = []                 # name-tuples for subgraph_cost_many
        fill: list = []                 # parallel requests to fill back
        seen_c1: set = set()
        seen_grp: set = set()
        dma_need: set = set()
        m_first: dict = {}              # content key -> request
        m_extra: dict = {}              # content key -> duplicate count
        for p in pendings:
            for r in p.reqs:
                tag = r[0]
                if tag == "c1":
                    s = r[1]
                    if cost1[s] is None and s not in seen_c1:
                        seen_c1.add(s)
                        need.append((names[s],))
                        fill.append(r)
                elif tag == "grp":
                    k = r[1]
                    if k not in gc and k not in seen_grp:
                        seen_grp.add(k)
                        need.append(tuple(names[v] for v in k))
                        fill.append(r)
                elif tag == "dma":
                    if r[1] not in self._dma_cost:
                        dma_need.add(r[1])
                else:                   # touched multi-node group
                    k = r[1]
                    if k in m_first:
                        m_extra[k] = m_extra.get(k, 0) + 1
                    else:
                        m_first[k] = r
        if need:
            for r, c in zip(fill, bound.subgraph_cost_many(need),
                            strict=True):
                if r[0] == "c1":
                    cost1[r[1]] = c
                else:
                    gc[r[1]] = c
        for i in sorted(dma_need):
            self._dma_pair(i)
        sg = eng._sg
        stats = eng.stats
        for k, r in m_first.items():
            cached = sg.get(k)
            if cached is not None:
                stats["sg_hits"] += 1
            else:
                stats["sg_misses"] += 1
                sg[k] = self._multi_tail(r[2], r[3], r[4], r[5])
        for extra in m_extra.values():
            stats["sg_hits"] += extra

    def _finish(self, p: _Pending) -> tuple:
        """List-schedule + lifetime profile of one resolved phenotype
        (scheduling._assemble_fast on the array view)."""
        from .scheduling import MiniPlan, _finish_perm, _list_schedule
        sg = self.engine._sg
        cost1 = self._cost1
        gc = self._grp_cache
        dma = self._dma_cost
        costs: list = []
        for r in p.reqs:
            tag = r[0]
            if tag == "c1":
                costs.append(cost1[r[1]])
            elif tag == "grp":
                costs.append(gc[r[1]])
            elif tag == "dma":
                costs.append(dma[r[1]][r[2]])
            else:
                costs.append(sg[r[1]])
        makespan, busy, finish = _list_schedule(
            MiniPlan(p.NG, p.succ_lists, p.prio, p.indeg), costs)
        prof = lifetime_profile(p.mem, _finish_perm(finish))
        energy = sum(c.energy_pj for c in costs) + makespan * self.leak
        return (makespan, energy, prof.peak)

    # -- touched-group cost key ---------------------------------------------

    def _multi_key(self, grp, clone_src, clone_ins, clone_outs, patched_ins,
                   prodof, tindex, lo, hi, crN, new_t_src) -> tuple:
        """Content key + cost inputs of a fused group touched by the
        rewrite — ``BoundEngine.subgraph_cost``'s key construction on the
        phenotype's array view, using the base node objects (clone
        signatures equal their source's, so keys, cycles and byte sums are
        identical — docs/engine.md).  The actual cost is resolved in the
        batched ``_resolve`` pass, deduped across phenotypes."""
        N = self.N
        T = self.T
        sid = self.sid
        core_name = self.core_name
        tbytes = self.tbytes
        ins_l = self.ins_l
        outs_l = self.outs_l
        nodeset = set(grp)
        srcs = tuple(v if v < N else clone_src[v - N] for v in grp)
        g_ins = [patched_ins.get(v, ins_l[v]) if v < N
                 else clone_ins[v - N] for v in grp]
        g_outs = [outs_l[v] if v < N else clone_outs[v - N] for v in grp]
        internal: set = set()
        cons_of: dict = {}
        for outs in g_outs:
            for t in outs:
                ix = tindex[t]
                cs = crN[lo[ix]:hi[ix]]
                if cs.size:
                    inside = True
                    for c in cs:
                        if c not in nodeset:
                            inside = False
                            break
                    if inside:
                        internal.add(t)
                        cons_of[t] = cs
        triples: list = []
        resident: set = set()
        for ins, outs, s in zip(g_ins, g_outs, srcs, strict=True):
            rmask = tuple((t in resident or t in internal) for t in ins)
            imask = tuple((t in internal) for t in outs)
            triples.append((sid[s], rmask, imask))
            resident.update(outs)
        link = 0.0
        internal_bytes = 0
        for t in internal:
            tb = tbytes[t] if t < T else tbytes[new_t_src[t - T]]
            internal_bytes += tb
            p = prodof(t)
            pc = core_name[p if p < N else clone_src[p - N]]
            for c in cons_of[t]:
                cc = int(c)
                if core_name[cc if cc < N else clone_src[cc - N]] != pc:
                    link += tb
        triples = tuple(triples)
        return ("m", (triples, link, internal_bytes), srcs, triples,
                link, internal_bytes)

    def _multi_tail(self, srcs, triples, link, internal_bytes):
        """Compute one touched-group cost from its node triples (the miss
        path of ``BoundEngine.subgraph_cost``, shared node-cost caches)."""
        eng = self.engine
        bound = self.bound
        per_core: dict = {}
        offchip = local = energy = 0.0
        node_objs = self.node_objs
        resource = self.resource
        ckey = self.ckey
        for s, tri in zip(srcs, triples, strict=True):
            nd = node_objs[s]
            c = bound.node_cost(nd, *tri)
            cname = resource[s]
            cyc = bound._cycles(ckey[s], tri[0], nd)
            per_core[cname] = per_core.get(cname, 0.0) + cyc
            offchip += c.offchip_bytes
            local += c.local_bytes
            energy += c.energy_pj
        return subgraph_tail(per_core, offchip, local, link, energy,
                             internal_bytes, eng._compute, eng._simd,
                             eng.hda)
