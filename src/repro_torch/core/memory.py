"""Unified tensor-lifetime memory subsystem (single source of truth).

MONET's central claim is that training modeling stands or falls on
memory-footprint fidelity.  Before this module the repo modeled memory in
four disconnected ways: ``fusion.py``'s SRAM-fit inequality, ``scheduling``'s
topo-step liveness scan, ``checkpointing``'s knapsack budget and
``parallel``'s per-chip ceiling.  Following NeuroTrainer (activation
*offload* to a memory module is a first-class alternative to recomputation)
and TRIM (training DSE must co-optimize compute with the memory system),
everything now routes through one lifetime-accurate model:

* **Tensor categories** — every tensor is classified as
  weights / gradients / optimizer-state / inputs / activations / workspace /
  kv-cache (``tensor_category``), and the static footprint splits
  accordingly (``static_breakdown``).  The ``kv_cache`` category carries
  decode-time attention state for the inference-serving axis
  (docs/serving.md): per-sequence K/V bytes produced by ``kv``-kind nodes,
  resident across decode steps under KEEP or paged to the host pool over
  the ``dma`` resource under OFFLOAD (``kv_load`` / ``kv_store`` ops).
* **Lifetime intervals** — ``build_lifetime_plan`` derives, from a schedule
  partition, the event-based start/end step of every produced tensor
  (structure-of-arrays, cached per ``(fingerprint, partition)`` by the
  scheduler's plan cache — see docs/memory.md).  ``lifetime_profile`` turns
  a finish-order permutation into the exact interval peak, the per-category
  breakdown *at* the peak step and the peak live activation bytes.  On
  KEEP-everything schedules this is bit-for-bit the legacy liveness peak.
* **Capacity per memory level** — ``local_capacity`` (core-local SRAM) and
  ``tile_working_set`` carry the fusion solver's SRAM-fit inequality;
  off-chip ceilings come from ``ClusterSpec.mem_capacity``.
* **Activation policies** — :class:`ActivationPolicy`
  (KEEP / RECOMPUTE / OFFLOAD).  ``apply_offload`` splices explicit DMA
  transfer nodes (op-class ``dma``): an ``offload`` drains the activation to
  the off-chip pool right after its last forward use, a ``fetch``
  re-materializes it just before its backward consumer.  DMA nodes are
  costed on ``offchip_bw`` and scheduled on a dedicated ``dma`` resource, so
  transfers overlap with compute exactly like ``comm`` nodes overlap on
  ``ici`` — the NeuroTrainer-style alternative to recomputation.

Consumers: ``scheduling`` (liveness + breakdown + spill), ``fusion``
(SRAM constraint), ``checkpointing`` (ternary policy GA), ``parallel``
(lifetime-based per-chip peak) — see docs/memory.md.

The port's own copy of ``repro.core.memory`` (numpy and plain Python):
names, signatures and numeric code are the reference's, held bit for
bit against it by ``tests/test_torch_core.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum

import numpy as np

from .cost_model import comm_payload
from .graph import Node, TensorSpec, WorkloadGraph, dtype_bytes
from .training_transform import BWD_KINDS

# ---------------------------------------------------------------------------
# tensor categories
# ---------------------------------------------------------------------------

WEIGHTS = "weights"
GRADIENTS = "gradients"
OPTIMIZER_STATE = "optimizer_state"
INPUTS = "inputs"
ACTIVATIONS = "activations"
WORKSPACE = "workspace"
KV_CACHE = "kv_cache"

#: category order also fixes the integer codes of the SoA lifetime arrays
#: (``kv_cache`` is appended last so the pre-serving codes stay stable)
MEM_CATEGORIES = (WEIGHTS, GRADIENTS, OPTIMIZER_STATE, INPUTS,
                  ACTIVATIONS, WORKSPACE, KV_CACHE)
_CAT_CODE = {c: i for i, c in enumerate(MEM_CATEGORIES)}
_ACT_CODE = _CAT_CODE[ACTIVATIONS]

#: producer kinds whose outputs are activations (a pipeline ``recv`` of a
#: forward tensor keeps kind 'fwd', so stage graphs classify consistently)
_ACT_KINDS = frozenset({"fwd", "loss", "recompute"})

#: producer kinds whose outputs are decode-time KV-cache state (serving
#: graphs — repro.core.serving / docs/serving.md).  Checked before the
#: activation rule so cache reads/appends never masquerade as activations.
_KV_KINDS = frozenset({"kv"})

#: DMA ops whose outputs are re-materialized just-in-time: the classic
#: activation ``fetch`` and the serving-axis KV page-in (``kv_load``).
#: Both get the double-buffered residency window (``_fetch_start_override``)
#: and consumer-inherited list-scheduler priorities.
_FETCH_OPS = frozenset({"fetch", "kv_load"})


def category_code(spec: TensorSpec, producer_kind: str | None) -> int:
    """Integer category code (index into ``MEM_CATEGORIES``) of a tensor
    from its role flags and its producer's node kind.  The engine's
    signature tables cache this per tensor (``GraphSigs.cat``) so plan
    builds stay off the Python-attribute hot path."""
    if spec.is_param:
        return _CAT_CODE[WEIGHTS]
    if spec.is_state:
        return _CAT_CODE[OPTIMIZER_STATE]
    if spec.is_input:
        return _CAT_CODE[INPUTS]
    if producer_kind in _KV_KINDS:
        return _CAT_CODE[KV_CACHE]
    if producer_kind in _ACT_KINDS:
        return _CAT_CODE[ACTIVATIONS]
    if producer_kind in BWD_KINDS:
        return _CAT_CODE[GRADIENTS]
    return _CAT_CODE[WORKSPACE]       # opt outputs, comm results, DMA staging


def tensor_category(graph: WorkloadGraph, name: str) -> str:
    """Memory category of one tensor: role flags first (weights /
    optimizer-state / inputs), then the producing node's kind (kv-cache
    from ``kv`` serving nodes, activations from forward/recompute,
    gradients from backward, workspace otherwise)."""
    prod = graph.producer.get(name)
    kind = graph.nodes[prod].kind if prod is not None else None
    return MEM_CATEGORIES[category_code(graph.tensors[name], kind)]


def static_breakdown(graph: WorkloadGraph) -> dict:
    """Always-live footprint split into weights / optimizer-state / inputs
    (the three role-flagged classes the legacy scalar ``static`` lumped
    together; Adam moments from ``training_transform`` land in
    optimizer-state via ``is_state``)."""
    out = {WEIGHTS: 0, OPTIMIZER_STATE: 0, INPUTS: 0}
    for spec in graph.tensors.values():
        if spec.is_param:
            out[WEIGHTS] += spec.bytes
        elif spec.is_state:
            out[OPTIMIZER_STATE] += spec.bytes
        elif spec.is_input:
            out[INPUTS] += spec.bytes
    return out


# ---------------------------------------------------------------------------
# lifetime intervals (SoA, shared by the engine and the reference scheduler)
# ---------------------------------------------------------------------------


@dataclass
class LifetimePlan:
    """Schedule-independent lifetime arrays for one (graph, partition):
    per produced tensor its producing subgraph, bytes, category code and
    flattened consumer list (split points for ``np.maximum.reduceat``).
    Built once per ``(fingerprint, partition)`` and cached by the
    scheduler's plan cache under the engine's invalidation rules."""

    n_steps: int
    static: int
    static_by_cat: dict
    prod_sg: np.ndarray
    nbytes: np.ndarray
    cats: np.ndarray
    cons_flat: np.ndarray
    cons_split: np.ndarray
    fetch_idx: np.ndarray = None  # tensors produced by DMA 'fetch' nodes
    spill_bytes: int = 0          # Σ DMA payload (offload out + fetch back)


def build_lifetime_plan(graph: WorkloadGraph, partition: list,
                        sigs=None) -> LifetimePlan:
    """Derive the lifetime arrays from the partition.  ``sigs`` (the
    engine's :class:`~repro.core.engine.GraphSigs`) supplies cached tensor
    bytes and the static footprint; without it everything is recomputed from
    the graph (the reference path)."""
    nodes = graph.nodes
    tensors = graph.tensors
    from_sigs = sigs is not None
    tens_prod: dict[str, int] = {}
    tens_cons: dict[str, list] = {}
    prod_kind: dict[str, str] = {}
    fetched: set = set()
    spill = 0
    for i, sg in enumerate(partition):
        for nm in sg:
            nd = nodes[nm]
            for t in nd.inputs:
                tens_cons.setdefault(t, []).append(i)
            for t in nd.outputs:
                tens_prod[t] = i
                if not from_sigs:
                    prod_kind[t] = nd.kind
            if nd.op_class == "dma":
                spill += int(comm_payload(nd.dims))
                if nd.op in _FETCH_OPS:
                    fetched.update(nd.outputs)

    if from_sigs:
        # byte table, categories and the static split are maintained
        # incrementally by the engine's signature tables (GraphSigs)
        tb = sigs.tb
        nbytes = [tb[t] for t in tens_prod]
        static = sigs.static
        static_by_cat = dict(sigs.static_by_cat)
        cats = [sigs.cat[t] for t in tens_prod]
    else:
        nbytes = [tensors[t].bytes for t in tens_prod]
        static_by_cat = static_breakdown(graph)
        static = sum(static_by_cat.values())
        cats = [category_code(tensors[t], prod_kind[t]) for t in tens_prod]
    cons_flat: list = []
    cons_split = [0]
    fetch_idx: list = []
    for ti, (t, pi) in enumerate(tens_prod.items()):
        cs = tens_cons.get(t)
        if cs:
            cons_flat.extend(cs)
        else:
            cons_flat.append(pi)      # no consumers: freed at the prod step
        cons_split.append(len(cons_flat))
        if t in fetched:
            fetch_idx.append(ti)
    return LifetimePlan(
        n_steps=len(partition),
        static=static,
        static_by_cat=static_by_cat,
        prod_sg=np.fromiter(tens_prod.values(), dtype=np.int64,
                            count=len(tens_prod)),
        nbytes=np.asarray(nbytes, dtype=np.int64),
        cats=np.asarray(cats, dtype=np.int64),
        cons_flat=np.asarray(cons_flat, dtype=np.int64),
        cons_split=np.asarray(cons_split[:-1], dtype=np.int64),
        fetch_idx=np.asarray(fetch_idx, dtype=np.int64),
        spill_bytes=spill,
    )


@dataclass
class MemProfile:
    """Interval-capacity result of one scheduled plan."""

    peak: int                     # exact interval peak (bytes)
    breakdown: dict = field(default_factory=dict)  # category -> bytes at peak
    act_peak: int = 0             # peak live activation-category bytes


def _fetch_start_override(plan: LifetimePlan, perm_cons: np.ndarray,
                          s_arr: np.ndarray, batched: bool) -> np.ndarray:
    """DMA residency window of fetched activations (shared by the scalar and
    batched profile kernels).  The greedy list scheduler back-fills the idle
    ``dma`` resource, starting fetch transfers as early as possible — but a
    real DMA engine times the transfer so the destination buffer lands right
    before its first consumer (double-buffered prefetch).  A fetched tensor
    is therefore resident from its *first consumer's* step, not from the
    transfer's finish step; its source payload lives off-chip between the
    ``offload`` and the ``fetch`` and never re-enters the on-chip arrays."""
    if plan.fetch_idx is None or not plan.fetch_idx.size:
        return s_arr
    s_arr = s_arr.copy()
    if batched:
        first_use = np.minimum.reduceat(perm_cons, plan.cons_split, axis=1)
        s_arr[:, plan.fetch_idx] = first_use[:, plan.fetch_idx]
    else:
        first_use = np.minimum.reduceat(perm_cons, plan.cons_split)
        s_arr[plan.fetch_idx] = first_use[plan.fetch_idx]
    return s_arr


def lifetime_profile(plan: LifetimePlan, perm: np.ndarray) -> MemProfile:
    """Exact interval peak + per-category breakdown for one finish-order
    permutation (``perm[subgraph] = step``).  Integer byte arithmetic: on a
    KEEP-everything schedule the peak is bit-for-bit the legacy topo-step
    liveness scan (the per-category cumsums simply partition it)."""
    ncat = len(MEM_CATEGORIES)
    static_bd = plan.static_by_cat
    if plan.prod_sg.size == 0:
        bd = {c: static_bd.get(c, 0) for c in MEM_CATEGORIES}
        return MemProfile(plan.static, bd, 0)
    perm_cons = perm[plan.cons_flat]
    s_arr = perm[plan.prod_sg]
    # last consumer in finish order (last-assignment-wins over the scan)
    e_arr = np.maximum.reduceat(perm_cons, plan.cons_split)
    # just-in-time DMA arrival (no-op without fetched tensors)
    s_arr = _fetch_start_override(plan, perm_cons, s_arr, batched=False)
    deltas = np.zeros((plan.n_steps + 1, ncat), dtype=np.int64)
    np.add.at(deltas, (s_arr, plan.cats), plan.nbytes)
    np.add.at(deltas, (e_arr + 1, plan.cats), -plan.nbytes)
    cum = np.cumsum(deltas, axis=0)
    totals = cum.sum(axis=1)
    i = int(np.argmax(totals))
    extra = int(totals[i])
    if extra > 0:
        peak = plan.static + extra
        at = cum[i]
    else:
        peak = plan.static
        at = np.zeros(ncat, dtype=np.int64)
    breakdown = {c: static_bd.get(c, 0) + int(at[ci])
                 for ci, c in enumerate(MEM_CATEGORIES)}
    act_peak = max(0, int(cum[:, _ACT_CODE].max()))
    return MemProfile(peak, breakdown, act_peak)


def lifetime_profile_batch(plan: LifetimePlan, perms: list) -> list:
    """Batched interval peaks: exactly ``[lifetime_profile(plan, p) for p in
    perms]`` (same integer arithmetic, same first-argmax peak step), computed
    in one vectorized pass over a ``(B, n_steps)`` permutation matrix.  Used
    by ``scheduling.schedule_batch`` when many finish orders share one
    lifetime plan — e.g. a DSE row evaluating the same (graph, partition)
    on every architecture of the grid."""
    ncat = len(MEM_CATEGORIES)
    static_bd = plan.static_by_cat
    nb = len(perms)
    if plan.prod_sg.size == 0:
        return [MemProfile(plan.static,
                           {c: static_bd.get(c, 0) for c in MEM_CATEGORIES},
                           0) for _ in range(nb)]
    P = np.stack(perms)                       # (B, n_steps)
    s_arr = P[:, plan.prod_sg]                # (B, n_tensors)
    cf = P[:, plan.cons_flat]
    e_arr = np.maximum.reduceat(cf, plan.cons_split, axis=1)
    s_arr = _fetch_start_override(plan, cf, s_arr, batched=True)
    rows = np.arange(nb)[:, None]
    cats = plan.cats[None, :]
    deltas = np.zeros((nb, plan.n_steps + 1, ncat), dtype=np.int64)
    np.add.at(deltas, (rows, s_arr, cats), plan.nbytes)
    np.add.at(deltas, (rows, e_arr + 1, cats), -plan.nbytes)
    cum = np.cumsum(deltas, axis=1)
    totals = cum.sum(axis=2)
    steps = np.argmax(totals, axis=1)         # first max, like the scalar path
    extras = totals[np.arange(nb), steps]
    act_peaks = np.maximum(cum[:, :, _ACT_CODE].max(axis=1), 0)
    out = []
    for b in range(nb):
        extra = int(extras[b])
        if extra > 0:
            peak = plan.static + extra
            at = cum[b, steps[b]]
        else:
            peak = plan.static
            at = np.zeros(ncat, dtype=np.int64)
        breakdown = {c: static_bd.get(c, 0) + int(at[ci])
                     for ci, c in enumerate(MEM_CATEGORIES)}
        out.append(MemProfile(peak, breakdown, int(act_peaks[b])))
    return out


def schedule_priorities(graph: WorkloadGraph, partition: list,
                        topo_idx: dict | None = None,
                        has_fetch: bool | None = None) -> list[int]:
    """List-scheduler priority per subgraph: the minimal topo index of its
    nodes — except pure DMA fetch subgraphs (``fetch`` / serving ``kv_load``
    page-ins), which inherit their consumers' priority so a re-materialized
    tensor is fetched
    just-in-time (its resident interval starts right before the backward
    consumer instead of right after the offload).  ``has_fetch=False``
    (known e.g. from a built :class:`LifetimePlan`) skips the node scan."""
    if topo_idx is None:
        topo_idx = {n: i for i, n in enumerate(graph.topo_order())}
    nodes = graph.nodes
    consumers = graph.consumers
    gi = topo_idx.__getitem__
    fetches = () if has_fetch is False else \
        {n for n, nd in nodes.items() if nd.op in _FETCH_OPS}
    if not fetches:        # common case: plain min-topo priorities
        return [gi(sg[0]) if len(sg) == 1 else min(map(gi, sg))
                for sg in partition]
    prio: list[int] = []
    for sg in partition:
        p = gi(sg[0]) if len(sg) == 1 else min(map(gi, sg))
        if all(n in fetches for n in sg):
            cons = [topo_idx[c] for n in sg for t in nodes[n].outputs
                    for c in consumers.get(t, ())]
            if cons:
                p = max(p, min(cons))
        prio.append(p)
    return prio


# ---------------------------------------------------------------------------
# capacity per memory level
# ---------------------------------------------------------------------------


def local_capacity(hda) -> int:
    """On-chip capacity of the dominant compute core's local SRAM level
    (``MemLevel.size × count``) — the ceiling of the fusion solver's
    tile-working-set constraint."""
    comp = (hda.compute_cores() or list(hda.cores))[0]
    return comp.local.size * comp.count


def tile_working_set(nbytes, tilings) -> float:
    """Per-tile working set of a fused subgraph: each member's unique I/O
    bytes divided by the smallest shared temporal tiling factor (paper's
    Σᵢ mᵢ,c / T).  Arithmetic identical to the legacy inline check in
    ``fusion.enumerate_candidates``."""
    nbytes = list(nbytes)
    tilings = list(tilings)
    tmin = min([t for t in tilings if t > 1], default=1)
    return sum(b / max(1, tmin if t > 1 else 1)
               for b, t in zip(nbytes, tilings, strict=True))


# ---------------------------------------------------------------------------
# activation policies + the offload graph rewrite
# ---------------------------------------------------------------------------


class ActivationPolicy(IntEnum):
    """Per-activation handling between its forward producer and backward
    consumers.  KEEP stores it on-chip (legacy behaviour), RECOMPUTE
    discards and re-derives it (``checkpointing.apply_checkpointing``),
    OFFLOAD drains it to the off-chip pool over DMA and fetches it back
    just-in-time (``apply_offload``)."""

    KEEP = 0
    RECOMPUTE = 1
    OFFLOAD = 2


#: kinds of consumers that read an activation *after* the forward pass and
#: therefore must be rewired to the fetched copy
_LATE_KINDS = BWD_KINDS | {"recompute"}


def apply_offload(g: WorkloadGraph, tensors) -> list[str]:
    """Splice DMA transfer nodes for every activation in ``tensors``
    (in place): ``offload:<t>`` consumes the activation right after its last
    forward use and emits a 1-byte residency marker (the payload itself
    lives in the off-chip pool, so it leaves the on-chip lifetime model);
    ``fetch:<t>`` turns the marker back into ``<t>.fetch``, which every
    backward / recompute consumer is rewired to.  Both nodes carry the
    payload in comm-style dims (``N`` elements × ``E`` bytes/element) and
    cost against ``offchip_bw`` on the dedicated ``dma`` resource.

    Returns the list of tensors actually offloaded (those with at least one
    late consumer)."""
    done: list[str] = []
    for t in sorted(tensors):
        spec = g.tensors[t]
        late = [c for c in list(g.consumers.get(t, ()))
                if g.nodes[c].kind in _LATE_KINDS]
        if not late:
            continue
        src = g.producer.get(t)
        dims = dict(N=spec.size, E=dtype_bytes(spec.dtype))
        marker = f"{t}.off"
        fetched = f"{t}.fetch"
        g.add_tensor(TensorSpec(marker, (1,), "int8"))
        g.add_node(Node(f"offload:{t}", "offload", "dma", dict(dims),
                        [t], [marker], 0, src))
        g.add_tensor(TensorSpec(fetched, spec.shape, spec.dtype))
        g.add_node(Node(f"fetch:{t}", "fetch", "dma", dict(dims),
                        [marker], [fetched], 0, src))
        for c in late:
            g.rename_tensor_for(c, t, fetched)
        done.append(t)
    return done
