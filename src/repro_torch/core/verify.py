"""Model-invariant verifier + engine cache-coherence sanitizer.

A static-analysis pass with ruff-style rule codes over the whole modeling
stack (see docs/verify.md for the full registry with rationale):

* ``M0xx`` — graph well-formedness and training-transform conservation
  (``verify_graph``), plus parallel symmetry (``verify_parallel``);
* ``S0xx`` — schedule legality: an independent replay of the list
  scheduler plus a static race-detector over the replayed timeline
  (``verify_schedule``);
* ``C0xx`` — engine cache coherence: the incremental ``GraphSigs`` tables
  are diffed against a from-scratch re-signing (``verify_cache``).

Checks return structured :class:`Finding` records (rule id, severity,
offending node/tensor name, message) instead of raising, so search drivers
can attach them to winning candidates.  ``verify_result`` aggregates the
three passes and — in sanitizer mode — raises :class:`VerificationError`
on any error-severity finding.

Sanitizer mode (``REPRO_SANITIZE=1``) shadow-verifies hot paths at
runtime: every schedule-cache *miss* in ``scheduling.schedule`` re-derives
the result independently and cross-checks it.  The warm (cache-hit) path
is never instrumented, and timed benchmark runs refuse to start under the
flag (``benchmarks/run.py`` / ``scripts/check_bench_regression.py``), so
the sanitizer can never leak into performance numbers.

Structural rules (consumer/producer coherence, cache drift, schedule
replay, signature diff) are *errors* — they hold for any graph built
through the ``WorkloadGraph`` API.  Modeling-convention rules (orphan
tensors, flop conservation on hand-built graphs, dropped activations) are
*warnings*: real builder graphs satisfy them, but synthetic test graphs
may legitimately not.

The port's own copy of ``repro.core.verify`` (numpy and plain Python):
names, signatures and numeric code are the reference's, held bit for
bit against it by ``tests/test_torch_core.py``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from . import engine as _engine
from .cost_model import comm_payload
from .engine import GraphSigs, _count_static, _fingerprint, _sig_id, \
    _sign_node, get_engine, graph_sigs
from .graph import (GraphError, WorkloadGraph, conv_flops, gemm_flops)
from .memory import build_lifetime_plan, lifetime_profile, schedule_priorities
from .scheduling import ScheduleResult, quotient_dag
from .training_transform import BWD_KINDS

ERROR = "error"
WARNING = "warning"

#: rule id -> one-line description (docs/verify.md documents each with a
#: rationale and an example finding)
RULES = {
    # -- graph well-formedness (M00x) --------------------------------------
    "M001": "dangling consumer: consumer list names a node that does not "
            "exist or does not read the tensor",
    "M002": "stale consumer list: a node reads a tensor more often than "
            "the consumer list records",
    "M003": "producer mismatch: producer map and node outputs disagree",
    "M004": "orphan tensor: no producer, no consumers, no role flag",
    "M005": "adjacency-cache drift: cached preds/succs differ from the "
            "node inputs/outputs ground truth",
    "M006": "topo-cache drift: cached topological order is not a valid "
            "topological order of the current edges",
    "M007": "cycle: the graph is not a DAG",
    # -- training-transform conservation (M02x) ----------------------------
    "M020": "backward flop conservation: a bwd node's flops differ from "
            "its forward source's",
    "M021": "flops/dims mismatch: conv/gemm flops differ from the loop-"
            "nest formula on the node's own dims",
    "M022": "recompute integrity: a .rc clone drifted from the node it "
            "recomputes",
    "M023": "DMA pair imbalance: offload/fetch nodes unmatched or their "
            "payload bytes disagree with the tensor",
    "M024": "dropped activation: a forward tensor has no consumer and no "
            "policy (recompute/offload) handling it",
    "M025": "KV-cache conservation: an append's output shape, a paging "
            "payload, or a kv-kind output's memory category is "
            "inconsistent (repro.core.serving)",
    # -- parallel symmetry (M03x) ------------------------------------------
    "M030": "collective degree mismatch: a collective's P disagrees with "
            "the strategy (tp/dp groups, send/recv pairs)",
    "M031": "send/recv asymmetry: pipeline boundary transfers unmatched "
            "across stage graphs",
    "M032": "shard imbalance: sharded parameter bytes times tp differ "
            "from the unsharded total",
    # -- schedule legality (S00x) ------------------------------------------
    "S001": "partition cover violation: a node is missing from or "
            "duplicated across subgraphs",
    "S002": "cyclic quotient: the fused-subgraph DAG has a cycle",
    "S003": "resource race: two subgraphs overlap in time on the same "
            "compute/ici/dma resource",
    "S004": "dependency violation: a subgraph starts before a "
            "predecessor finishes",
    "S005": "memory conservation: mem_breakdown does not sum to the "
            "interval peak, or differs from the reference lifetime model",
    "S006": "latency/busy mismatch: the result disagrees with an "
            "independent replay of the list schedule",
    "S007": "spill imbalance: offload/fetch byte totals, one-way KV paging "
            "totals, or DMA busy cycles disagree with the schedule's spill "
            "accounting",
    # -- engine cache coherence (C00x) -------------------------------------
    "C001": "signature drift: an incremental node signature differs from "
            "a from-scratch re-signing",
    "C002": "byte-table drift: cached tensor bytes differ from the "
            "tensor specs",
    "C003": "static-footprint drift: cached static bytes differ from a "
            "fresh count",
    "C004": "category drift: a cached memory-category code differs from "
            "a fresh classification",
    "C005": "fingerprint drift: the cached schedule fingerprint differs "
            "from one rebuilt from fresh signatures",
    "C006": "dirty-set leak: the signature/adjacency caches claim to be "
            "clean at the current version but dirty sets are non-empty",
    "C007": "partition-sig drift: a partition signature differs from one "
            "recomputed from fresh node signatures",
    "C008": "macs drift: cached MAC totals differ from the node table",
    "C009": "degrade incoherence: a degraded-mode (survivor-set) plan is "
            "inconsistent with its strategy, or the degrade rewrite left "
            "stale signature/adjacency caches on a stage graph",
}


@dataclass(frozen=True)
class Finding:
    """One rule violation: which rule, how severe, where, and why."""

    rule: str
    severity: str
    subject: str          # offending node / tensor / resource name
    message: str

    def __str__(self) -> str:
        return f"{self.rule} {self.severity} [{self.subject}] {self.message}"


class VerificationError(GraphError):
    """Raised by ``verify_result`` (sanitizer mode / ``strict=True``) when
    any error-severity finding survives.  Carries the full finding list."""

    def __init__(self, findings: list):
        self.findings = list(findings)
        lines = "\n  ".join(str(f) for f in self.findings[:10])
        extra = len(self.findings) - 10
        if extra > 0:
            lines += f"\n  ... and {extra} more"
        super().__init__(f"verification failed "
                         f"({len(self.findings)} finding(s)):\n  {lines}")


def sanitize_enabled() -> bool:
    """True when ``REPRO_SANITIZE`` requests runtime shadow-verification."""
    return os.environ.get("REPRO_SANITIZE", "") not in ("", "0")


def _f(out: list, rule: str, subject: str, message: str,
       severity: str = ERROR) -> None:
    out.append(Finding(rule, severity, subject, message))


def _close(a: float, b: float, tol: float = 1e-9) -> bool:
    return abs(a - b) <= tol * max(1.0, abs(a), abs(b))


# ---------------------------------------------------------------------------
# M00x — graph well-formedness (ground truth rebuilt from the node table)
# ---------------------------------------------------------------------------


def _ground_truth(graph: WorkloadGraph):
    """(reads, producer) maps derived from nodes only — the raw structure
    the derived consumer/producer/adjacency caches must mirror."""
    reads: dict[str, dict[str, int]] = {}
    prod: dict[str, str] = {}
    for name, nd in graph.nodes.items():
        for t in nd.inputs:
            m = reads.setdefault(t, {})
            m[name] = m.get(name, 0) + 1
        for t in nd.outputs:
            prod.setdefault(t, name)
    return reads, prod


def _check_structure(graph: WorkloadGraph, out: list) -> None:
    reads, prod_truth = _ground_truth(graph)

    # M003: producer map <-> node outputs
    for name, nd in graph.nodes.items():
        for t in nd.outputs:
            if graph.producer.get(t) != name:
                _f(out, "M003", t,
                   f"produced by node {name!r} but producer map says "
                   f"{graph.producer.get(t)!r}")
    for t, p in graph.producer.items():
        if p not in graph.nodes:
            _f(out, "M003", t, f"producer {p!r} is not a node")
        elif t not in graph.nodes[p].outputs:
            _f(out, "M003", t, f"producer map names {p!r} which does not "
                               f"output it")

    # M001/M002: consumer lists <-> node inputs (multiset equality)
    for t, cs in graph.consumers.items():
        if t not in graph.tensors:
            _f(out, "M001", t, "consumer list for an unknown tensor")
            continue
        listed: dict[str, int] = {}
        for c in cs:
            listed[c] = listed.get(c, 0) + 1
        actual = reads.get(t, {})
        for c, k in listed.items():
            if c not in graph.nodes:
                _f(out, "M001", t, f"consumer {c!r} is not a node")
            elif actual.get(c, 0) < k:
                _f(out, "M001", t,
                   f"consumer list records {c!r} x{k} but the node reads "
                   f"it x{actual.get(c, 0)} (stale entry after a rewire?)")
        for c, k in actual.items():
            if listed.get(c, 0) < k:
                _f(out, "M002", t,
                   f"node {c!r} reads it x{k} but the consumer list "
                   f"records x{listed.get(c, 0)}")
    for t in reads:
        if t not in graph.consumers:
            _f(out, "M002", t, "read by nodes but has no consumer list")

    # M004: fully disconnected tensors (warning: may be deliberate staging)
    for t, spec in graph.tensors.items():
        if t in prod_truth or reads.get(t):
            continue
        if spec.is_param or spec.is_state or spec.is_input:
            continue
        _f(out, "M004", t, "neither produced nor consumed and not a "
                           "param/state/input", WARNING)

    # M007 + M006: own Kahn over the ground truth, then the cached order
    succs_truth: dict[str, list] = {n: [] for n in graph.nodes}
    indeg = {n: 0 for n in graph.nodes}
    for name, nd in graph.nodes.items():
        seen: set = set()
        for t in nd.inputs:
            p = prod_truth.get(t)
            if p is not None and p != name and p not in seen:
                seen.add(p)
                succs_truth[p].append(name)
                indeg[name] += 1
    from collections import deque
    q = deque(sorted(n for n, d in indeg.items() if d == 0))
    visited = 0
    dq = dict(indeg)
    while q:
        n = q.popleft()
        visited += 1
        for s in succs_truth[n]:
            dq[s] -= 1
            if dq[s] == 0:
                q.append(s)
    if visited != len(graph.nodes):
        stuck = sorted(n for n, d in dq.items() if d > 0)[:5]
        _f(out, "M007", ",".join(stuck), "graph has a cycle")
        return          # order-dependent checks are meaningless on a cycle

    try:
        topo = graph.topo_order()
    except GraphError as e:
        _f(out, "M007", graph.name, f"topo_order raised: {e}")
        return
    pos = {n: i for i, n in enumerate(topo)}
    if len(topo) != len(graph.nodes) or set(topo) != set(graph.nodes):
        _f(out, "M006", graph.name,
           "cached topo order is not a permutation of the node set")
    else:
        for n, ss in succs_truth.items():
            for s in ss:
                if pos[n] >= pos[s]:
                    _f(out, "M006", s,
                       f"scheduled at topo index {pos[s]} before its "
                       f"producer {n!r} at {pos[n]}")

    # M005: cached adjacency (after flushing pending patches) vs truth
    if graph._adj is None:
        return
    preds_c, succs_c = graph.adjacency()
    if set(preds_c) != set(graph.nodes) or set(succs_c) != set(graph.nodes):
        _f(out, "M005", graph.name,
           "adjacency cache keys differ from the node set")
        return
    preds_truth: dict[str, list] = {n: [] for n in graph.nodes}
    for n, ss in succs_truth.items():
        for s in ss:
            preds_truth[s].append(n)
    for n in graph.nodes:
        for label, cached, truth in (("preds", preds_c[n], preds_truth[n]),
                                     ("succs", succs_c[n], succs_truth[n])):
            if len(cached) != len(truth) or set(cached) != set(truth):
                _f(out, "M005", n,
                   f"cached {label} {sorted(cached)} != derived "
                   f"{sorted(truth)}")


# ---------------------------------------------------------------------------
# M02x — training-transform conservation
# ---------------------------------------------------------------------------

#: bwd ops whose flops must equal their forward source's exactly
#: (dim swaps preserve the loop-nest product; conv_bwd_data works on the
#: input spatial extent instead, so it is covered by M021 only)
_BWD_EQ_OPS = {"gemm_bwd_data", "gemm_bwd_weight", "conv_bwd_weight"}
_BWD_EQ_SOURCES = {"gemm", "conv", "conv_dw", "attention_qk", "attention_av"}

_CONV_FORMULA = {"conv", "conv_dw", "conv_bwd_data", "conv_bwd_weight"}
_GEMM_FORMULA = {"gemm", "gemm_bwd_data", "gemm_bwd_weight",
                 "attention_qk", "attention_av"}


def _check_training(graph: WorkloadGraph, out: list) -> None:
    nodes = graph.nodes
    tensors = graph.tensors

    has_bwd = any(nd.kind in BWD_KINDS for nd in nodes.values())

    for name, nd in nodes.items():
        # M021: flops must follow the loop-nest formula on the node's dims
        if nd.op in _CONV_FORMULA or nd.op in _GEMM_FORMULA:
            try:
                want = conv_flops(nd.dims) if nd.op in _CONV_FORMULA \
                    else gemm_flops(nd.dims)
            except KeyError as e:
                _f(out, "M021", name, f"missing loop dim {e} for {nd.op}",
                   WARNING)
                continue
            if nd.flops != want:
                _f(out, "M021", name,
                   f"{nd.op} flops {nd.flops} != formula({sorted(nd.dims.items())}) "
                   f"= {want}", WARNING)

        # M020: bwd flops == fwd source flops for the product-preserving ops
        if nd.op in _BWD_EQ_OPS and nd.kind in BWD_KINDS and nd.source:
            src = nodes.get(nd.source)
            if src is not None and src.op in _BWD_EQ_SOURCES \
                    and nd.flops != src.flops:
                _f(out, "M020", name,
                   f"{nd.op} flops {nd.flops} != source {nd.source!r} "
                   f"flops {src.flops}", WARNING)

        # M022: recompute clones must mirror the node they recompute
        if nd.kind == "recompute":
            src_name = nd.meta.get("recompute_of", nd.source)
            src = nodes.get(src_name) if src_name else None
            if src is None:
                _f(out, "M022", name,
                   f"recomputes unknown node {src_name!r}")
                continue
            if nd.op != src.op or nd.flops != src.flops or \
                    nd.dims != src.dims:
                _f(out, "M022", name,
                   f"clone drifted from {src_name!r}: "
                   f"op/dims/flops differ")
            for o in nd.outputs:
                if not o.endswith(".rc"):
                    _f(out, "M022", name,
                       f"recompute output {o!r} lacks the .rc suffix")
                    continue
                base = tensors.get(o[:-3])
                spec = tensors.get(o)
                if base is not None and spec is not None and (
                        base.shape != spec.shape or base.dtype != spec.dtype):
                    _f(out, "M022", o,
                       f"recomputed spec {spec.shape}/{spec.dtype} != "
                       f"original {base.shape}/{base.dtype}")

        # M023: DMA transfers must pair up and balance bytes
        if nd.op == "offload":
            if len(nd.inputs) != 1 or len(nd.outputs) != 1:
                _f(out, "M023", name, "offload must read one tensor and "
                                      "emit one marker")
                continue
            t, marker = nd.inputs[0], nd.outputs[0]
            payload = comm_payload(nd.dims)
            if t in tensors and payload != tensors[t].bytes:
                _f(out, "M023", name,
                   f"offload payload {payload} != tensor {t!r} bytes "
                   f"{tensors[t].bytes}")
            mspec = tensors.get(marker)
            if mspec is not None and mspec.bytes != 1:
                _f(out, "M023", marker,
                   "residency marker is not a 1-byte tensor")
            fetches = [c for c in graph.consumers.get(marker, ())
                       if nodes.get(c) is not None and nodes[c].op == "fetch"]
            if len(fetches) != 1:
                _f(out, "M023", name,
                   f"marker {marker!r} has {len(fetches)} fetch "
                   f"consumers (want exactly 1)")
                continue
            fnd = nodes[fetches[0]]
            if comm_payload(fnd.dims) != payload:
                _f(out, "M023", fnd.name,
                   f"fetch payload {comm_payload(fnd.dims)} != offload "
                   f"payload {payload}")
            if fnd.outputs:
                fspec = tensors.get(fnd.outputs[0])
                ospec = tensors.get(t)
                if fspec is not None and ospec is not None and (
                        fspec.shape != ospec.shape or
                        fspec.dtype != ospec.dtype):
                    _f(out, "M023", fnd.outputs[0],
                       f"fetched spec differs from offloaded {t!r}")
                if not graph.consumers.get(fnd.outputs[0]):
                    _f(out, "M023", fnd.outputs[0],
                       "fetched tensor has no consumer (dead transfer)")
        elif nd.op == "fetch":
            src = graph.producer.get(nd.inputs[0]) if nd.inputs else None
            if src is None or nodes.get(src) is None or \
                    nodes[src].op != "offload":
                _f(out, "M023", name,
                   "fetch input is not an offload marker")

        # M025: KV-cache conservation (repro.core.serving graphs)
        if nd.op in ("kv_read", "kv_load", "kv_write", "kv_store",
                     "kv_commit") or \
                (nd.op == "concat" and nd.kind == "kv"):
            if nd.kind != "kv":
                _f(out, "M025", name,
                   f"{nd.op} carries kind {nd.kind!r} (want 'kv' so its "
                   f"outputs classify as kv_cache)")
            if nd.op == "concat":
                axis = int(nd.meta.get("axis", 2))
                cache = tensors.get(nd.inputs[0]) if nd.inputs else None
                new = tensors.get(nd.inputs[1]) if len(nd.inputs) > 1 \
                    else None
                spec = tensors.get(nd.outputs[0]) if nd.outputs else None
                if cache is not None and new is not None and \
                        spec is not None:
                    want = tuple(d + new.shape[axis] if i == axis else d
                                 for i, d in enumerate(cache.shape))
                    if spec.shape != want:
                        _f(out, "M025", name,
                           f"append output shape {spec.shape} != cache "
                           f"{cache.shape} + block along axis {axis}")
                    if int(nd.dims.get("N", 0)) != new.size:
                        _f(out, "M025", name,
                           f"append writes {nd.dims.get('N')} elements != "
                           f"new block {new.size}")
            elif nd.op in ("kv_load", "kv_read"):
                spec = tensors.get(nd.outputs[0]) if nd.outputs else None
                if nd.op == "kv_load" and spec is not None and \
                        int(comm_payload(nd.dims)) != spec.bytes:
                    _f(out, "M025", name,
                       f"paged-in payload {comm_payload(nd.dims)} != cache "
                       f"bytes {spec.bytes}")
                if nd.outputs and not graph.consumers.get(nd.outputs[0]):
                    _f(out, "M025", nd.outputs[0],
                       "sourced cache has no consumer (dead read)")
            elif nd.op == "kv_store":
                src = tensors.get(nd.inputs[0]) if nd.inputs else None
                if src is not None and \
                        int(comm_payload(nd.dims)) > src.bytes:
                    _f(out, "M025", name,
                       f"paged-out payload {comm_payload(nd.dims)} exceeds "
                       f"source bytes {src.bytes}")

    # M024: forward activations must be consumed or policy-handled
    if has_bwd:
        for t, p in graph.producer.items():
            nd = nodes.get(p)
            if nd is None or nd.kind != "fwd":
                continue
            if graph.consumers.get(t):
                continue
            if t.endswith(".rc") or f"{t}.rc" in tensors:
                continue            # recompute policy handled it
            if f"offload:{t}" in nodes:
                continue            # offload policy handled it
            _f(out, "M024", t,
               f"forward output of {p!r} is never consumed and no "
               f"policy handles it", WARNING)


def verify_graph(graph: WorkloadGraph) -> list:
    """M0xx pass: well-formedness (M001–M007) + training-transform
    conservation (M020–M024) over one graph."""
    out: list = []
    _check_structure(graph, out)
    _check_training(graph, out)
    return out


# ---------------------------------------------------------------------------
# M03x — parallel symmetry (across the stage graphs of one plan)
# ---------------------------------------------------------------------------

_COLLECTIVES = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all")
_TP_SUFFIXES = (".tpar", ".tpag")
_DP_SUFFIXES = (".dpar", ".dprs", ".dpag")


def verify_parallel(tg, plan) -> list:
    """M03x pass over a :class:`~repro.core.parallel.ParallelPlan`:
    collective degrees match the strategy, pipeline send/recv transfers
    pair up across stage graphs, and sharded parameter bytes sum back to
    the unsharded totals."""
    out: list = []
    strat = plan.strategy
    stages = plan.stage_graphs

    if strat.chips != plan.cluster.n_chips:
        _f(out, "M030", plan.cluster.name,
           f"strategy needs {strat.chips} chips, cluster has "
           f"{plan.cluster.n_chips}")
    if len(stages) != strat.pipeline:
        _f(out, "M031", tg.graph.name,
           f"{len(stages)} stage graphs != pipeline degree "
           f"{strat.pipeline}")

    sends: dict[tuple, tuple] = {}          # (tensor, dst) -> (stage, dims)
    recvs: dict[str, list] = {}             # tensor -> [(stage, dims)]
    for s, sg in enumerate(stages):
        for name, nd in sg.nodes.items():
            if nd.op in _COLLECTIVES:
                p = int(nd.dims.get("P", 1))
                outp = nd.outputs[0] if nd.outputs else ""
                if outp.endswith(_TP_SUFFIXES):
                    want = strat.tensor
                elif outp.endswith(_DP_SUFFIXES):
                    want = strat.data
                else:
                    want = None
                if want is not None and p != want:
                    _f(out, "M030", name,
                       f"collective degree P={p} != group size {want} "
                       f"for {outp!r}")
                elif want is None and p < 2:
                    _f(out, "M030", name,
                       f"collective with degenerate degree P={p}")
            elif nd.op == "send":
                prefix, _, t = name.partition(":")
                try:
                    dst = int(prefix[len("send"):])
                except ValueError:
                    _f(out, "M031", name, "unparseable send destination")
                    continue
                sends[(t, dst)] = (s, nd.dims)
                if int(nd.dims.get("P", 1)) != 2:
                    _f(out, "M030", name,
                       f"point-to-point send with P={nd.dims.get('P')}")
            elif nd.op == "recv":
                t = name.partition(":")[2]
                recvs.setdefault(t, []).append((s, nd.dims))
                if int(nd.dims.get("P", 1)) != 2:
                    _f(out, "M030", name,
                       f"point-to-point recv with P={nd.dims.get('P')}")

    for (t, dst), (s, dims) in sends.items():
        if not (0 <= dst < len(stages)):
            _f(out, "M031", f"send{dst}:{t}",
               f"destination stage {dst} out of range")
            continue
        match = [(rs, rd) for rs, rd in recvs.get(t, ()) if rs == dst]
        if not match:
            _f(out, "M031", f"send{dst}:{t}",
               f"stage {s} sends {t!r} to stage {dst} but no recv exists "
               f"there")
            continue
        rd = match[0][1]
        if comm_payload(rd) != comm_payload(dims):
            _f(out, "M031", f"recv:{t}",
               f"recv payload {comm_payload(rd)} != send payload "
               f"{comm_payload(dims)}")
    for t, rs in recvs.items():
        for s, _dims in rs:
            if (t, s) not in sends:
                _f(out, "M031", f"recv:{t}",
                   f"stage {s} receives {t!r} but no stage sends it there")

    # M032: sharded parameter bytes x tp == unsharded bytes
    orig = tg.graph.tensors
    for w in plan.sharded_params:
        spec = None
        for sg in stages:
            spec = sg.tensors.get(w)
            if spec is not None:
                break
        if spec is None:
            _f(out, "M032", w, "sharded parameter appears in no stage graph")
            continue
        full = orig.get(w)
        if full is not None and spec.bytes * strat.tensor != full.bytes:
            _f(out, "M032", w,
               f"shard bytes {spec.bytes} x tp{strat.tensor} != unsharded "
               f"{full.bytes}")
    return out


# ---------------------------------------------------------------------------
# S0xx — schedule legality (independent replay + static race-detector)
# ---------------------------------------------------------------------------


def _replay(graph: WorkloadGraph, partition: list, qsucc: dict, costs: list):
    """Independent re-derivation of the list schedule: same priority rule,
    same resource-exclusive discipline, implemented apart from
    ``scheduling._assemble_fast`` so a bug there cannot hide here.
    Returns (start, finish, busy, makespan, events)."""
    import heapq
    n = len(partition)
    prio = schedule_priorities(graph, partition)
    succ = [tuple(sorted(qsucc.get(i, ()))) for i in range(n)]
    remaining = [0] * n
    for bs in succ:
        for b in bs:
            remaining[b] += 1
    start = [0.0] * n
    finish = [0.0] * n
    ready = [0.0] * n
    core_free: dict[str, float] = {}
    busy: dict[str, float] = {}
    makespan = 0.0
    events: list[tuple] = []       # (resource, start, end, subgraph index)
    heap = [(prio[i], i) for i in range(n) if remaining[i] == 0]
    heapq.heapify(heap)
    done = 0
    while heap:
        _, i = heapq.heappop(heap)
        c = costs[i]
        s = max(ready[i], core_free.get(c.core, 0.0))
        e = s + c.cycles
        start[i], finish[i] = s, e
        core_free[c.core] = e
        busy[c.core] = busy.get(c.core, 0.0) + c.cycles
        events.append((c.core, s, e, i))
        if e > makespan:
            makespan = e
        done += 1
        for j in succ[i]:
            if e > ready[j]:
                ready[j] = e
            remaining[j] -= 1
            if remaining[j] == 0:
                heapq.heappush(heap, (prio[j], j))
    if done != n:
        raise GraphError("replay deadlock")
    return start, finish, busy, makespan, events


def _verify_timeline(events: list, qedges: list, start: list, finish: list,
                     out: list) -> None:
    """Static race-detector over a timeline: per-resource exclusivity
    (S003) and dependency ordering (S004).  ``events`` are
    ``(resource, start, end, index)``; ``qedges`` are ``(pred, succ)``
    subgraph-index pairs."""
    by_res: dict[str, list] = {}
    for res, s, e, i in events:
        if e < s - 1e-12:
            _f(out, "S003", str(i),
               f"negative-duration interval [{s}, {e}] on {res!r}")
        by_res.setdefault(res, []).append((s, e, i))
    for res, evs in by_res.items():
        evs.sort()
        for (s1, e1, i1), (s2, e2, i2) in zip(evs, evs[1:], strict=False):
            if s2 < e1 and not _close(s2, e1):
                _f(out, "S003", res,
                   f"subgraphs {i1} [{s1}, {e1}] and {i2} [{s2}, {e2}] "
                   f"overlap on resource {res!r}")
    for a, b in qedges:
        if start[b] < finish[a] and not _close(start[b], finish[a]):
            _f(out, "S004", str(b),
               f"subgraph {b} starts at {start[b]} before its "
               f"predecessor {a} finishes at {finish[a]}")


def verify_schedule(graph: WorkloadGraph, hda, partition: list,
                    result: ScheduleResult, engine=None,
                    tensor_parallel: bool = True) -> list:
    """S0xx pass: exact-cover + acyclic quotient (S001/S002), an
    independent replay of the list schedule with a static race-detector
    (S003/S004), memory conservation against the reference lifetime model
    (S005), and latency/busy/spill agreement (S006/S007)."""
    out: list = []
    partition = [tuple(sg) for sg in partition]

    # S001: exact cover
    seen: dict[str, int] = {}
    for sg in partition:
        for n in sg:
            seen[n] = seen.get(n, 0) + 1
            if n not in graph.nodes:
                _f(out, "S001", n, "partition names an unknown node")
    for n, k in seen.items():
        if k > 1:
            _f(out, "S001", n, f"node appears in {k} subgraphs")
    missing = [n for n in graph.nodes if n not in seen]
    for n in missing[:5]:
        _f(out, "S001", n, "node missing from the partition")
    if out:
        return out

    # S002: acyclic quotient
    try:
        _, qsucc = quotient_dag(graph, partition)
    except GraphError as e:
        _f(out, "S002", graph.name, str(e))
        return out

    eng = engine if engine is not None else get_engine(hda, tensor_parallel)
    bound = eng.bind(graph)
    costs = [bound.subgraph_cost(sg) for sg in partition]
    start, finish, busy, makespan, events = _replay(graph, partition,
                                                   qsucc, costs)
    qedges = [(a, b) for a, bs in qsucc.items() for b in bs]
    _verify_timeline(events, qedges, start, finish, out)

    # S006: latency / per-resource busy / energy replay agreement
    if not _close(makespan, result.latency):
        _f(out, "S006", graph.name,
           f"result latency {result.latency} != replayed makespan "
           f"{makespan}")
    for res in set(busy) | set(result.per_core_busy):
        if not _close(busy.get(res, 0.0), result.per_core_busy.get(res, 0.0)):
            _f(out, "S006", res,
               f"busy {result.per_core_busy.get(res, 0.0)} != replayed "
               f"{busy.get(res, 0.0)}")
    energy = sum(c.energy_pj for c in costs) + makespan * hda.leak_per_cycle()
    if not _close(energy, result.energy):
        _f(out, "S006", graph.name,
           f"result energy {result.energy} != replayed {energy}")
    if result.n_subgraphs != len(partition):
        _f(out, "S006", graph.name,
           f"n_subgraphs {result.n_subgraphs} != {len(partition)}")
    macs = sum(nd.macs for nd in graph.nodes.values())
    if result.total_macs != macs:
        _f(out, "S006", graph.name,
           f"total_macs {result.total_macs} != node table {macs}")

    # S005: memory conservation via the reference lifetime model
    import numpy as np
    n = len(partition)
    order = sorted(range(n), key=finish.__getitem__)
    perm = np.empty(n, dtype=np.int64)
    perm[np.asarray(order, dtype=np.int64)] = np.arange(n, dtype=np.int64)
    mem = build_lifetime_plan(graph, partition)       # sigs-free reference
    prof = lifetime_profile(mem, perm)
    if sum(result.mem_breakdown.values()) != result.peak_mem:
        _f(out, "S005", graph.name,
           f"mem_breakdown sums to {sum(result.mem_breakdown.values())} "
           f"!= peak_mem {result.peak_mem}")
    if prof.peak != result.peak_mem:
        _f(out, "S005", graph.name,
           f"result peak_mem {result.peak_mem} != reference lifetime "
           f"peak {prof.peak}")
    if prof.breakdown != result.mem_breakdown:
        _f(out, "S005", graph.name,
           f"mem_breakdown {result.mem_breakdown} != reference "
           f"{prof.breakdown}")
    if prof.act_peak != result.act_peak:
        _f(out, "S005", graph.name,
           f"act_peak {result.act_peak} != reference {prof.act_peak}")
    if result.act_peak > result.peak_mem:
        _f(out, "S005", graph.name,
           f"act_peak {result.act_peak} exceeds peak_mem "
           f"{result.peak_mem}")
    if result.activation_bytes != graph.activation_bytes():
        _f(out, "S005", graph.name,
           f"activation_bytes {result.activation_bytes} != graph's "
           f"{graph.activation_bytes()}")

    # S007: spill accounting.  Activation offload/fetch pairs must balance
    # byte-for-byte; KV paging (kv_load / kv_store — repro.core.serving) is
    # legitimately one-directional (a decode step reads the whole cache back
    # but writes only the new block), so it is tallied separately and only
    # checked against the schedule's total.
    off_total = fetch_total = kv_total = 0
    for nd in graph.nodes.values():
        if nd.op_class != "dma":
            continue
        p = int(comm_payload(nd.dims))
        if nd.op == "offload":
            off_total += p
        elif nd.op == "fetch":
            fetch_total += p
        else:
            kv_total += p
    if off_total != fetch_total:
        _f(out, "S007", graph.name,
           f"offload bytes {off_total} != fetch bytes {fetch_total}")
    if result.spill_bytes != off_total + fetch_total + kv_total:
        _f(out, "S007", graph.name,
           f"spill_bytes {result.spill_bytes} != DMA payload total "
           f"{off_total + fetch_total + kv_total}")
    if not _close(result.spill_cycles, busy.get("dma", 0.0)):
        _f(out, "S007", graph.name,
           f"spill_cycles {result.spill_cycles} != replayed dma busy "
           f"{busy.get('dma', 0.0)}")
    return out


# ---------------------------------------------------------------------------
# C0xx — engine cache coherence (from-scratch re-signing diff)
# ---------------------------------------------------------------------------


def _norm_cats(d: dict) -> dict:
    return {k: v for k, v in d.items() if v}


def verify_cache(graph: WorkloadGraph, hda=None, engine=None,
                 partition=None) -> list:
    """C0xx pass: exercise the incremental ``graph_sigs`` path, then
    re-sign the whole graph from scratch into a throwaway table and diff
    every field.  With ``partition`` (and ``hda`` or ``engine``) the
    partition signature is recomputed from fresh signatures too (C007)."""
    out: list = []
    sigs = graph_sigs(graph)       # the tables under test (incremental path)

    # C006: clean-version caches must have empty dirty sets
    if graph._dirty_nodes or graph._dirty_tensors:
        _f(out, "C006", graph.name,
           f"signature tables at version {sigs.version} left dirty sets "
           f"non-empty ({sorted(graph._dirty_nodes)[:3]} / "
           f"{sorted(graph._dirty_tensors)[:3]})")
    if sigs.version != graph._version:
        _f(out, "C006", graph.name,
           f"signature version {sigs.version} != graph version "
           f"{graph._version} after refresh")
    if graph._adj is not None and graph._adj[0] == graph._version and \
            graph._adj_dirty:
        _f(out, "C006", graph.name,
           "adjacency cache claims the current version but has pending "
           "patch entries")

    # from-scratch reference tables
    fresh = GraphSigs(graph._version, _engine._SIG_GEN)
    for name in graph.nodes:
        _sign_node(graph, fresh, name)
    _count_static(graph, fresh, graph.tensors)

    # C001: per-node signature fields
    for name in graph.nodes:
        for fld, want in (("sid", fresh.sid[name]),
                          ("zmask", fresh.zmask[name]),
                          ("io_bytes", fresh.io_bytes[name]),
                          ("tiling", fresh.tiling[name]),
                          ("fp_entry", fresh.fp_entry[name])):
            got = getattr(sigs, fld).get(name)
            if got != want:
                _f(out, "C001", name,
                   f"incremental {fld} {got!r} != fresh {want!r}")
                break               # one finding per node is enough

    # C002: byte table vs tensor specs
    for t, b in fresh.tb.items():
        if sigs.tb.get(t) != b:
            _f(out, "C002", t,
               f"cached bytes {sigs.tb.get(t)!r} != spec bytes {b}")
    for t, b in sigs.tb.items():
        spec = graph.tensors.get(t)
        if spec is not None and spec.bytes != b:
            _f(out, "C002", t,
               f"cached bytes {b} != spec bytes {spec.bytes}")

    # C003: static footprint
    if sigs.static != fresh.static:
        _f(out, "C003", graph.name,
           f"incremental static {sigs.static} != fresh {fresh.static}")
    if _norm_cats(sigs.static_by_cat) != _norm_cats(fresh.static_by_cat):
        _f(out, "C003", graph.name,
           f"static_by_cat {sigs.static_by_cat} != fresh "
           f"{fresh.static_by_cat}")

    # C004: memory-category codes
    for t, c in fresh.cat.items():
        if sigs.cat.get(t) != c:
            _f(out, "C004", t,
               f"cached category {sigs.cat.get(t)!r} != fresh {c}")

    # C008: MAC accounting
    if sigs.macs_total != fresh.macs_total:
        _f(out, "C008", graph.name,
           f"incremental macs_total {sigs.macs_total} != fresh "
           f"{fresh.macs_total}")
    for n, m in fresh.node_macs.items():
        if sigs.node_macs.get(n) != m:
            _f(out, "C008", n,
               f"cached macs {sigs.node_macs.get(n)!r} != fresh {m}")

    # C005: schedule fingerprint
    try:
        order = graph.topo_order()
    except GraphError:
        order = None
    if order is not None:
        fp = _fingerprint(graph, sigs)
        want_key = (tuple(fresh.fp_entry[n] for n in order), fresh.static)
        if fp.key != want_key:
            _f(out, "C005", graph.name,
               "cached fingerprint differs from one rebuilt from fresh "
               "signatures")
        elif fp.h != hash(want_key):
            _f(out, "C005", graph.name,
               "fingerprint hash is stale for its key")

    # C007: partition signature vs fresh node signatures
    if partition is not None and (engine is not None or hda is not None):
        eng = engine if engine is not None else get_engine(hda)
        bound = eng.bind(graph)
        try:
            got = bound.partition_sig(partition)
        except KeyError as e:
            _f(out, "C007", str(e),
               "partition names a node with no cached signature")
            got = None
        if got is not None:
            want = []
            ok = True
            for sg in partition:
                try:
                    want.append(_sig_id(("grp",) +
                                        tuple(fresh.sid[n] for n in sg)))
                except KeyError as e:
                    _f(out, "C007", str(e),
                       "partition names a node the graph does not have")
                    ok = False
                    break
            if ok and got != tuple(want):
                bad = [i for i, (a, b) in enumerate(zip(got, want, strict=False))
                       if a != b][:3]
                _f(out, "C007", f"groups {bad}",
                   "partition signature differs from one recomputed from "
                   "fresh node signatures")
    return out


# ---------------------------------------------------------------------------
# C009 — degrade coherence (resilience: docs/resilience.md)
# ---------------------------------------------------------------------------


def verify_degrade(tg, plan, survivors: int | None = None) -> list:
    """Coherence of a degraded-mode (survivor-set) re-parallelization.

    ``repro.core.resilience.degrade`` rides the engine's warm path: the
    rewrite copies the training graph so signature tables carry over, and
    only the rewrite delta is re-signed.  That is exactly where stale-cache
    bugs would hide, so this pass (a) checks the survivor plan's strategy
    actually factorizes the survivor count, (b) re-runs the parallel
    symmetry scan (M030–M032), and (c) diffs every stage graph's inherited
    caches against a from-scratch re-signing, reporting any drift under
    C009 with the underlying C-rule in the message."""
    out: list = []
    n = survivors if survivors is not None else plan.cluster.n_chips
    if plan.strategy.chips != n:
        _f(out, "C009", plan.strategy.label,
           f"survivor plan uses {plan.strategy.chips} chips but "
           f"{n} chips survive")
    if plan.cluster.n_chips != n:
        _f(out, "C009", plan.cluster.name,
           f"survivor cluster has {plan.cluster.n_chips} chips, "
           f"expected {n}")
    out += verify_parallel(tg, plan)
    for i, sg in enumerate(plan.stage_graphs):
        out += verify_graph(sg)
        for f in verify_cache(sg):
            _f(out, "C009", f.subject,
               f"stage {i}: degrade rewrite left stale caches "
               f"({f.rule}): {f.message}", severity=f.severity)
    return out


# ---------------------------------------------------------------------------
# the aggregate hook
# ---------------------------------------------------------------------------


def verify_result(graph: WorkloadGraph, hda=None, partition=None,
                  result: ScheduleResult | None = None, engine=None,
                  tensor_parallel: bool = True, cache: bool = True,
                  strict: bool | None = None) -> list:
    """Run every applicable pass over one evaluated candidate and return
    the combined findings.  ``dse.sweep``, ``search_fusion``,
    ``ga_policy`` and ``evaluate_parallel`` call this on their winning
    candidates; ``scheduling.schedule`` calls it on every cache miss in
    sanitizer mode.

    ``strict`` (default: :func:`sanitize_enabled`) raises
    :class:`VerificationError` when any error-severity finding survives.
    """
    out = verify_graph(graph)
    if cache:
        out += verify_cache(graph, hda=hda, engine=engine,
                            partition=partition)
    if result is not None and (hda is not None or engine is not None):
        the_hda = hda if hda is not None else engine.hda
        part = partition if partition is not None \
            else [(n,) for n in graph.topo_order()]
        out += verify_schedule(graph, the_hda, part, result, engine=engine,
                               tensor_parallel=tensor_parallel)
    if strict is None:
        strict = sanitize_enabled()
    if strict:
        errors = [f for f in out if f.severity == ERROR]
        if errors:
            raise VerificationError(errors)
    return out
