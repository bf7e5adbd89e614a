"""Workload-graph IR for MONET.

A neural network (inference or full training iteration) is a directed graph
G = (V, E): nodes are operators, edges are tensors (paper §II-A).  This IR is
the common currency between the front-ends (explicit builders, jaxpr tracing),
the training transformation pass, the fusion solver, the activation-checkpoint
rewriter and the HDA cost model.

Conventions
-----------
* Loop dims follow Stream/ZigZag:  conv: B,K,C,OY,OX,FY,FX  — gemm: B,M,N,K
  elementwise/reduce/transpose: N (total elements).
* ``Node.kind`` partitions the training iteration:
  fwd | loss | bwd_data | bwd_weight | bwd_bias | bwd (generic) | opt | aux.
* Tensors are globally named; ``WorkloadGraph.tensors`` owns the specs,
  producer/consumer maps are derived and kept consistent by ``add_node``.

The port's own copy of ``repro.core.graph`` (numpy and plain Python):
names, signatures and numeric code are the reference's, held bit for
bit against it by ``tests/test_torch_core.py``.
"""

from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field
from functools import cached_property
from collections.abc import Iterable

import numpy as np

# ---------------------------------------------------------------------------
# Tensors
# ---------------------------------------------------------------------------

_DTYPE_BYTES = {
    "float32": 4, "f32": 4, "bfloat16": 2, "bf16": 2, "float16": 2, "fp16": 2,
    "int32": 4, "int8": 1, "uint8": 1, "bool": 1, "int64": 8, "float64": 8,
}


def dtype_bytes(dtype: str) -> int:
    try:
        return _DTYPE_BYTES[dtype]
    except KeyError:
        return int(np.dtype(dtype).itemsize)


@dataclass(frozen=True)
class TensorSpec:
    """An edge payload: a named tensor with shape/dtype and roles."""

    name: str
    shape: tuple[int, ...]
    dtype: str = "bfloat16"
    is_param: bool = False          # trainable parameter
    is_state: bool = False          # optimizer state
    is_input: bool = False          # graph input (data)

    @cached_property
    def size(self) -> int:
        return math.prod(self.shape) if self.shape else 1

    @cached_property
    def bytes(self) -> int:
        return self.size * dtype_bytes(self.dtype)


# ---------------------------------------------------------------------------
# Nodes
# ---------------------------------------------------------------------------

#: op → category used by the cost model / fusion constraints
OP_CLASS = {
    "conv": "conv",
    "conv_dw": "conv",            # depthwise
    "conv_bwd_data": "conv",      # transposed conv
    "conv_bwd_weight": "conv",
    "gemm": "gemm",
    "gemm_bwd_data": "gemm",
    "gemm_bwd_weight": "gemm",
    "attention_qk": "gemm",
    "attention_av": "gemm",
    "elementwise": "simd",
    "add": "simd",
    "mul": "simd",
    "relu": "simd",
    "relu_bwd": "simd",
    "gelu": "simd",
    "gelu_bwd": "simd",
    "silu": "simd",
    "silu_bwd": "simd",
    "softmax": "simd",
    "softmax_bwd": "simd",
    "norm": "simd",
    "norm_bwd": "simd",
    "pool": "simd",
    "pool_bwd": "simd",
    "reduce": "simd",
    "transpose": "move",
    "reshape": "move",
    "embed": "move",
    "embed_bwd": "simd",
    "loss": "simd",
    "loss_bwd": "simd",
    "opt": "simd",
    "scan": "simd",
    # inter-chip collective-communication nodes (parallel training —
    # see repro.core.parallel): costed against the cluster interconnect
    "all_reduce": "comm",
    "all_gather": "comm",
    "reduce_scatter": "comm",
    "all_to_all": "comm",
    "send": "comm",
    "recv": "comm",
    # activation-offload DMA transfers (memory subsystem — repro.core.memory):
    # costed against off-chip bandwidth on a dedicated 'dma' resource
    "offload": "dma",
    "fetch": "dma",
    # inference-serving KV-cache ops (repro.core.serving — docs/serving.md):
    # resident cache read/append/commit move on-chip; the paged variants
    # stream the cache to/from the host pool over the 'dma' resource
    "concat": "move",
    "kv_read": "move",
    "kv_write": "move",
    "kv_commit": "move",
    "kv_load": "dma",
    "kv_store": "dma",
}


@dataclass
class Node:
    """One operator. ``dims`` is the loop nest; ``flops`` counts MUL+ADD."""

    name: str
    op: str
    kind: str = "fwd"
    dims: dict = field(default_factory=dict)
    inputs: list = field(default_factory=list)     # tensor names
    outputs: list = field(default_factory=list)    # tensor names
    flops: int = 0
    source: str | None = None   # fwd node this bwd/recompute node derives from
    meta: dict = field(default_factory=dict)

    @cached_property
    def op_class(self) -> str:
        return OP_CLASS.get(self.op, "simd")

    @cached_property
    def macs(self) -> int:
        return self.flops // 2


def conv_flops(d: dict) -> int:
    return 2 * d["B"] * d["K"] * d["C"] * d["OY"] * d["OX"] * d["FY"] * d["FX"]


def gemm_flops(d: dict) -> int:
    return 2 * d.get("B", 1) * d["M"] * d["N"] * d["K"]


# ---------------------------------------------------------------------------
# Graph
# ---------------------------------------------------------------------------


class GraphError(RuntimeError):
    pass


class WorkloadGraph:
    """Mutable DAG of Nodes + TensorSpecs with derived producer/consumer maps."""

    def __init__(self, name: str = "workload"):
        self.name = name
        self.nodes: dict[str, Node] = {}
        self.tensors: dict[str, TensorSpec] = {}
        self.producer: dict[str, str] = {}          # tensor -> node
        self.consumers: dict[str, list[str]] = {}   # tensor -> [node]
        # structural version: bumped on every mutation; derived caches
        # (adjacency, topo order, engine signatures) key off it.
        self._version = 0
        self._adj: tuple | None = None      # (version, preds, succs)
        self._adj_dirty: set = set()        # nodes whose adjacency is stale
        self._topo: tuple | None = None     # (version, order)
        self._derived: dict = {}            # tag -> payload (version-aware)
        self._dirty_nodes: set = set()      # nodes touched since last sig build
        self._dirty_tensors: set = set()    # tensors added since last sig build
        self._shared_cons: set = set()      # consumer lists shared with a copy

    def _own_consumers(self, t: str) -> list:
        """Copy-on-write access to ``consumers[t]`` for mutation.  ``copy()``
        shares the per-tensor lists between source and clone; the first
        mutation on either side splits that tensor's list."""
        cs = self.consumers.setdefault(t, [])
        if t in self._shared_cons:
            cs = self.consumers[t] = list(cs)
            self._shared_cons.discard(t)
        return cs

    # -- construction -------------------------------------------------------

    def add_tensor(self, spec: TensorSpec) -> TensorSpec:
        existing = self.tensors.get(spec.name)
        if existing is not None and existing != spec:
            raise GraphError(f"tensor {spec.name!r} redefined with different spec")
        self.tensors[spec.name] = spec
        self.consumers.setdefault(spec.name, [])
        self._version += 1
        self._dirty_tensors.add(spec.name)
        return spec

    def tensor(self, name: str, shape: tuple[int, ...], dtype: str = "bfloat16",
               **kw) -> str:
        self.add_tensor(TensorSpec(name, tuple(int(s) for s in shape), dtype, **kw))
        return name

    def add_node(self, node: Node) -> Node:
        if node.name in self.nodes:
            raise GraphError(f"node {node.name!r} already exists")
        for t in node.inputs:
            if t not in self.tensors:
                raise GraphError(f"{node.name}: unknown input tensor {t!r}")
        for t in node.outputs:
            if t not in self.tensors:
                raise GraphError(f"{node.name}: unknown output tensor {t!r}")
            if t in self.producer:
                raise GraphError(f"tensor {t!r} produced twice "
                                 f"({self.producer[t]} and {node.name})")
            self.producer[t] = node.name
        if self._adj is not None:
            # incremental adjacency: the new node, producers of its inputs
            # (gain a successor) and pre-registered consumers of its outputs
            # (gain a predecessor) need their entries recomputed
            dirty = self._adj_dirty
            dirty.add(node.name)
            for t in node.inputs:
                p = self.producer.get(t)
                if p is not None:
                    dirty.add(p)
            for t in node.outputs:
                for c in self.consumers.get(t, ()):
                    dirty.add(c)
        for t in node.inputs:
            self._own_consumers(t).append(node.name)
        self.nodes[node.name] = node
        self._version += 1
        self._dirty_nodes.add(node.name)
        return node

    # -- structure ----------------------------------------------------------

    def _node_adj(self, name: str) -> tuple[list, list]:
        nd = self.nodes[name]
        seen: set = set()
        ps: list[str] = []
        for t in nd.inputs:
            p = self.producer.get(t)
            if p is not None and p not in seen:
                seen.add(p)
                ps.append(p)
        seen = set()
        ss: list[str] = []
        for t in nd.outputs:
            for c in self.consumers.get(t, []):
                if c not in seen:
                    seen.add(c)
                    ss.append(c)
        return ps, ss

    def adjacency(self) -> tuple[dict, dict]:
        """(preds, succs) node-name adjacency maps, cached per version and
        patched incrementally for mutated nodes.  The returned maps and lists
        are shared — callers must not mutate them (entries are *replaced*,
        never mutated, on graph edits)."""
        adj = self._adj
        if adj is not None:
            if adj[0] == self._version:
                return adj[1], adj[2]
            # patch only the entries invalidated by mutations
            preds, succs = adj[1], adj[2]
            for name in self._adj_dirty:
                preds[name], succs[name] = self._node_adj(name)
            self._adj_dirty = set()
            self._adj = (self._version, preds, succs)
            return preds, succs
        preds = {}
        succs = {}
        for name in self.nodes:
            preds[name], succs[name] = self._node_adj(name)
        self._adj_dirty = set()
        self._adj = (self._version, preds, succs)
        return preds, succs

    def predecessors(self, node: str) -> list[str]:
        return self.adjacency()[0][node]

    def successors(self, node: str) -> list[str]:
        return self.adjacency()[1][node]

    def topo_order(self) -> list[str]:
        """Topological node order, cached per structural version.  The
        returned list is shared (and carried over by ``copy()``) — callers
        must not mutate it.

        The order is *canonical*: heap-Kahn keyed by (structural depth,
        registration serial), where depth(n) = 1 + max(depth(preds)) and
        the serial is the node's insertion index (nodes are never removed).
        It depends only on the node registration sequence and the edge
        *set*, never on consumer-list ordering or mutation history, so any
        construction path that registers the same nodes in the same order
        (e.g. the engine's batched phenotype evaluator, which never
        materializes a WorkloadGraph at all) reproduces it bit-for-bit.
        Depth-major keeps the BFS-layer character of the order: nodes
        spliced in by rewrites (recompute clones, DMA transfers) sort next
        to their structural layer, not at the back of the registration —
        DMA offloads in particular must sit early so the lifetime model
        sees the offloaded tensor die early."""
        if self._topo is not None and self._topo[0] == self._version:
            return self._topo[1]
        preds, succs = self.adjacency()
        names = list(self.nodes)
        serial = {n: i for i, n in enumerate(names)}
        indeg = {n: len(ps) for n, ps in preds.items()}
        depth = {n: 0 for n in names}
        heap = [(0, i) for i, n in enumerate(names) if indeg[n] == 0]
        heapq.heapify(heap)
        out: list[str] = []
        while heap:
            d, i = heapq.heappop(heap)
            n = names[i]
            out.append(n)
            d += 1
            for s in succs[n]:
                if depth[s] < d:
                    depth[s] = d
                indeg[s] -= 1
                if indeg[s] == 0:
                    heapq.heappush(heap, (depth[s], serial[s]))
        if len(out) != len(self.nodes):
            cyc = set(self.nodes) - set(out)
            raise GraphError(f"graph has a cycle involving {sorted(cyc)[:5]}")
        self._topo = (self._version, out)
        return out

    def validate(self) -> None:
        self.topo_order()
        # ground-truth read counts straight from the node table: the derived
        # consumer lists must mirror them exactly (multiset equality), or a
        # rewire (replace_tensor / rename_tensor_for) left a stale entry
        reads: dict[str, dict[str, int]] = {}
        for name, nd in self.nodes.items():
            for t in nd.inputs:
                m = reads.setdefault(t, {})
                m[name] = m.get(name, 0) + 1
            for t in nd.outputs:
                if self.producer.get(t) != name:
                    raise GraphError(
                        f"tensor {t!r} produced by {name!r} but producer map "
                        f"says {self.producer.get(t)!r}")
        for t, p in self.producer.items():
            if p not in self.nodes or t not in self.nodes[p].outputs:
                raise GraphError(f"producer map entry {t!r} -> {p!r} does not "
                                 "match any node output")
        for t, cs in self.consumers.items():
            spec = self.tensors[t]
            if t not in self.producer and not (
                spec.is_param or spec.is_state or spec.is_input
            ) and cs:
                raise GraphError(f"tensor {t!r} consumed but never produced and "
                                 "not a param/state/input")
            listed: dict[str, int] = {}
            for c in cs:
                listed[c] = listed.get(c, 0) + 1
            if listed != reads.get(t, {}):
                raise GraphError(
                    f"stale consumer list for {t!r}: records {listed} but "
                    f"node inputs read {reads.get(t, {})}")
        for t in reads:
            if t not in self.consumers:
                raise GraphError(f"tensor {t!r} read by nodes but has no "
                                 "consumer list")
        if self._adj is not None and self._adj[0] == self._version \
                and self._adj_dirty:
            raise GraphError(
                "adjacency cache claims the current version but has pending "
                f"patch entries for {sorted(self._adj_dirty)[:5]}")

    # -- queries ------------------------------------------------------------

    def nodes_of_kind(self, *kinds: str) -> list[str]:
        return [n for n, nd in self.nodes.items() if nd.kind in kinds]

    def total_flops(self, kinds: Iterable[str] | None = None) -> int:
        ks = set(kinds) if kinds else None
        return sum(nd.flops for nd in self.nodes.values()
                   if ks is None or nd.kind in ks)

    def param_tensors(self) -> list[TensorSpec]:
        return [t for t in self.tensors.values() if t.is_param]

    def param_bytes(self) -> int:
        return sum(t.bytes for t in self.param_tensors())

    def activation_edges(self) -> list[str]:
        """Tensors produced by fwd nodes and consumed by bwd nodes — the set
        𝒜 of checkpointable activations (paper §II-A, Eq. 6)."""
        bwd_kinds = {"bwd", "bwd_data", "bwd_weight", "bwd_bias", "loss_bwd"}
        out = []
        for t, prod in self.producer.items():
            if self.nodes[prod].kind not in ("fwd", "loss"):
                continue
            if any(self.nodes[c].kind in bwd_kinds for c in self.consumers.get(t, [])):
                out.append(t)
        return sorted(out)

    def activation_bytes(self) -> int:
        return sum(self.tensors[t].bytes for t in self.activation_edges())

    # -- editing ------------------------------------------------------------

    def copy(self) -> "WorkloadGraph":
        g = WorkloadGraph(self.name)
        g.tensors = dict(self.tensors)
        nodes = g.nodes
        for nd in self.nodes.values():
            # fast clone: bulk __dict__ copy (carries cached op_class/macs),
            # then fresh instances of the mutable fields only
            n2 = Node.__new__(Node)
            n2.__dict__.update(nd.__dict__)
            n2.dims = dict(nd.dims)
            n2.inputs = list(nd.inputs)
            n2.outputs = list(nd.outputs)
            n2.meta = dict(nd.meta)
            nodes[nd.name] = n2
        g.producer = dict(self.producer)
        # consumer lists are shared copy-on-write: either side's first
        # mutation of a tensor's list splits it (see _own_consumers)
        g.consumers = dict(self.consumers)
        shared = set(self.consumers)
        g._shared_cons = shared
        self._shared_cons |= shared
        g._version = 1
        # carry over fresh derived/structural caches: clones start
        # clean-dirty, so later edits on the copy only pay their delta
        if self._adj is not None and self._adj[0] == self._version:
            g._adj = (1, dict(self._adj[1]), dict(self._adj[2]))
        if self._topo is not None and self._topo[0] == self._version:
            g._topo = (1, self._topo[1])
        for tag, payload in self._derived.items():
            if getattr(payload, "version", None) == self._version and \
                    hasattr(payload, "clone"):
                g._derived[tag] = payload.clone(g._version)
        return g

    def replace_tensor(self, spec: TensorSpec) -> TensorSpec:
        """Re-spec an existing tensor in place (e.g. a parallelism transform
        sharding a weight to 1/tp of its bytes).  The producer and every
        consumer are marked dirty so engine signature tables re-sign them
        with the new byte counts."""
        if spec.name not in self.tensors:
            raise GraphError(f"replace_tensor: unknown tensor {spec.name!r}")
        self.tensors[spec.name] = spec
        self._version += 1
        self._dirty_tensors.add(spec.name)
        p = self.producer.get(spec.name)
        if p is not None:
            self._dirty_nodes.add(p)
        for c in self.consumers.get(spec.name, ()):
            self._dirty_nodes.add(c)
        return spec

    def retune_node(self, name: str, dims: dict | None = None,
                    flops: int | None = None) -> Node:
        """Rewrite a node's loop dims / flop count in place (parallelism
        transforms scale the contraction dim by 1/tp).  Bumps the structural
        version and dirties the node so cached signatures re-derive."""
        nd = self.nodes[name]
        if dims is not None:
            nd.dims = dict(dims)
        if flops is not None:
            nd.flops = int(flops)
            nd.__dict__.pop("macs", None)     # cached_property on flops
        self._version += 1
        self._dirty_nodes.add(name)
        return nd

    def rename_tensor_for(self, node: str, old: str, new: str) -> None:
        """Rewire one consumer edge: ``node`` reads ``new`` instead of ``old``."""
        nd = self.nodes[node]
        if old not in nd.inputs:
            raise GraphError(f"{node} does not read {old}")
        k = nd.inputs.count(old)
        nd.inputs = [new if t == old else t for t in nd.inputs]
        # the consumer lists hold one entry per read — rewire all k of them,
        # not just the first, or a duplicate input leaves a stale entry
        cs = self._own_consumers(old)
        for _ in range(k):
            cs.remove(node)
        self._own_consumers(new).extend([node] * k)
        self._version += 1
        self._dirty_nodes.add(node)
        if self._adj is not None:
            self._adj_dirty.add(node)
            for t in (old, new):
                p = self.producer.get(t)
                if p is not None:
                    self._adj_dirty.add(p)

    # -- misc ---------------------------------------------------------------

    def __len__(self) -> int:
        return len(self.nodes)

    def __repr__(self) -> str:
        return (f"WorkloadGraph({self.name!r}, nodes={len(self.nodes)}, "
                f"tensors={len(self.tensors)}, "
                f"GFLOPs={self.total_flops() / 1e9:.2f})")

    def summary(self) -> dict:
        kinds: dict[str, int] = {}
        for nd in self.nodes.values():
            kinds[nd.kind] = kinds.get(nd.kind, 0) + 1
        return {
            "nodes": len(self.nodes),
            "tensors": len(self.tensors),
            "flops": self.total_flops(),
            "param_bytes": self.param_bytes(),
            "activation_edges": len(self.activation_edges()),
            "activation_bytes": self.activation_bytes(),
            "kinds": kinds,
        }
