"""Multi-accelerator parallel-training modeling (edge boards → data centers).

MONET's title promises modeling "from Edge to Data Centers"; this module adds
the scale axis: one training iteration of a workload graph executed across a
:class:`~repro.core.accelerators.ClusterSpec` of identical HDAs under a
:class:`ParallelStrategy` combining

* **data parallelism** (``data``)    — each chip holds a full replica and a
  1/dp batch slice; parameter gradients are all-reduced before the optimizer
  (or reduce-scattered + all-gathered under ZeRO, ``zero=True``);
* **tensor parallelism** (``tensor``) — weights of conv/GEMM layers are
  sharded along the contraction dimension (Megatron-style row parallelism):
  each chip computes a partial output that is all-reduced in the forward
  pass and all-gathered on the data-gradient side of the backward pass;
* **pipeline parallelism** (``pipeline``) — the layer graph is split into
  flop-balanced contiguous stages with point-to-point send/recv at the
  boundaries; ``microbatches`` interleave 1F1B-style, paying the classic
  (m + pp − 1)/m bubble.

The transformation is a *graph rewrite*: collective-communication nodes
(``all_reduce`` / ``all_gather`` / ``reduce_scatter`` / ``send`` / ``recv``,
op-class ``comm``) are spliced into the per-chip :class:`WorkloadGraph`, so
the existing scheduler treats the interconnect as one more resource that
overlaps with compute, the liveness pass sees true per-chip footprints, and
the signature-memoizing engine caches every (graph, partition, chip)
evaluation — parallelization degrees live in the comm-node dims, hence in
the node signatures (see docs/parallelism.md).

Conventions: the input :class:`TrainingGraph` is built at the **per-chip,
per-microbatch local batch** (the way an SPMD program is written per
device); global batch = local_batch × data × microbatches.

The port's own copy of ``repro.core.parallel`` (numpy and plain Python):
names, signatures and numeric code are the reference's, held bit for
bit against it by ``tests/test_torch_parallel.py``.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field

from .accelerators import ClusterSpec
from .cost_model import collective_wire, comm_payload
from .fusion import FusionConfig
from .graph import Node, TensorSpec, WorkloadGraph, dtype_bytes
from .scheduling import ScheduleResult, schedule
from .training_transform import TrainingGraph


# ---------------------------------------------------------------------------
# strategies
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ParallelStrategy:
    """dp × tp × pp decomposition of a cluster (chips = data·tensor·pipeline).

    ``microbatches`` only matters for pipeline > 1 (bubble amortization) and
    for data parallelism it plays the role of gradient-accumulation steps.
    ``zero`` switches gradient synchronization from all-reduce to
    reduce-scatter + parameter all-gather with optimizer state sharded
    across the dp group."""

    data: int = 1
    tensor: int = 1
    pipeline: int = 1
    microbatches: int = 1
    zero: bool = False

    def __post_init__(self):
        for k in ("data", "tensor", "pipeline", "microbatches"):
            if getattr(self, k) < 1:
                raise ValueError(f"{k} must be >= 1")

    @property
    def chips(self) -> int:
        return self.data * self.tensor * self.pipeline

    @property
    def label(self) -> str:
        parts = []
        if self.data > 1:
            parts.append(f"dp{self.data}{'z' if self.zero else ''}")
        if self.tensor > 1:
            parts.append(f"tp{self.tensor}")
        if self.pipeline > 1:
            parts.append(f"pp{self.pipeline}")
        name = "+".join(parts) or "single"
        if self.microbatches > 1:
            name += f"@mb{self.microbatches}"
        return name


def strategy_space(n_chips: int, microbatches: int | None = None,
                   include_zero: bool = False) -> list[ParallelStrategy]:
    """Every (dp, tp, pp) factorization of ``n_chips`` (plus ZeRO variants
    of the dp-containing ones when ``include_zero``).  Pipeline strategies
    default to ``microbatches = 2·pp`` so the bubble is amortized."""
    out: list[ParallelStrategy] = []
    for dp in range(1, n_chips + 1):
        if n_chips % dp:
            continue
        rest = n_chips // dp
        for tp in range(1, rest + 1):
            if rest % tp:
                continue
            pp = rest // tp
            mb = microbatches if microbatches is not None else \
                (2 * pp if pp > 1 else 1)
            out.append(ParallelStrategy(dp, tp, pp, mb))
            if include_zero and dp > 1:
                out.append(ParallelStrategy(dp, tp, pp, mb, zero=True))
    return out


# ---------------------------------------------------------------------------
# graph rewrites
# ---------------------------------------------------------------------------


def _shard_shape(shape: tuple, dim: int, k: int) -> tuple | None:
    if dim >= len(shape) or shape[dim] % k:
        return None
    return tuple(s // k if i == dim else s for i, s in enumerate(shape))


def _comm_node(g: WorkloadGraph, op: str, tensor: str, degree: int,
               out_name: str, out_shape: tuple | None = None,
               kind: str = "comm", payload: int | None = None,
               consumers: list | None = None) -> str:
    """Splice a collective after ``tensor``: consumers listed in
    ``consumers`` (default: all current ones) are rewired to the collective's
    output.  ``payload`` is the *full* (unsharded) element count the wire
    formulas apply to (default: the tensor's)."""
    spec = g.tensors[tensor]
    cons = consumers if consumers is not None \
        else list(g.consumers.get(tensor, ()))
    g.add_tensor(TensorSpec(out_name, out_shape or spec.shape, spec.dtype))
    dims = dict(N=int(payload if payload is not None else spec.size),
                P=int(degree), E=dtype_bytes(spec.dtype))
    g.add_node(Node(f"{op}:{tensor}", op, kind, dims,
                    [tensor], [out_name], 0))
    for c in cons:
        g.rename_tensor_for(c, tensor, out_name)
    return out_name


# -- tensor parallelism ------------------------------------------------------

#: per-op (dims key holding the sharded contraction/output dim)
_TP_DIM = {"conv": "C", "conv_dw": "C", "conv_bwd_data": "K",
           "conv_bwd_weight": "C", "gemm": "K", "gemm_bwd_data": "N",
           "gemm_bwd_weight": "M"}


def _scale_node(g: WorkloadGraph, name: str, key: str, k: int) -> None:
    nd = g.nodes[name]
    d = dict(nd.dims)
    d[key] = max(1, d[key] // k)
    g.retune_node(name, dims=d, flops=nd.flops // k)


def _apply_tensor_parallel(g: WorkloadGraph, tp: int) -> list[str]:
    """Shard conv/GEMM weights 1/tp along the contraction dim, scale the
    touched forward/backward/optimizer nodes, and splice the Megatron-style
    collectives (fwd partial-sum all-reduce, bwd data-grad all-gather).
    Returns the list of sharded parameter tensors."""
    sharded: list[str] = []
    if tp <= 1:
        return sharded
    # shardable (param, fwd node) pairs: the weight operand of conv/gemm
    pairs = []
    for nd in list(g.nodes.values()):
        if nd.kind != "fwd" or nd.op not in ("conv", "conv_dw", "gemm"):
            continue
        if len(nd.inputs) < 2:
            continue
        w = nd.inputs[1]
        spec = g.tensors[w]
        if not spec.is_param:
            continue
        wdim = 1 if nd.op.startswith("conv") else 0   # C of (K,C,F,F) | K_in
        if _shard_shape(spec.shape, wdim, tp) is None:
            continue
        pairs.append((w, wdim, nd.name))

    by_source: dict[str, list[Node]] = {}
    for nd in g.nodes.values():
        if nd.source is not None:
            by_source.setdefault(nd.source, []).append(nd)
    opt_of: dict[str, list[str]] = {}
    for nd in g.nodes.values():
        if nd.kind == "opt":
            opt_of.setdefault(nd.meta.get("param", ""), []).append(nd.name)

    for w, wdim, fwd_name in pairs:
        orig = g.tensors[w].shape
        # 1. shard the weight and every same-shaped derived tensor
        #    (grads, accumulation buffers, optimizer states, .next)
        related = [t for t in g.tensors
                   if t == w or t == f"d:{w}" or
                   t.startswith((f"d:{w}@", f"d:{w}.acc")) or
                   t in (f"m:{w}", f"v:{w}", f"m:{w}.next", f"v:{w}.next",
                         f"{w}.next")]
        for t in related:
            spec = g.tensors[t]
            if spec.shape != orig:
                continue
            g.replace_tensor(
                TensorSpec(t, _shard_shape(spec.shape, wdim, tp), spec.dtype,
                           spec.is_param, spec.is_state, spec.is_input))
        # transposes of the weight (gemm backward) shard the mirrored dim
        for c in list(g.consumers.get(w, ())):
            cnd = g.nodes[c]
            if cnd.op != "transpose":
                continue
            for o in cnd.outputs:
                ospec = g.tensors[o]
                tdim = len(ospec.shape) - 1 - wdim
                ns = _shard_shape(ospec.shape, tdim, tp)
                if ns is not None:
                    g.replace_tensor(TensorSpec(o, ns, ospec.dtype))
            _scale_node(g, c, "N", tp)

        # 2. scale the compute nodes that contract over the sharded dim
        fwd_nd = g.nodes[fwd_name]
        _scale_node(g, fwd_name, _TP_DIM[fwd_nd.op], tp)
        bwd_data_outs: list[str] = []
        for b in by_source.get(fwd_name, ()):
            if b.op in ("conv_bwd_data", "gemm_bwd_data") and \
                    b.kind == "bwd_data":
                _scale_node(g, b.name, _TP_DIM[b.op], tp)
                bwd_data_outs.extend(b.outputs)
            elif b.op in ("conv_bwd_weight", "gemm_bwd_weight") and \
                    b.kind == "bwd_weight":
                _scale_node(g, b.name, _TP_DIM[b.op], tp)
        # optimizer + gradient-accumulation element-wise work is sharded too
        for name in opt_of.get(w, ()):
            _scale_node(g, name, "N", tp)
        for nd in list(g.nodes.values()):
            if nd.name.startswith(f"accum_{w}."):
                _scale_node(g, nd.name, "N", tp)

        # 3. collectives: fwd partial sums all-reduced (output is full-size),
        #    bwd data grads all-gathered (each chip built a 1/tp slice)
        for y in list(fwd_nd.outputs):
            _comm_node(g, "all_reduce", y, tp, f"{y}.tpar", kind="fwd")
        for dx in bwd_data_outs:
            _comm_node(g, "all_gather", dx, tp, f"{dx}.tpag")
        sharded.append(w)
    return sharded


# -- data parallelism --------------------------------------------------------


def _apply_data_parallel(g: WorkloadGraph, param_grads: dict,
                         dp: int) -> None:
    """Plain DP gradient synchronization: all-reduce each parameter gradient
    across the dp group before its optimizer consumers."""
    if dp <= 1:
        return
    for dg in param_grads.values():
        if dg not in g.tensors:
            continue
        opt_cons = [c for c in list(g.consumers.get(dg, ()))
                    if g.nodes[c].kind == "opt"]
        if not opt_cons:
            continue
        _comm_node(g, "all_reduce", dg, dp, f"{dg}.dpar", consumers=opt_cons)


def _apply_zero(g: WorkloadGraph, param_grads: dict, dp: int) -> None:
    """ZeRO-style DP: reduce-scatter the gradient, run the optimizer on the
    1/dp shard (states sharded too), all-gather the updated parameter."""
    if dp <= 1:
        return
    for p, dg in param_grads.items():
        if dg not in g.tensors:
            continue
        spec = g.tensors[dg]
        opt_cons = [c for c in list(g.consumers.get(dg, ()))
                    if g.nodes[c].kind == "opt"]
        if not opt_cons:
            continue
        shard = _shard_shape(spec.shape, 0, dp)
        if shard is None:
            _comm_node(g, "all_reduce", dg, dp, f"{dg}.dpar",
                       consumers=opt_cons)
            continue
        _comm_node(g, "reduce_scatter", dg, dp, f"{dg}.dprs",
                   out_shape=shard, consumers=opt_cons, payload=spec.size)
        # optimizer + states live on the shard
        for t in (f"m:{p}", f"v:{p}", f"m:{p}.next", f"v:{p}.next",
                  f"{p}.next"):
            ts = g.tensors.get(t)
            if ts is None:
                continue
            ns = _shard_shape(ts.shape, 0, dp)
            if ns is not None:
                g.replace_tensor(TensorSpec(t, ns, ts.dtype, ts.is_param,
                                            ts.is_state, ts.is_input))
        for c in opt_cons:
            nd = g.nodes[c]
            d = dict(nd.dims)
            d["N"] = max(1, d["N"] // dp)
            g.retune_node(c, dims=d, flops=nd.flops // dp)
        # … and the updated parameter shard is gathered back for the next step
        nxt = f"{p}.next"
        if nxt in g.tensors and g.tensors[nxt].shape == shard:
            _comm_node(g, "all_gather", nxt, dp, f"{nxt}.dpag",
                       out_shape=spec.shape, consumers=[],
                       payload=spec.size)


# -- pipeline parallelism ----------------------------------------------------


def _stage_assignment(g: WorkloadGraph, pp: int) -> dict[str, int]:
    """Flop-balanced contiguous split of the forward pass; every backward /
    optimizer / collective node rides with the stage of the forward node it
    derives from (1F1B co-location)."""
    order = g.topo_order()
    fwd = [n for n in order if g.nodes[n].kind in ("fwd", "loss")]
    if pp > len(fwd):
        raise ValueError(f"pipeline degree {pp} > {len(fwd)} forward nodes")
    total = sum(max(g.nodes[n].flops, 1) for n in fwd) or 1
    stage: dict[str, int] = {}
    acc, s = 0, 0
    remaining = len(fwd)
    for n in fwd:
        # advance on the flop quota — or by force, so that every trailing
        # stage still receives at least one forward node
        if s < pp - 1 and (acc > (s + 1) * total / pp or
                           remaining <= pp - 1 - s):
            s += 1
        stage[n] = s
        acc += max(g.nodes[n].flops, 1)
        remaining -= 1

    producer = g.producer
    unresolved: list[str] = []
    for n in order:
        if n in stage:
            continue
        nd = g.nodes[n]
        if nd.source is not None and nd.source in stage:
            stage[n] = stage[nd.source]
            continue
        ps = [stage[producer[t]] for t in nd.inputs
              if t in producer and producer[t] in stage]
        if ps:
            stage[n] = max(ps)
        else:
            unresolved.append(n)
    # nodes fed only by params (weight transposes): place with a consumer
    for n in reversed(order):
        if n not in unresolved:
            continue
        cs = [stage[c] for t in g.nodes[n].outputs
              for c in g.consumers.get(t, ()) if c in stage]
        stage[n] = min(cs) if cs else 0
    return stage


def _split_stages(g: WorkloadGraph, pp: int) -> list[WorkloadGraph]:
    """Cut the per-chip graph into ``pp`` stage graphs with explicit
    ``send``/``recv`` nodes for every activation crossing a boundary."""
    if pp <= 1:
        return [g]
    stage = _stage_assignment(g, pp)
    order = g.topo_order()
    nodes_of = [[n for n in order if stage[n] == s] for s in range(pp)]

    # boundary tensors: produced in stage s, consumed in another stage
    cross: dict[str, tuple[int, set]] = {}
    for t, prod in g.producer.items():
        targets = {stage[c] for c in g.consumers.get(t, ())} - {stage[prod]}
        if targets:
            cross[t] = (stage[prod], targets)

    out: list[WorkloadGraph] = []
    for s in range(pp):
        sg = WorkloadGraph(f"{g.name}.pp{s}of{pp}")
        referenced: set = set()
        for n in nodes_of[s]:
            nd = g.nodes[n]
            referenced.update(nd.inputs)
            referenced.update(nd.outputs)
        for t in referenced:
            sg.add_tensor(g.tensors[t])
        # receives first (they produce boundary tensors consumed here); a
        # recv of a forward activation keeps kind 'fwd' so the stage's
        # activation-set accounting still sees it, gradients stay neutral
        for t, (_ps, targets) in cross.items():
            if s in targets:
                spec = g.tensors[t]
                if t not in sg.tensors:
                    sg.add_tensor(spec)
                rkind = "fwd" if g.nodes[g.producer[t]].kind in \
                    ("fwd", "loss") else "comm"
                sg.add_node(Node(f"recv:{t}", "recv", rkind,
                                 dict(N=spec.size, P=2,
                                      E=dtype_bytes(spec.dtype)),
                                 [], [t], 0))
        for n in nodes_of[s]:
            nd = g.nodes[n]
            sg.add_node(Node(nd.name, nd.op, nd.kind, dict(nd.dims),
                             list(nd.inputs), list(nd.outputs), nd.flops,
                             nd.source, dict(nd.meta)))
        # one send per destination stage: a tensor fanning out to several
        # stages is transmitted once per consumer in a p2p model
        for t, (ps, targets) in cross.items():
            if ps == s:
                spec = g.tensors[t]
                for dst in sorted(targets):
                    sg.add_tensor(TensorSpec(f"{t}.sent{dst}", (1,), "int8"))
                    sg.add_node(Node(f"send{dst}:{t}", "send", "comm",
                                     dict(N=spec.size, P=2,
                                          E=dtype_bytes(spec.dtype)),
                                     [t], [f"{t}.sent{dst}"], 0))
        sg.validate()
        out.append(sg)
    return out


# ---------------------------------------------------------------------------
# plan + evaluation
# ---------------------------------------------------------------------------


@dataclass
class ParallelPlan:
    """Per-chip stage graphs of one (training graph × strategy × cluster)."""

    strategy: ParallelStrategy
    cluster: ClusterSpec
    stage_graphs: list = field(default_factory=list)
    sharded_params: list = field(default_factory=list)

    def __repr__(self):
        return (f"ParallelPlan({self.strategy.label}, "
                f"stages={len(self.stage_graphs)}, "
                f"cluster={self.cluster.name})")


class _CachedRewrite:
    """One memoized collective-injection rewrite: the per-stage graph
    skeletons plus every derived artifact that is a pure function of the
    rewritten content — per-microbatch bodies, per-topology wire bytes,
    manual-fusion partitions and degrade-coherence findings.  Consumers
    treat the stage graphs as **immutable**; mutating one would poison the
    cache (docs/parallelism.md, rewrite-cache invalidation rules)."""

    __slots__ = ("stages", "sharded", "bodies", "wires", "parts",
                 "degrade_findings")

    def __init__(self, stages: list, sharded: list):
        self.stages = stages
        self.sharded = sharded
        self.bodies: list | None = None   # per stage: body graph | False
        self.wires: dict = {}             # ici_topology -> {(si, body): B}
        self.parts: dict = {}             # (si, body) -> (part, quotient)
        self.degrade_findings: dict = {}  # survivors -> verify_degrade list


#: strategy-keyed rewrite cache: (graph fingerprint, signature generation,
#: strategy, param-grad map) -> _CachedRewrite.  The fingerprint is derived
#: from the interned signature tables, so mutating the training graph (its
#: ``_version`` bumps) or clearing the intern table (``_SIG_GEN`` bumps)
#: naturally invalidates without any explicit hook; the cluster is *not*
#: part of the key because the rewrite itself is cluster-independent (the
#: chips==n_chips check runs before the copy, and chip parameters only
#: enter at scheduling time).
_REWRITES: OrderedDict = OrderedDict()
_REWRITES_CAP = 64
rewrite_cache_stats = dict(hits=0, misses=0)


def _run_rewrites(tg: TrainingGraph,
                  strategy: ParallelStrategy) -> _CachedRewrite:
    g = tg.graph.copy()
    sharded = _apply_tensor_parallel(g, strategy.tensor)
    if strategy.zero:
        _apply_zero(g, tg.param_grads, strategy.data)
    else:
        _apply_data_parallel(g, tg.param_grads, strategy.data)
    stages = _split_stages(g, strategy.pipeline)
    return _CachedRewrite(stages, sharded)


def _rewrite(tg: TrainingGraph, strategy: ParallelStrategy) -> _CachedRewrite:
    """The memoized rewrite.  Under ``REPRO_SANITIZE`` the cache is bypassed
    in both directions (never served, never populated) so the sanitizer's
    shadow verification always sees a freshly constructed rewrite."""
    from .verify import sanitize_enabled
    if sanitize_enabled():
        return _run_rewrites(tg, strategy)
    from . import engine as _engine_mod
    from .engine import _fingerprint, graph_sigs
    fp = _fingerprint(tg.graph, graph_sigs(tg.graph))
    key = (fp, _engine_mod._SIG_GEN, strategy,
           tuple(sorted(tg.param_grads.items())))
    ent = _REWRITES.get(key)
    if ent is not None:
        _REWRITES.move_to_end(key)
        rewrite_cache_stats["hits"] += 1
        return ent
    rewrite_cache_stats["misses"] += 1
    ent = _run_rewrites(tg, strategy)
    _REWRITES[key] = ent
    while len(_REWRITES) > _REWRITES_CAP:
        _REWRITES.popitem(last=False)
    return ent


def parallelize(tg: TrainingGraph, strategy: ParallelStrategy,
                cluster: ClusterSpec) -> ParallelPlan:
    """Rewrite ``tg`` (built at the per-chip local batch) into per-stage,
    per-chip graphs with collective nodes for ``strategy`` on ``cluster``.
    The rewrite is served from the strategy-keyed cache when warm, so the
    returned plan shares its stage graphs with every other plan of the same
    (graph, strategy) — they carry warm signature tables and must be
    treated as read-only."""
    if strategy.chips != cluster.n_chips:
        raise ValueError(f"strategy needs {strategy.chips} chips, cluster "
                         f"has {cluster.n_chips}")
    ent = _rewrite(tg, strategy)
    return ParallelPlan(strategy, cluster, ent.stages, list(ent.sharded))


#: outputs of the once-per-iteration gradient-sync collectives (plain DP
#: all-reduce, ZeRO reduce-scatter / parameter all-gather)
_ITER_TAIL_SUFFIXES = (".dpar", ".dprs", ".dpag")


def _strip_iteration_tail(g: WorkloadGraph) -> WorkloadGraph | None:
    """Per-microbatch *body* of a stage graph: the optimizer step and the
    data-parallel gradient synchronization run once per iteration, not once
    per microbatch — drop them (and everything downstream of them) so the
    iteration composition can charge them exactly once.  Returns ``None``
    when the stage has no iteration tail (body == full graph)."""
    removed: set = set()
    for nd in g.nodes.values():
        if nd.kind == "opt":
            removed.add(nd.name)
        elif nd.op_class == "comm" and nd.outputs and \
                nd.outputs[0].endswith(_ITER_TAIL_SUFFIXES):
            removed.add(nd.name)
    if not removed:
        return None
    order = g.topo_order()
    gone_t: set = set()
    for n in order:                      # cascade through consumers
        nd = g.nodes[n]
        if n in removed or any(t in gone_t for t in nd.inputs):
            removed.add(n)
            gone_t.update(nd.outputs)
    body = WorkloadGraph(f"{g.name}.body")
    for n in order:
        if n in removed:
            continue
        nd = g.nodes[n]
        for t in (*nd.inputs, *nd.outputs):
            if t not in body.tensors:
                body.add_tensor(g.tensors[t])
        body.add_node(Node(nd.name, nd.op, nd.kind, dict(nd.dims),
                           list(nd.inputs), list(nd.outputs), nd.flops,
                           nd.source, dict(nd.meta)))
    body.validate()
    return body


def graph_wire_bytes(g: WorkloadGraph, topology: str = "ring") -> float:
    """Σ per-chip interconnect bytes of every collective node in ``g``."""
    total = 0.0
    for nd in g.nodes.values():
        if nd.op_class != "comm":
            continue
        wire, _ = collective_wire(nd.op, comm_payload(nd.dims),
                                  int(nd.dims.get("P", 1)), topology)
        total += wire
    return total


@dataclass
class ParallelResult:
    """One iteration of parallel training on a cluster (cluster totals;
    latency in chip cycles, energy in pJ, memory per chip in bytes)."""

    strategy: ParallelStrategy
    cluster: str
    n_chips: int
    latency: float
    energy: float
    peak_mem: float              # max per-chip footprint incl 1F1B in-flight
    offchip_bytes: float         # cluster total per iteration
    wire_bytes: float            # cluster total inter-chip bytes / iteration
    throughput: float            # samples / second
    feasible: bool
    samples_per_iter: int
    spill_bytes: float = 0.0     # cluster total DMA offload bytes / iteration
    stage_results: list = field(default_factory=list)   # full stage graphs
    body_results: list = field(default_factory=list)    # per-microbatch body
    findings: list = field(default_factory=list)        # verifier report

    def as_row(self) -> dict:
        return dict(strategy=self.strategy.label, chips=self.n_chips,
                    dp=self.strategy.data, tp=self.strategy.tensor,
                    pp=self.strategy.pipeline,
                    microbatches=self.strategy.microbatches,
                    latency=self.latency, energy=self.energy,
                    peak_mem=self.peak_mem, offchip_bytes=self.offchip_bytes,
                    wire_bytes=self.wire_bytes, throughput=self.throughput,
                    feasible=self.feasible,
                    samples_per_iter=self.samples_per_iter,
                    spill_bytes=self.spill_bytes)


def _local_batch(g: WorkloadGraph) -> int:
    for spec in g.tensors.values():
        if spec.is_input and spec.shape:
            return int(spec.shape[0])
    return 1


def evaluate_parallel(tg: TrainingGraph, cluster: ClusterSpec,
                      strategy: ParallelStrategy, fusion: str = "manual",
                      fusion_cfg: FusionConfig | None = None,
                      engine=None, use_engine: bool = True) -> ParallelResult:
    """Schedule every pipeline stage of the parallelized graph on the
    cluster's chip and compose the iteration estimate.

    Each stage is costed twice: the per-microbatch *body* (the stage graph
    minus the optimizer step and the data-parallel gradient sync — those run
    once per iteration) and the *full* graph whose extra latency is the
    iteration tail, so gradient accumulation / pipelining never multiply the
    optimizer or the gradient all-reduce by ``microbatches``:

    * latency   = (m + pp − 1) · max-body-latency + max tail (1F1B bubble);
    * energy    = per chip: (m−1) × body energy + full energy + idle
      leakage over the bubble, summed over all dp·tp·pp chips;
    * peak mem  = per-chip schedule peak + (in-flight − 1) extra microbatch
      activation copies on early stages (1F1B holds min(pp − s, m)
      microbatches), checked against the cluster's per-chip memory capacity.

    ``use_engine=False`` forces the uncached reference cost path — the
    parity tests require bit-for-bit agreement with the default."""
    if strategy.chips != cluster.n_chips:
        raise ValueError(f"strategy needs {strategy.chips} chips, cluster "
                         f"has {cluster.n_chips}")
    ent = _rewrite(tg, strategy)
    plan = ParallelPlan(strategy, cluster, ent.stages, list(ent.sharded))
    chip = cluster.chip
    m = strategy.microbatches
    pp = strategy.pipeline
    # manual-fusion partitions depend only on graph structure (never on the
    # chip or the engine), so they live on the cached rewrite; other fusion
    # modes are chip-aware and recompute per call
    cache_parts = fusion == "manual" and fusion_cfg is None
    wires = ent.wires.setdefault(chip.ici_topology, {})

    def run(sg, pkey):
        # shared fusion-mode dispatcher; fusion="search" gives every
        # pipeline stage its own boundary-genome search, with comm
        # send/recv nodes pinned to singleton 'ici' groups
        from .fusion_search import fusion_partition
        pq = ent.parts.get(pkey) if cache_parts else None
        if pq is None:
            pq = fusion_partition(sg, chip, fusion, fusion_cfg, engine)
            if cache_parts:
                ent.parts[pkey] = pq
        part, quotient = pq
        return schedule(sg, chip, part, engine=engine,
                        use_engine=use_engine, quotient=quotient)

    def wire_of(sg, wkey):
        w = wires.get(wkey)
        if w is None:
            w = wires[wkey] = graph_wire_bytes(sg, chip.ici_topology)
        return w

    if ent.bodies is None:
        ent.bodies = [None] * len(ent.stages)
    results: list[ScheduleResult] = []      # full stage graphs
    bodies: list[ScheduleResult] = []       # per-microbatch bodies
    wire_full: list[float] = []
    wire_body: list[float] = []
    for si, sg in enumerate(plan.stage_graphs):
        r_full = run(sg, (si, False))
        wf = wire_of(sg, (si, False))
        if m > 1:
            bg = ent.bodies[si]
            if bg is None:
                bg = _strip_iteration_tail(sg)
                ent.bodies[si] = bg if bg is not None else False
            elif bg is False:
                bg = None               # memoized "no iteration tail"
            r_body = run(bg, (si, True)) if bg is not None else r_full
            wb = wire_of(bg, (si, True)) if bg is not None else wf
        else:
            r_body, wb = r_full, wf
        results.append(r_full)
        bodies.append(r_body)
        wire_full.append(wf)
        wire_body.append(wb)

    t_body = max(r.latency for r in bodies)
    tail = max(max(f.latency - b.latency, 0.0)
               for f, b in zip(results, bodies, strict=True))
    latency = (m + pp - 1) * t_body + tail
    leak = chip.leak_per_cycle()
    replicas = strategy.data * strategy.tensor
    energy = offchip = wire = spill = 0.0
    for f, b, wf, wb in zip(results, bodies, wire_full, wire_body, strict=True):
        active = (m - 1) * b.latency + f.latency
        energy += (m - 1) * b.energy + f.energy + (latency - active) * leak
        offchip += (m - 1) * b.offchip_bytes + f.offchip_bytes
        wire += (m - 1) * wb + wf
        spill += (m - 1) * b.spill_bytes + f.spill_bytes
    energy *= replicas
    offchip *= replicas
    wire *= replicas
    spill *= replicas
    # 1F1B: stage s holds the activations of min(pp - s, m) in-flight
    # microbatches.  The per-copy charge is the *lifetime-based* peak
    # activation residency from the unified memory model (act_peak), not the
    # Σ-of-𝒜 heuristic: recomputed/offloaded activations never reach the
    # residency peak, so policy rewrites now shrink the parallel footprint.
    peaks = [r.peak_mem + (min(pp - s, m) - 1) * r.act_peak
             for s, r in enumerate(results)]
    peak = max(peaks)
    feasible = (cluster.mem_capacity <= 0) or (peak <= cluster.mem_capacity)
    samples = _local_batch(tg.graph) * strategy.data * m
    seconds = latency / (chip.freq_ghz * 1e9)
    # parallel-symmetry scan (M030-M032, docs/verify.md): collective degrees
    # vs the strategy, send/recv pairing across stages, shard-byte totals.
    # Cheap (pure bookkeeping), so it is always on; per-stage structural
    # verification is the sanitizer's job (schedule() cache misses).
    from .verify import sanitize_enabled, verify_graph, verify_parallel
    findings = verify_parallel(tg, plan)
    if sanitize_enabled():
        for sg in plan.stage_graphs:
            findings += verify_graph(sg)
        errors = [f for f in findings if f.severity == "error"]
        if errors:
            from .verify import VerificationError
            raise VerificationError(errors)
    return ParallelResult(
        strategy=strategy, cluster=cluster.name, n_chips=cluster.n_chips,
        latency=latency, energy=energy, peak_mem=peak,
        offchip_bytes=offchip, wire_bytes=wire,
        throughput=samples / max(seconds, 1e-30), feasible=feasible,
        samples_per_iter=samples, spill_bytes=spill,
        stage_results=results, body_results=bodies, findings=findings)


# ---------------------------------------------------------------------------
# joint GA: strategy × checkpointing budget (NSGA-II, integer genome)
# ---------------------------------------------------------------------------


def ga_parallel(tg: TrainingGraph, make_cluster, chip_counts: list,
                keep_fracs: tuple = (1.0, 0.75, 0.5, 0.25),
                pop_size: int = 16, generations: int = 8, seed: int = 0,
                fusion: str = "manual", snapshot_every: int = 0,
                snapshot_path: str | None = None,
                resume: dict | str | None = None,
                max_seconds: float | None = None,
                max_evals: int | None = None,
                use_batch: bool = True):
    """Joint search over (chip count × parallelism strategy × activation-
    checkpointing budget) with NSGA-II over an integer genome, minimizing
    (−throughput, energy, per-chip peak mem).  ``make_cluster(n)`` builds
    the ClusterSpec for ``n`` chips.  Returns (NSGA2Result, decode) where
    ``decode(genome)`` yields the (cluster, strategy, keep_frac) triple.

    ``seed`` fixes the whole trajectory (same seed ⇒ identical fronts);
    ``snapshot_every``/``snapshot_path``/``resume`` and
    ``max_seconds``/``max_evals`` are forwarded to
    :func:`repro.core.nsga2.nsga2_int` for crash-resumable, budget-bounded
    search (docs/resilience.md)."""
    from .checkpointing import knapsack_baseline, stored_activation_bytes
    from .nsga2 import nsga2_int

    spaces = {n: strategy_space(n) for n in chip_counts}
    total_act = stored_activation_bytes(tg, tg.activations)
    max_strats = max(len(s) for s in spaces.values())
    bounds = [(0, len(chip_counts) - 1), (0, max_strats - 1),
              (0, len(keep_fracs) - 1)]

    def decode(genome):
        n = chip_counts[int(genome[0]) % len(chip_counts)]
        strats = spaces[n]
        strat = strats[int(genome[1]) % len(strats)]
        frac = keep_fracs[int(genome[2]) % len(keep_fracs)]
        return make_cluster(n), strat, frac

    cache: dict[tuple, tuple] = {}

    def evaluate(genome):
        cluster, strat, frac = decode(genome)
        key = (cluster.n_chips, strat, frac)
        if key in cache:
            return cache[key]
        work = tg
        if frac < 1.0:
            from .checkpointing import apply_checkpointing
            kept, _ = knapsack_baseline(tg, int(total_act * frac))
            work = TrainingGraph(apply_checkpointing(tg, set(kept)),
                                 tg.param_grads, list(kept), tg.optimizer)
        try:
            r = evaluate_parallel(work, cluster, strat, fusion=fusion)
        except ValueError:
            # inapplicable genome (e.g. pipeline degree > forward nodes):
            # heavily penalized instead of aborting the GA
            out = (0.0, float("inf"), float("inf"))
            cache[key] = out
            return out
        penalty = 1.0 if r.feasible else 1e3
        out = (-r.throughput * (1.0 / penalty), r.energy * penalty,
               r.peak_mem)
        cache[key] = out
        return out

    evaluate_batch = None
    if use_batch:
        # population-level scoring: the integer genome is modular, so many
        # genomes decode to one (chips, strategy, keep_frac) phenotype —
        # dedup on the decoded key and score each unique phenotype once
        # (bit-for-bit equal to the scalar loop, which hits ``cache``)
        def evaluate_batch(P) -> list:
            by_key: dict[tuple, list] = {}
            keys = []
            for i, genome in enumerate(P):
                cluster, strat, frac = decode(genome)
                key = (cluster.n_chips, strat, frac)
                keys.append(key)
                if key not in cache:
                    by_key.setdefault(key, []).append(i)
            for key, idxs in by_key.items():
                evaluate(P[idxs[0]])    # populates cache[key]
            return [cache[k] for k in keys]

    res = nsga2_int(evaluate, bounds, pop_size=pop_size,
                    generations=generations, seed=seed,
                    snapshot_every=snapshot_every,
                    snapshot_path=snapshot_path, resume=resume,
                    max_seconds=max_seconds, max_evals=max_evals,
                    evaluate_batch=evaluate_batch)
    return res, decode


def nearest_strategy(strategy: ParallelStrategy, n_chips: int,
                     ) -> ParallelStrategy:
    """The factorization of ``n_chips`` closest to ``strategy`` — used by
    degraded-mode rescheduling (``repro.core.resilience.degrade``) to remap
    a running job onto the survivor set.  Preference order: keep the tensor
    degree (tp rewrites resize every weight shard), then the pipeline depth
    (pp remaps stage boundaries), and let dp absorb the shrink; ties break
    toward larger dp.  Microbatch count is preserved so step semantics
    (gradient-accumulation factor) stay comparable."""
    cands = strategy_space(n_chips, microbatches=strategy.microbatches)

    def score(c: ParallelStrategy):
        return (abs(c.tensor - strategy.tensor),
                abs(c.pipeline - strategy.pipeline),
                abs(c.data - strategy.data),
                -c.data)

    best = min(cands, key=score)
    if strategy.zero and best.data > 1:
        best = ParallelStrategy(best.data, best.tensor, best.pipeline,
                                best.microbatches, zero=True)
    return best


def degrade_findings(tg: TrainingGraph, plan: ParallelPlan,
                     survivors: int) -> list:
    """C009 degrade-coherence findings for a survivor plan, memoized on the
    cached rewrite: ``verify_degrade`` re-signs every stage from scratch to
    cross-check the warm signature tables, so repeating it per degrade call
    on an unchanged rewrite would re-pay the one cost the cache removed.
    The memo key is the survivor count — the stage graphs themselves are
    the (immutable) cache entry.  Under ``REPRO_SANITIZE`` the rewrite is
    never cached, so the verifier always runs fresh."""
    from .verify import sanitize_enabled, verify_degrade
    if sanitize_enabled():
        return verify_degrade(tg, plan, survivors)
    ent = _rewrite(tg, plan.strategy)
    hit = ent.degrade_findings.get(survivors)
    if hit is None:
        hit = ent.degrade_findings[survivors] = \
            verify_degrade(tg, plan, survivors)
    return list(hit)
