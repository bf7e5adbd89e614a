"""Per-node / per-fused-subgraph analytic cost model (Stream-lite).

Latency: dataflow-aware compute cycles (spatial under-utilization from
ceil-division over the PE array) vs. memory cycles (off-chip + local SRAM
bandwidth), overlapped (double-buffered): ``max(compute, mem)``.

Energy: MAC energy + per-level traffic × energy/byte + leakage × cycles
(added at schedule level).

Traffic: two-level model.  The dataflow's stationary operand is fetched once;
if it exceeds local SRAM the streamed operands are re-fetched per chunk
(classic tiling reload).  Tensors resident in local SRAM from a fused
predecessor are free (this is exactly the fusion payoff the paper models).

The port's own copy of ``repro.core.cost_model`` (numpy and plain Python):
names, signatures and numeric code are the reference's, held bit for
bit against it by ``tests/test_torch_core.py``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from .accelerators import CoreSpec, HDASpec
from .graph import Node, WorkloadGraph, dtype_bytes


@dataclass
class NodeCost:
    cycles: float
    offchip_bytes: float
    local_bytes: float
    link_bytes: float
    energy_pj: float
    core: str

    def __add__(self, other: "NodeCost") -> "NodeCost":
        return NodeCost(self.cycles + other.cycles,
                        self.offchip_bytes + other.offchip_bytes,
                        self.local_bytes + other.local_bytes,
                        self.link_bytes + other.link_bytes,
                        self.energy_pj + other.energy_pj, self.core)


# ---------------------------------------------------------------------------
# compute cycles
# ---------------------------------------------------------------------------


def _loop_mapping(node: Node, core: CoreSpec) -> dict:
    """Normalize node loop dims onto the core's spatial dim names."""
    d = node.dims
    cls = node.op_class
    if cls == "conv":
        if core.dataflow == "ws":
            # spatial K (lanes) × C (simd); temporal B·OY·OX·FY·FX
            return {"K": d["K"], "C": d["C"],
                    "_temporal": d["B"] * d["OY"] * d["OX"] * d["FY"] * d["FX"]}
        # output-stationary: spatial M×N = (B·OY·OX)×K; temporal C·FY·FX
        return {"M": d["B"] * d["OY"] * d["OX"], "N": d["K"],
                "_temporal": d["C"] * d["FY"] * d["FX"]}
    if cls == "gemm":
        if core.dataflow == "ws":
            # weights (K_in×N) stationary: spatial K←N(out), C←K(in)
            return {"K": d["N"], "C": d["K"],
                    "_temporal": d.get("B", 1) * d["M"]}
        return {"M": d["M"], "N": d["N"],
                "_temporal": d.get("B", 1) * d["K"]}
    return {}


# -- collective communication (multi-accelerator training) -------------------
#
# A ``comm`` node models one collective over P chips joined by the HDA's
# inter-chip interconnect (``ici_bw`` bytes/cycle/chip, ``ici_latency``
# cycles/hop).  Its dims carry the *full* (unsharded) payload:
# ``N`` elements, ``E`` bytes/element, ``P`` chips.  Wire traffic per chip
# follows the bandwidth-optimal algorithms (ring as the canonical case):
#
#   all-reduce       2·(P−1)/P · bytes     ring: 2(P−1) hops
#   all-gather         (P−1)/P · bytes     ring:  (P−1) hops
#   reduce-scatter     (P−1)/P · bytes     ring:  (P−1) hops
#   all-to-all         (P−1)/P · bytes     ring:  (P−1) hops
#   send (p2p)                 bytes              1 hop
#   recv (p2p)                 0 transmitted      1 hop (the matching send
#                              already counts the physical bytes; the recv
#                              still *occupies* the receiver's link for the
#                              full payload time — see comm_cycles)
#
# Switched ('full') topologies keep the same wire bytes (bandwidth lower
# bound) but collapse the hop count; 2-D meshes pay √P-scaled hops.

_COMM_WIRE = {                     # op -> wire-bytes multiplier builder
    "all_reduce": lambda p: 2.0 * (p - 1) / p,
    "all_gather": lambda p: (p - 1) / p,
    "reduce_scatter": lambda p: (p - 1) / p,
    "all_to_all": lambda p: (p - 1) / p,
    "send": lambda p: 1.0,
    "recv": lambda p: 0.0,
}


def comm_payload(dims: dict) -> float:
    """Full (unsharded) payload bytes encoded in a comm node's dims
    (``N`` elements × ``E`` bytes/element) — the single place the encoding
    is interpreted."""
    return dims.get("N", 1) * dims.get("E", 2)


def collective_wire(op: str, nbytes: float, p: int,
                    topology: str = "ring") -> tuple[float, int]:
    """(wire bytes per chip, latency hops) of one collective of ``nbytes``
    payload over ``p`` chips."""
    if p <= 1:
        return 0.0, 0
    mult = _COMM_WIRE.get(op)
    if mult is None:
        raise ValueError(f"unknown collective op {op!r}")
    wire = mult(p) * nbytes
    if op in ("send", "recv"):
        hops = 1
    elif topology == "full":
        hops = 2 if op == "all_reduce" else 1
    elif topology == "mesh2d":
        side = max(1, round(math.sqrt(p)))
        hops = (4 if op == "all_reduce" else 2) * max(side - 1, 1)
    else:                                          # ring (default)
        hops = (2 if op == "all_reduce" else 1) * (p - 1)
    return wire, hops


def comm_cycles(node: Node, hda: HDASpec) -> float:
    """Interconnect cycles of one collective node (link occupancy + hop
    latency).  A recv transmits nothing (its send carries the bytes) but
    still holds the receiver's link for the full payload time."""
    d = node.dims
    payload = comm_payload(d)
    wire, hops = collective_wire(node.op, payload, int(d.get("P", 1)),
                                 hda.ici_topology)
    occupancy = payload if node.op == "recv" else wire
    return max(occupancy / max(hda.ici_bw, 1e-9) + hops * hda.ici_latency,
               1.0)


def dma_cycles(node: Node, hda: HDASpec) -> float:
    """Off-chip DMA cycles of one activation offload/fetch transfer.  The
    payload (comm-style dims: ``N`` elements × ``E`` bytes/element) streams
    over the off-chip memory interface on the dedicated ``dma`` resource,
    overlapping with compute like collectives overlap on ``ici``."""
    return max(comm_payload(node.dims) / max(hda.offchip_bw, 1e-9), 1.0)


def dma_node_cost(cyc: float, inb: float, outb: float,
                  hda: HDASpec) -> NodeCost:
    """NodeCost of a DMA transfer: the tensor side (full payload) plus the
    1-byte residency marker cross the off-chip interface; energy pays DRAM
    access on the transferred bytes."""
    offchip = inb + outb
    cycles = max(cyc, offchip / max(hda.offchip_bw, 1e-9), 1.0)
    return NodeCost(cycles, offchip, 0.0, 0.0, offchip * hda.offchip_e, "dma")


#: KV-cache bookkeeping ops that move no data (repro.core.serving):
#: ``kv_read`` sources an already-resident cache (its streaming cost is
#: paid by the attention consumers' operand bytes, exactly as for
#: parameters and graph inputs — only the host-paged ``kv_load`` pays a
#: transfer, on the ``dma`` resource) and ``kv_commit`` is the end-of-step
#: liveness barrier that pins caches to the step boundary.
KV_FREE_OPS = frozenset({"kv_read", "kv_commit"})


def kv_free_node_cost(core_name: str) -> NodeCost:
    """NodeCost of a :data:`KV_FREE_OPS` bookkeeping node: one cycle, no
    traffic, no energy — the tensors it touches already live in
    off-chip-attached memory and only change liveness, not location."""
    return NodeCost(1.0, 0.0, 0.0, 0.0, 0.0, core_name)


def comm_node_cost(cyc: float, inb: float, outb: float, wire: float,
                   hda: HDASpec) -> NodeCost:
    """NodeCost of a collective: the payload still streams through each
    chip's off-chip memory (inb read + outb written), overlapped with the
    wire transfer; energy pays DRAM + SerDes.  Scheduled on the dedicated
    'ici' resource so collectives overlap with compute on other cores."""
    offchip = inb + outb
    mem_cycles = offchip / max(hda.offchip_bw, 1e-9)
    cycles = max(cyc, mem_cycles, 1.0)
    energy = offchip * hda.offchip_e + wire * hda.ici_e
    return NodeCost(cycles, offchip, 0.0, wire, energy, "ici")


def compute_cycles(node: Node, core: CoreSpec, tp: int = 1,
                   hda: HDASpec | None = None) -> float:
    """Cycles to execute ``node`` on ``core`` with ``tp``-way tensor
    parallelism over identical core replicas (output channels split —
    paper §IV-A).  ``comm``-class nodes ignore the core and cost against
    ``hda``'s inter-chip interconnect."""
    cls = node.op_class
    if cls == "comm":
        if hda is None:
            raise ValueError("comm node cost needs the HDASpec (interconnect)")
        return comm_cycles(node, hda)
    if cls == "dma":
        if hda is None:
            raise ValueError("dma node cost needs the HDASpec (offchip bw)")
        return dma_cycles(node, hda)
    if cls in ("conv", "gemm"):
        m = _loop_mapping(node, core)
        spatial = dict(core.spatial)
        cycles = float(m.get("_temporal", 1))
        first_spatial = True
        for dim, size in spatial.items():
            loop = m.get(dim, 1)
            if first_spatial and tp > 1:
                loop = math.ceil(loop / tp)   # split across PE replicas
            first_spatial = False
            cycles *= math.ceil(loop / size)
        return max(cycles, 1.0)
    if cls in ("simd", "move"):
        width = core.peak_macs
        work = node.flops
        if work == 0:  # pure data movement: bound by local bandwidth
            nbytes = 2 * node.dims.get("N", 1)   # bf16 elements
            return max(nbytes / max(core.local.bw, 1e-9), 1.0)
        return max(math.ceil(work / width), 1.0)
    return 1.0


# ---------------------------------------------------------------------------
# pure arithmetic kernels (shared with the evaluation engine)
# ---------------------------------------------------------------------------


def node_cost_arith(cyc: float, inb: float, outb: float,
                    stationary: float | None, streamed: float,
                    macs: int, eb: int, core: CoreSpec,
                    hda: HDASpec) -> NodeCost:
    """Roofline arithmetic on precomputed scalars.  ``stationary`` is None
    when the stationary-operand chunking rule does not apply."""
    offchip = inb + outb
    if stationary is not None:
        cap = max(core.local.size * core.count, 1)
        chunks = max(1, math.ceil(stationary / cap))
        if chunks > 1:
            offchip += streamed * (chunks - 1)
    reuse = max(1.0, math.sqrt(core.rf.size / max(2 * eb, 1)) / 4)
    local = offchip + 2 * macs * eb / reuse
    mem_cycles = max(offchip / max(hda.offchip_bw, 1e-9),
                     local / max(core.local.bw * core.count, 1e-9))
    cycles = max(cyc, mem_cycles)
    energy = (macs * core.e_mac +
              local * core.local.e_per_byte +
              offchip * hda.offchip_e)
    return NodeCost(cycles, offchip, local, 0.0, energy, core.name)


def subgraph_tail(per_core_cycles: dict, offchip: float, local: float,
                  link: float, energy: float, internal_bytes: int,
                  compute_core: CoreSpec, simd_core: CoreSpec,
                  hda: HDASpec) -> NodeCost:
    """Final reduction of a fused-subgraph cost from accumulated per-node
    terms (identical to the tail of ``CostModel.subgraph_cost``)."""
    energy += link * hda.link_e
    local_level = compute_core.local
    energy += 2 * internal_bytes * local_level.e_per_byte
    local += 2 * internal_bytes
    mem_cycles = max(offchip / max(hda.offchip_bw, 1e-9),
                     local / max(local_level.bw * compute_core.count, 1e-9),
                     link / max(hda.link_bw, 1e-9))
    cycles = max(max(per_core_cycles.values(), default=1.0), mem_cycles)
    core = max(per_core_cycles, key=per_core_cycles.get) \
        if per_core_cycles else simd_core.name
    return NodeCost(cycles, offchip, local, link, energy, core)


# ---------------------------------------------------------------------------
# cost model bound to a graph + HDA
# ---------------------------------------------------------------------------


class CostModel:
    def __init__(self, graph: WorkloadGraph, hda: HDASpec,
                 tensor_parallel: bool = True):
        self.g = graph
        self.hda = hda
        self.tensor_parallel = tensor_parallel
        self._compute = (hda.compute_cores() or list(hda.cores))[0]
        simd = hda.simd_cores()
        self._simd = simd[0] if simd else self._compute

    # -- core assignment -----------------------------------------------------

    def core_for(self, node: Node) -> CoreSpec:
        if node.op_class in ("conv", "gemm"):
            return self._compute
        return self._simd

    def tp_for(self, node: Node, core: CoreSpec) -> int:
        if not self.tensor_parallel or node.op_class not in ("conv", "gemm"):
            return 1
        return core.count

    # -- byte helpers ---------------------------------------------------------

    def nbytes(self, tensor: str) -> int:
        return self.g.tensors[tensor].bytes

    def in_bytes(self, node: Node, resident: set) -> int:
        seen = set()
        tot = 0
        for t in node.inputs:
            if t in resident or t in seen:
                continue
            seen.add(t)
            tot += self.nbytes(t)
        return tot

    def out_bytes(self, node: Node, internal: set) -> int:
        return sum(self.nbytes(t) for t in node.outputs if t not in internal)

    # -- node cost ------------------------------------------------------------

    def node_cost(self, node: Node, resident: set = frozenset(),
                  internal_out: set = frozenset()) -> NodeCost:
        if node.op in KV_FREE_OPS:
            return kv_free_node_cost(self._simd.name)
        if node.op_class == "dma":
            return dma_node_cost(dma_cycles(node, self.hda),
                                 self.in_bytes(node, resident),
                                 self.out_bytes(node, internal_out),
                                 self.hda)
        if node.op_class == "comm":
            d = node.dims
            wire, _ = collective_wire(node.op, comm_payload(d),
                                      int(d.get("P", 1)),
                                      self.hda.ici_topology)
            return comm_node_cost(comm_cycles(node, self.hda),
                                  self.in_bytes(node, resident),
                                  self.out_bytes(node, internal_out),
                                  wire, self.hda)
        core = self.core_for(node)
        tp = self.tp_for(node, core)
        cyc = compute_cycles(node, core, tp)

        inb = self.in_bytes(node, resident)
        outb = self.out_bytes(node, internal_out)

        # stationary-operand chunking: if the stationary operand spills the
        # local SRAM, streamed operands are reloaded per chunk.
        stationary = streamed = None
        if node.op_class in ("conv", "gemm") and len(node.inputs) >= 2:
            if core.dataflow == "ws":
                stationary = self.nbytes(node.inputs[1])       # weights
                streamed = inb - (stationary if node.inputs[1] not in resident
                                  else 0)
            else:  # output-stationary
                stationary = sum(self.nbytes(t) for t in node.outputs)
                streamed = inb

        # local traffic: every off-chip byte passes through local SRAM, plus
        # MAC operand traffic filtered by register-file reuse (~√RF).
        eb = dtype_bytes(self.g.tensors[node.outputs[0]].dtype
                         if node.outputs else "bfloat16")
        return node_cost_arith(cyc, inb, outb, stationary, streamed or 0,
                               node.macs, eb, core, self.hda)

    # -- fused subgraph cost ----------------------------------------------------

    def subgraph_cost(self, nodes: list) -> NodeCost:
        """Cost of a fused subgraph: internal tensors never leave local SRAM;
        per-core work pipelines (latency = max over engines, double-buffered
        against off-chip traffic)."""
        node_objs = [self.g.nodes[n] for n in nodes]
        produced = {t for nd in node_objs for t in nd.outputs}
        nodeset = set(nodes)
        internal = {t for t in produced
                    if all(c in nodeset for c in self.g.consumers.get(t, []))
                    and self.g.consumers.get(t)}

        per_core_cycles: dict[str, float] = {}
        offchip = local = link = energy = 0.0
        resident: set = set()
        for nd in node_objs:
            c = self.node_cost(nd, resident=resident | internal,
                               internal_out=internal)
            if nd.op in KV_FREE_OPS:   # bookkeeping: no data movement
                core = self.core_for(nd)
                per_core_cycles[core.name] = (
                    per_core_cycles.get(core.name, 0.0) + 1.0)
            elif nd.op_class == "comm":
                per_core_cycles["ici"] = (per_core_cycles.get("ici", 0.0)
                                          + comm_cycles(nd, self.hda))
            elif nd.op_class == "dma":
                per_core_cycles["dma"] = (per_core_cycles.get("dma", 0.0)
                                          + dma_cycles(nd, self.hda))
            else:
                core = self.core_for(nd)
                per_core_cycles[core.name] = (
                    per_core_cycles.get(core.name, 0.0)
                    + compute_cycles(nd, core, self.tp_for(nd, core)))
            offchip += c.offchip_bytes
            local += c.local_bytes
            energy += c.energy_pj
            resident |= set(nd.outputs)

        # intermediate tensors crossing engines ride the on-chip link
        for t in internal:
            prod_core = self.core_for(self.g.nodes[self.g.producer[t]]).name
            for cons in self.g.consumers.get(t, []):
                if self.core_for(self.g.nodes[cons]).name != prod_core:
                    link += self.nbytes(t)
        # internal tensors still cost local SRAM round-trips
        internal_bytes = sum(self.nbytes(t) for t in internal)
        return subgraph_tail(per_core_cycles, offchip, local, link, energy,
                             internal_bytes, self._compute, self._simd,
                             self.hda)
