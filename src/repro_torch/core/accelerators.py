"""Heterogeneous Dataflow Accelerator (HDA) models.

An HDA (paper §II-B, after Kwon et al.) is a set of dataflow cores joined by
links/buses to a shared off-chip memory.  Each core has a dataflow
(weight-stationary / output-stationary / SIMD), a spatial PE array and a
two-level on-core memory (register file + local SRAM).

Energy constants are Accelergy-style technology numbers (pJ) for a ~7 nm
class node; they are *relative* numbers used for design-space ranking, the
same way the paper uses them.  SRAM energy/byte scales ~√size; static power
scales with provisioned PEs + SRAM, which is what creates the energy/latency
Pareto structure of the paper's Figs. 1, 8, 9.

The port's own copy of ``repro.core.accelerators`` (numpy and plain Python):
names, signatures and numeric code are the reference's, held bit for
bit against it by ``tests/test_torch_core.py``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

# -- technology constants (pJ) ---------------------------------------------
E_MAC = 0.8                 # one bf16 MAC incl. register-file operand access
E_OFFCHIP_PER_BYTE = 64.0   # LPDDR-class DRAM access
E_LINK_PER_BYTE = 4.0       # on-chip NoC / bus hop
LEAK_PER_LANE = 0.02        # pJ / cycle / MAC lane (static+clock)
LEAK_PER_MB = 8.0           # pJ / cycle / MB of on-chip SRAM
E_ICI_PER_BYTE = 16.0       # chip-to-chip SerDes hop (between NoC and DRAM)


def sram_energy_per_byte(size_bytes: int) -> float:
    """Accelergy-flavoured √size scaling, ~1 pJ/B at 1 MB."""
    mb = max(size_bytes, 1) / (1 << 20)
    return 0.35 + 0.65 * math.sqrt(mb)


@dataclass(frozen=True)
class MemLevel:
    name: str
    size: int            # bytes
    bw: float            # bytes / cycle
    e_per_byte: float    # pJ / byte

    @staticmethod
    def sram(name: str, size: int, bw: float) -> "MemLevel":
        return MemLevel(name, size, bw, sram_energy_per_byte(size))


@dataclass(frozen=True)
class CoreSpec:
    """One dataflow core.

    ``spatial`` maps loop-dim → spatial unrolling (e.g. (('K',4),('C',256))
    for a weight-stationary PE with 4 lanes × 64 4-way SIMD units).
    """

    name: str
    dataflow: str                      # 'ws' | 'os' | 'simd'
    supports: frozenset                 # op classes: conv/gemm/simd/move
    spatial: tuple                      # ((dim, size), ...)
    rf: MemLevel
    local: MemLevel
    e_mac: float = E_MAC
    count: int = 1                      # identical replicas (PE array)

    @property
    def peak_macs(self) -> int:
        return int(math.prod(s for _, s in self.spatial))

    @property
    def lanes(self) -> int:
        return self.peak_macs


@dataclass(frozen=True)
class HDASpec:
    name: str
    cores: tuple                        # CoreSpec, ...
    offchip_bw: float                   # bytes / cycle
    offchip_e: float = E_OFFCHIP_PER_BYTE
    link_bw: float = 64.0               # bytes / cycle, inter-core
    link_e: float = E_LINK_PER_BYTE
    freq_ghz: float = 1.0
    # inter-chip interconnect (multi-accelerator training — repro.core.parallel)
    ici_bw: float = 0.0                 # bytes / cycle per chip, 0 = no ICI
    ici_latency: float = 0.0            # cycles per collective hop
    ici_topology: str = "ring"          # ring | full | mesh2d
    ici_e: float = E_ICI_PER_BYTE       # pJ / byte over the interconnect

    @property
    def total_macs(self) -> int:
        return sum(c.peak_macs * c.count for c in self.cores)

    @property
    def total_sram(self) -> int:
        return sum((c.local.size + c.rf.size) * c.count for c in self.cores)

    def compute_cores(self) -> list:
        return [c for c in self.cores if "conv" in c.supports or
                "gemm" in c.supports]

    def simd_cores(self) -> list:
        return [c for c in self.cores if "simd" in c.supports and
                "conv" not in c.supports]

    def leak_per_cycle(self) -> float:
        lanes = sum(c.peak_macs * c.count for c in self.cores)
        return (LEAK_PER_LANE * lanes +
                LEAK_PER_MB * self.total_sram / (1 << 20))


# ---------------------------------------------------------------------------
# Edge TPU (paper Fig. 4 / Table II)
# ---------------------------------------------------------------------------


def edge_tpu(x_pes: int = 4, y_pes: int = 4, simd_units: int = 64,
             lanes: int = 4, local_mb: float = 2.0, rf_kb: float = 32.0,
             ) -> HDASpec:
    """Edge-TPU-class HDA: an ``x×y`` array of weight-stationary PEs, each
    with ``lanes`` compute lanes of ``simd_units`` 4-way SIMD units and a
    per-lane register file, plus one shared SIMD/vector core for
    element-wise / data-movement ops.  Baseline (paper, bold in Table II):
    4×4 PEs, U=64, L=4, 2 MB local, 32 KB RF."""
    n_pes = x_pes * y_pes
    pe = CoreSpec(
        name="ws_pe",
        dataflow="ws",
        supports=frozenset({"conv", "gemm"}),
        spatial=(("K", lanes), ("C", simd_units * 4)),
        rf=MemLevel.sram("rf", int(rf_kb * 1024), bw=4096.0),
        local=MemLevel.sram("l2", int(local_mb * (1 << 20)), bw=256.0),
        count=n_pes,
    )
    vec = CoreSpec(
        name="simd_core",
        dataflow="simd",
        supports=frozenset({"simd", "move"}),
        spatial=(("N", 256),),
        rf=MemLevel.sram("rf", 16 * 1024, bw=2048.0),
        local=MemLevel.sram("l2", 1 << 20, bw=256.0),
        count=1,
    )
    return HDASpec(
        name=f"edgetpu_{x_pes}x{y_pes}_U{simd_units}_L{lanes}"
             f"_M{local_mb}_RF{rf_kb}",
        cores=(pe, vec),
        offchip_bw=32.0,          # bytes/cycle (LPDDR-class)
        link_bw=64.0,
    )


# paper Table II search space (bold = baseline)
EDGE_TPU_SPACE = {
    "x_pes": [1, 2, 4, 6, 8],
    "y_pes": [1, 2, 4, 6, 8],
    "simd_units": [16, 32, 64, 128],
    "lanes": [1, 2, 4, 8],
    "local_mb": [0.5, 1, 2, 3, 4],
    "rf_kb": [8, 16, 32, 64, 128],
}


# ---------------------------------------------------------------------------
# FuseMax (paper Fig. 7 / Table III)
# ---------------------------------------------------------------------------


def fusemax(x_pes: int = 128, y_pes: int = 128, vector_pes: int = 128,
            buffer_mb: float = 16.0, buffer_bw: float = 8192.0,
            offchip_bw: float = 1024.0) -> HDASpec:
    """FuseMax-class HDA: one large output-stationary MAC array + one large
    vector array, both hanging off a big shared on-chip buffer that talks to
    off-chip memory."""
    arr = CoreSpec(
        name="os_array",
        dataflow="os",
        supports=frozenset({"conv", "gemm"}),
        spatial=(("M", x_pes), ("N", y_pes)),
        rf=MemLevel.sram("rf", 256 * 1024, bw=16384.0),
        local=MemLevel.sram("buf", int(buffer_mb * (1 << 20)), bw=buffer_bw),
        count=1,
    )
    vec = CoreSpec(
        name="vector_array",
        dataflow="simd",
        supports=frozenset({"simd", "move"}),
        spatial=(("N", vector_pes),),
        rf=MemLevel.sram("rf", 64 * 1024, bw=8192.0),
        local=MemLevel.sram("buf", int(buffer_mb * (1 << 20)), bw=buffer_bw),
        count=1,
    )
    return HDASpec(
        name=f"fusemax_{x_pes}x{y_pes}_V{vector_pes}_B{buffer_mb}"
             f"_BW{buffer_bw}_OC{offchip_bw}",
        cores=(arr, vec),
        offchip_bw=offchip_bw,
        link_bw=buffer_bw,
    )


# paper Table III search space
FUSEMAX_SPACE = {
    "x_pes": [64, 128, 256, 512],
    "y_pes": [64, 128, 256, 512],
    "vector_pes": [32, 64, 128, 256],
    "buffer_bw": [8192, 16384],
    "buffer_mb": [4, 8, 16, 32],
    "offchip_bw": [512, 1024, 2048, 4096, 8192],
}


# ---------------------------------------------------------------------------
# TPU-v5e-class core (ties MONET's analytic model to the dry-run roofline)
# ---------------------------------------------------------------------------

TPU_V5E = dict(
    peak_bf16_flops=197e12,      # FLOP/s per chip
    hbm_bw=819e9,                # B/s
    ici_bw_per_link=50e9,        # B/s per link
    hbm_bytes=16 * (1 << 30),
    vmem_bytes=128 * (1 << 20),
)


def tpu_v5e_like(freq_ghz: float = 0.94) -> HDASpec:
    """A v5e-class chip as an HDA: one big systolic (output-stationary) MXU
    gang + a vector unit, 128 MB VMEM as the local level.  Peak MACs/cycle is
    set so that 2·macs·freq ≈ 197 TFLOP/s bf16."""
    macs = int(197e12 / 2 / (freq_ghz * 1e9))  # ≈ 104k MACs/cycle
    side = int(math.sqrt(macs))
    arr = CoreSpec(
        name="mxu",
        dataflow="os",
        supports=frozenset({"conv", "gemm"}),
        spatial=(("M", side), ("N", macs // side)),
        rf=MemLevel.sram("rf", 1 << 20, bw=1 << 20),
        local=MemLevel.sram("vmem", TPU_V5E["vmem_bytes"], bw=5456.0),
        count=1,
    )
    vec = CoreSpec(
        name="vpu",
        dataflow="simd",
        supports=frozenset({"simd", "move"}),
        spatial=(("N", 8 * 128 * 8),),
        rf=MemLevel.sram("rf", 256 * 1024, bw=16384.0),
        local=MemLevel.sram("vmem", TPU_V5E["vmem_bytes"], bw=5456.0),
        count=1,
    )
    return HDASpec(
        name="tpu_v5e_like",
        cores=(arr, vec),
        offchip_bw=TPU_V5E["hbm_bw"] / (freq_ghz * 1e9),   # bytes/cycle
        link_bw=4096.0,
        freq_ghz=freq_ghz,
    )


def grid(space: dict) -> list[dict]:
    """Cartesian product of a Table-II/III-style search space."""
    keys = list(space)
    out = [{}]
    for k in keys:
        out = [{**d, k: v} for d in out for v in space[k]]
    return out


# ---------------------------------------------------------------------------
# multi-accelerator clusters (edge boards → data-center pods)
# ---------------------------------------------------------------------------


def with_interconnect(hda: HDASpec, bw: float, latency: float,
                      topology: str = "ring",
                      e_per_byte: float = E_ICI_PER_BYTE) -> HDASpec:
    """A copy of ``hda`` with its inter-chip interconnect fields set.  The
    result is a distinct frozen spec, so the engine registry keys it (and its
    cost caches) separately from the single-chip variant."""
    return replace(hda, ici_bw=bw, ici_latency=latency,
                   ici_topology=topology, ici_e=e_per_byte)


@dataclass(frozen=True)
class FaultModel:
    """Per-chip failure characteristics (resilience modeling,
    ``repro.core.resilience``).

    ``mtbf_hours`` is the mean time between *hard* failures of one chip —
    the whole job restarts from the last checkpoint when any chip fails, so
    a cluster of n chips has MTBF ``mtbf_hours / n``.  ``transient_per_hour``
    is the per-chip rate of recoverable soft errors, each costing one
    replayed step.  ``dma_stall_frac`` is the expected fractional inflation
    of DMA busy cycles (retried/stalled transfers).  ``restart_s`` is the
    reboot/reinit wall time after a hard failure, before checkpoint
    read-back starts."""

    mtbf_hours: float = 50_000.0
    transient_per_hour: float = 0.0
    dma_stall_frac: float = 0.0
    restart_s: float = 60.0

    @property
    def mtbf_s(self) -> float:
        return self.mtbf_hours * 3600.0

    def cluster_mtbf_s(self, n_chips: int) -> float:
        """Any-chip hard-failure MTBF for ``n_chips`` independent chips."""
        return self.mtbf_s / max(n_chips, 1)


def edge_fault_model() -> FaultModel:
    """Edge boards: consumer-grade parts fail more often but reboot fast."""
    return FaultModel(mtbf_hours=20_000.0, transient_per_hour=1e-4,
                      dma_stall_frac=0.05, restart_s=10.0)


def datacenter_fault_model() -> FaultModel:
    """Datacenter chips: higher-grade silicon, but restart means rejoining
    the pod (scheduler + reshard), and ECC surfaces more soft errors."""
    return FaultModel(mtbf_hours=50_000.0, transient_per_hour=1e-3,
                      dma_stall_frac=0.02, restart_s=120.0)


@dataclass(frozen=True)
class ClusterSpec:
    """``n_chips`` identical HDAs joined by an inter-chip interconnect.

    ``chip`` must carry the interconnect parameters (``ici_bw`` etc. — use
    :func:`with_interconnect`); ``mem_capacity`` is the per-chip off-chip
    memory ceiling fed to the feasibility check of parallel schedules
    (0 = unconstrained); ``fault`` attaches the per-chip failure model used
    by goodput evaluation (None = ideal, failure-free machine)."""

    chip: HDASpec
    n_chips: int
    mem_capacity: int = 0            # bytes per chip, 0 = unlimited
    fault: FaultModel | None = None

    @property
    def name(self) -> str:
        return (f"{self.chip.name}_x{self.n_chips}"
                f"_{self.chip.ici_topology}")

    def __post_init__(self):
        if self.n_chips < 1:
            raise ValueError("cluster needs at least one chip")


def edge_cluster(n_chips: int = 4, chip: HDASpec | None = None,
                 topology: str = "ring", mem_mb: float = 512.0,
                 fault: FaultModel | None = None) -> ClusterSpec:
    """Board-level cluster of Edge-TPU-class chips: PCB traces / PCIe-class
    interconnect (~4 B/cycle/chip at 1 GHz ≈ 4 GB/s, µs-scale latency)."""
    base = chip or edge_tpu()
    return ClusterSpec(
        chip=with_interconnect(base, bw=4.0, latency=2000.0,
                               topology=topology),
        n_chips=n_chips,
        mem_capacity=int(mem_mb * (1 << 20)),
        fault=fault or edge_fault_model(),
    )


def datacenter_cluster(n_chips: int = 8, chip: HDASpec | None = None,
                       topology: str = "ring",
                       mem_gb: float = 16.0,
                       fault: FaultModel | None = None) -> ClusterSpec:
    """Pod-slice cluster of TPU-v5e-class chips: ICI links (~50 GB/s/link ≈
    53 B/cycle at 0.94 GHz, sub-µs latency), torus/ring topology."""
    base = chip or tpu_v5e_like()
    bw = TPU_V5E["ici_bw_per_link"] / (base.freq_ghz * 1e9)
    return ClusterSpec(
        chip=with_interconnect(base, bw=bw, latency=500.0,
                               topology=topology),
        n_chips=n_chips,
        mem_capacity=int(mem_gb * (1 << 30)),
        fault=fault or datacenter_fault_model(),
    )
