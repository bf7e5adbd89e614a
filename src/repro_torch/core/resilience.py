"""Fault-aware resilience modeling: goodput, checkpointing, degradation.

At datacenter scale raw step latency stops being the figure of merit: chip
failures, restarts and replay determine *goodput* — useful samples per
wall-clock second.  This module composes the ideal-machine iteration
estimate (``repro.core.parallel.evaluate_parallel``) with a per-chip
:class:`~repro.core.accelerators.FaultModel` in three parts:

* **Checkpoint costing** — the checkpoint payload is the weights +
  optimizer-state categories of the unified memory model
  (``ScheduleResult.ckpt_bytes``, max over pipeline stages), written/read
  over the chip's ``offchip_bw`` on the existing ``dma`` resource.

* **Interval selection** — the Young–Daly closed form
  ``τ* = sqrt(2·δ·M)`` seeds an exact discrete search over integer step
  counts using Daly's expected-completion-time model for exponential
  failures: a segment of ``τ`` useful seconds plus a ``δ``-second
  checkpoint costs ``E[T] = e^{R/M} · M · (e^{(τ+δ)/M} − 1)`` expected
  wall-clock seconds, where ``R`` is restart + checkpoint read-back and
  ``M`` the any-chip cluster MTBF.  Efficiency is ``τ / E[T]``.

* **Degraded-mode rescheduling** — :func:`degrade` remaps a job onto the
  survivor set after chip failures via the nearest strategy factorization
  and the existing ``parallelize`` rewrites, staying on the engine's warm
  (incremental re-signing) path; rule C009 in ``repro.core.verify`` checks
  cache coherence across the rewrite.

See docs/resilience.md for the formulas and the sweep composition.

The port's own copy of ``repro.core.resilience`` (numpy and plain Python):
names, signatures and numeric code are the reference's, held bit for
bit against it by ``tests/test_torch_resilience.py``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np

from .accelerators import ClusterSpec, FaultModel
from .parallel import (ParallelPlan, ParallelResult, ParallelStrategy,
                       evaluate_parallel, nearest_strategy)

SECONDS_PER_HOUR = 3600.0


# ---------------------------------------------------------------------------
# optimal checkpoint interval (Young–Daly seed + exact discrete search)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CheckpointPlan:
    """Selected checkpoint cadence for one (schedule, fault model) pair."""

    interval_steps: int            # steps of useful work between checkpoints
    interval_s: float              # = interval_steps · t_step
    write_s: float                 # checkpoint write time δ
    read_s: float                  # checkpoint read-back on restart
    tau_yd_s: float                # Young–Daly closed-form seed sqrt(2δM)
    efficiency: float              # useful / expected wall-clock fraction

    def as_row(self) -> dict:
        return dict(ckpt_interval_steps=self.interval_steps,
                    ckpt_interval_s=self.interval_s,
                    ckpt_write_s=self.write_s, ckpt_read_s=self.read_s,
                    ckpt_tau_yd_s=self.tau_yd_s,
                    ckpt_efficiency=self.efficiency)


def _segment_efficiency(tau, write_s: float, recovery_s: float,
                        mtbf_s: float):
    """τ / E[T] under Daly's exponential-failure completion-time model.
    Vectorized over ``tau``; overflow saturates to efficiency 0."""
    with np.errstate(over="ignore"):
        expected = (math.exp(min(recovery_s / mtbf_s, 700.0)) * mtbf_s *
                    np.expm1((np.asarray(tau, dtype=float) + write_s)
                             / mtbf_s))
        out = np.where(np.isfinite(expected) & (expected > 0),
                       tau / np.maximum(expected, 1e-300), 0.0)
    return out


def optimal_checkpoint_interval(t_step_s: float, write_s: float,
                                recovery_s: float, mtbf_s: float,
                                max_steps: int | None = None,
                                ) -> CheckpointPlan:
    """Checkpoint every k steps, k chosen by exact discrete search seeded by
    the Young–Daly closed form.

    The search maximizes ``τ / E[T]`` over integer k (τ = k·t_step).  Small
    ranges are enumerated exhaustively; wide ranges (edge-class MTBFs are
    astronomical relative to a millisecond step) go through a dense
    geometric grid plus local refinement around the winner, which keeps the
    selected interval within a fraction of a percent of the true discrete
    optimum."""
    if t_step_s <= 0 or write_s < 0 or mtbf_s <= 0:
        raise ValueError("t_step_s and mtbf_s must be positive")
    tau_yd = math.sqrt(2.0 * max(write_s, 1e-30) * mtbf_s)
    k_yd = max(int(round(tau_yd / t_step_s)), 1)
    hi = max(8 * k_yd, 64)
    if max_steps is not None:
        hi = min(hi, max(int(max_steps), 1))

    if hi <= (1 << 17):
        ks = np.arange(1, hi + 1, dtype=np.int64)
    else:
        # the efficiency curve is flat (second-order) around its optimum,
        # so a dense geometric grid + local refinement stays within a
        # fraction of a percent of the exhaustive answer at a tiny cost
        ks = np.unique(np.geomspace(1, hi, 4096).astype(np.int64))
    eff = _segment_efficiency(ks * t_step_s, write_s, recovery_s, mtbf_s)
    k = int(ks[int(np.argmax(eff))])
    # local integer refinement around the geometric-grid winner
    lo_r, hi_r = max(k - 8, 1), min(k + 8, hi)
    kr = np.arange(lo_r, hi_r + 1, dtype=np.int64)
    er = _segment_efficiency(kr * t_step_s, write_s, recovery_s, mtbf_s)
    k = int(kr[int(np.argmax(er))])
    e = float(_segment_efficiency(np.array([k * t_step_s]), write_s,
                                  recovery_s, mtbf_s)[0])
    return CheckpointPlan(interval_steps=k, interval_s=k * t_step_s,
                          write_s=write_s, read_s=max(recovery_s, 0.0),
                          tau_yd_s=tau_yd, efficiency=min(e, 1.0))


# ---------------------------------------------------------------------------
# goodput evaluation
# ---------------------------------------------------------------------------


@dataclass
class GoodputResult:
    """Failure-aware throughput for one (workload, cluster, strategy) cell.

    ``raw_throughput`` is the ideal-machine estimate; ``goodput`` deflates
    it by DMA-stall inflation, transient-fault replay, checkpoint writes
    and hard-failure rework+restart.  ``breakdown`` partitions expected
    wall-clock time into ``useful`` / ``dma_stall`` / ``transient_replay``
    / ``checkpoint`` / ``failure_lost`` fractions (sums to 1)."""

    raw_throughput: float          # samples/s, ideal machine
    goodput: float                 # samples/s net of all fault overheads
    efficiency: float              # goodput / raw_throughput
    step_s: float                  # effective step seconds (stalls + replay)
    ckpt: CheckpointPlan
    ckpt_bytes: float              # per-chip checkpoint payload
    mtbf_cluster_s: float          # any-chip hard-failure MTBF
    fault: FaultModel
    result: ParallelResult | None = None
    breakdown: dict | None = None

    def as_row(self) -> dict:
        row = dict(raw_throughput=self.raw_throughput, goodput=self.goodput,
                   efficiency=self.efficiency, step_s=self.step_s,
                   ckpt_bytes=self.ckpt_bytes,
                   mtbf_cluster_s=self.mtbf_cluster_s,
                   **self.ckpt.as_row())
        for k, v in (self.breakdown or {}).items():
            row[f"frac_{k}"] = v
        return row


def resolve_fault(cluster: ClusterSpec,
                  fault: FaultModel | None = None) -> FaultModel:
    """Precedence: explicit argument > cluster attachment > ideal default."""
    return fault or cluster.fault or FaultModel()


def evaluate_goodput(tg, cluster: ClusterSpec,
                     strategy: ParallelStrategy | None = None,
                     fault: FaultModel | None = None, fusion: str = "manual",
                     engine=None,
                     result: ParallelResult | None = None) -> GoodputResult:
    """Compose the ideal-machine iteration estimate with the fault model.

    Pass ``result`` to reuse an existing ``evaluate_parallel`` evaluation
    (the sweep path does); otherwise one is run here.  The checkpoint
    payload is the max per-chip weights+optimizer-state footprint across
    pipeline stages — every chip checkpoints in parallel over its own
    ``offchip_bw``, so the slowest (largest) stage sets δ."""
    strategy = strategy or ParallelStrategy()
    fault = resolve_fault(cluster, fault)
    if result is None:
        result = evaluate_parallel(tg, cluster, strategy, fusion=fusion,
                                   engine=engine)
    chip = cluster.chip
    hz = chip.freq_ghz * 1e9

    ckpt_b = max((r.ckpt_bytes for r in result.stage_results), default=0.0)
    write_s = ckpt_b / max(chip.offchip_bw, 1e-30) / hz
    read_s = write_s                       # symmetric DMA read-back

    # DMA stalls inflate the busy cycles already charged to the 'dma'
    # resource (activation offload spills); the pipeline-critical stage's
    # stall adds to the makespan.
    stall_cycles = max((r.spill_cycles for r in result.stage_results),
                       default=0.0) * fault.dma_stall_frac
    step_raw_s = result.latency / hz
    step_stall_s = (result.latency + stall_cycles) / hz
    # each transient fault (any chip) replays one step
    lam_t = fault.transient_per_hour * cluster.n_chips / SECONDS_PER_HOUR
    step_s = step_stall_s * (1.0 + lam_t * step_stall_s)

    mtbf = fault.cluster_mtbf_s(cluster.n_chips)
    recovery_s = fault.restart_s + read_s
    plan = optimal_checkpoint_interval(step_s, write_s, recovery_s, mtbf)

    goodput = result.samples_per_iter / step_s * plan.efficiency
    raw = result.samples_per_iter / step_raw_s
    # wall-clock partition: within a checkpoint segment, f_work of expected
    # time runs steps (stalls + replays included), δ/E[T] writes the
    # checkpoint, the rest is failure rework + restart.
    expected = plan.interval_s / max(plan.efficiency, 1e-300)
    f_work = plan.efficiency
    f_ckpt = plan.write_s / expected
    f_fail = max(1.0 - f_work - f_ckpt, 0.0)
    f_transient = f_work * (step_s - step_stall_s) / step_s
    f_stall = f_work * (step_stall_s - step_raw_s) / step_s
    breakdown = dict(useful=f_work - f_transient - f_stall,
                     dma_stall=f_stall, transient_replay=f_transient,
                     checkpoint=f_ckpt, failure_lost=f_fail)
    return GoodputResult(
        raw_throughput=raw, goodput=goodput,
        efficiency=goodput / max(raw, 1e-300), step_s=step_s, ckpt=plan,
        ckpt_bytes=ckpt_b, mtbf_cluster_s=mtbf, fault=fault, result=result,
        breakdown=breakdown)


# ---------------------------------------------------------------------------
# graceful degradation
# ---------------------------------------------------------------------------


@dataclass
class DegradeResult:
    """A job remapped onto the survivor set after ``failed_chips`` losses."""

    cluster: ClusterSpec           # survivor cluster
    strategy: ParallelStrategy     # nearest factorization of the survivors
    plan: ParallelPlan
    result: ParallelResult
    failed_chips: int
    findings: list                 # C009 degrade-coherence report


def degrade(tg, cluster: ClusterSpec, strategy: ParallelStrategy,
            failed_chips: int, fusion: str = "manual", engine=None,
            verify: bool = True) -> DegradeResult:
    """Re-parallelize ``tg`` on the survivor set after chip failures.

    The survivor strategy shrinks the data-parallel degree first
    (:func:`~repro.core.parallel.nearest_strategy`), then re-runs the
    existing ``parallelize`` rewrites.  The rewrites copy the training
    graph, so the engine's signature tables carry over and only the rewrite
    delta is re-signed — degraded evaluation stays on the warm path (the
    tests assert re-scheduling the degraded stage graphs costs zero fresh
    signings).  ``verify=True`` runs the C009 degrade-coherence rule plus
    the structural/parallel verifiers on the survivor plan."""
    survivors = cluster.n_chips - failed_chips
    if failed_chips < 0:
        raise ValueError("failed_chips must be >= 0")
    if survivors < 1:
        raise ValueError(
            f"no survivors: {failed_chips} failures on {cluster.n_chips} "
            f"chips")
    new_cluster = replace(cluster, n_chips=survivors)
    new_strategy = nearest_strategy(strategy, survivors)
    result = evaluate_parallel(tg, new_cluster, new_strategy, fusion=fusion,
                               engine=engine)
    from .parallel import degrade_findings, parallelize
    plan = parallelize(tg, new_strategy, new_cluster)
    findings = []
    if verify:
        # memoized on the cached rewrite: verify_degrade re-signs every
        # stage, so a warm degrade call must not re-pay it (C009 parity —
        # tests assert zero fresh signings on the cached path)
        findings = degrade_findings(tg, plan, survivors)
    return DegradeResult(cluster=new_cluster, strategy=new_strategy,
                         plan=plan, result=result,
                         failed_chips=failed_chips, findings=findings)
