"""Inference-serving model: continuous batching over KV-cache graphs.

The training side of the repo answers "what does one optimizer step cost on
this machine"; this module answers the production question that follows it —
what does the *deployed* model sustain, in requests/sec and watts, once
decode-time KV caches dominate the memory picture (ROADMAP item 1, after
Stream/TRIM's inference-side lineage).

The unit of evaluation is one **continuous-batching decode step**: ``slots``
concurrent sequences each advance one token against their KV caches
(``zoo.gpt2_decode_graph``), scheduled on one chip shard through the same
signature-memoizing engine/schedule path as training graphs — warm caches
and ``schedule_batch`` carry over unchanged.  Prefill is evaluated per
request class from ``zoo.gpt2_prefill_graph``.  A request mix (chat /
summarize / code, à la production traces) turns the two step costs into
end-to-end latency percentiles, steady-state throughput, and power.

KV residency is governed by the same ternary policy enum the training
checkpointer uses (:class:`~repro.core.memory.ActivationPolicy`):

* ``KEEP`` — caches stay resident in on-chip-attached memory; fastest step
  until the footprint (``slots × ctx × kv_bytes_per_token``) blows past the
  per-chip capacity, after which the step pays un-overlapped forced paging.
* ``RECOMPUTE`` — no cache at all: every step re-runs full-sequence
  attention (prefill-shaped graph at ``ctx+1``).  Minimal memory, quadratic
  compute.
* ``OFFLOAD`` — caches live in the host KV pool and page through the chip
  just-in-time over the dedicated ``dma`` resource (``kv_load`` in,
  new-block ``kv_store`` out), overlapping with compute like training
  activation offload does.

See docs/serving.md for the category semantics and graph shapes, and
``dse.sweep_serve`` for the cluster-size × slots × policy sweep driver.

The port's own copy of ``repro.core.serving`` (numpy and plain Python):
names, signatures and numeric code are the reference's, held bit for
bit against it by ``tests/test_torch_serving.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .accelerators import ClusterSpec
from .engine import get_engine
from .graph import dtype_bytes
from .memory import KV_CACHE, ActivationPolicy
from .scheduling import schedule
from .zoo import gpt2_decode_graph, gpt2_prefill_graph

#: small-GPT-2 (§IV-B) — the default served model
GPT2_SMALL = dict(d_model=768, n_layers=12, n_heads=12, vocab=50257)


@dataclass(frozen=True)
class RequestClass:
    """One request archetype of a serving trace: ``prompt`` tokens in,
    ``decode`` tokens generated, arriving with relative ``weight``."""

    name: str
    prompt: int
    decode: int
    weight: float = 1.0

    def __post_init__(self):
        if self.prompt < 1 or self.decode < 1 or self.weight <= 0:
            raise ValueError(f"degenerate request class {self}")

    @property
    def steady_ctx(self) -> int:
        """Mean context length during this class's decode phase."""
        return self.prompt + self.decode // 2


@dataclass(frozen=True)
class RequestMix:
    """A weighted set of request classes (weights are normalized)."""

    classes: tuple

    def __post_init__(self):
        if not self.classes:
            raise ValueError("empty request mix")

    @property
    def weights(self) -> list:
        tot = sum(c.weight for c in self.classes)
        return [c.weight / tot for c in self.classes]

    def mean(self, f) -> float:
        """Mix-weighted mean of ``f(request_class)``."""
        return sum(w * f(c) for w, c in zip(self.weights, self.classes,
                                            strict=True))


#: production-flavoured default: mostly chat turns, some long-prompt
#: summarization, some long-generation code completion
DEFAULT_MIX = RequestMix((
    RequestClass("chat", prompt=128, decode=128, weight=0.60),
    RequestClass("summarize", prompt=512, decode=64, weight=0.25),
    RequestClass("code", prompt=256, decode=256, weight=0.15),
))


def kv_bytes_per_token(model: dict | None = None, dtype: str = "bfloat16",
                       n_chips: int = 1) -> int:
    """Per-chip KV-cache bytes one decoded token leaves behind: K and V,
    every layer, head-sharded ``n_chips`` ways."""
    m = {**GPT2_SMALL, **(model or {})}
    return 2 * m["n_layers"] * m["d_model"] * dtype_bytes(dtype) // n_chips


def _bucket(n: int, lo: int = 16) -> int:
    """Round a context length up to a power of two (≥ ``lo``) so the
    decode-graph memo and the engine's signature tables hit across nearby
    lengths — continuous batching with per-request lengths would otherwise
    build a fresh graph per token count."""
    return max(lo, 1 << max(int(n) - 1, 0).bit_length())


@dataclass
class ServeResult:
    """Steady-state serving estimate of one (cluster, mix, slots, policy)
    cell.  Rates are whole-cluster; byte figures are per chip (the graphs
    are per-chip tensor-parallel shards)."""

    cluster: str
    policy: str
    slots: int
    n_chips: int
    rps: float                     # sustained requests / second
    tokens_per_s: float            # generated tokens / second
    p50_ms: float                  # end-to-end request latency percentiles
    p99_ms: float
    step_us: float                 # mix-weighted batched decode step
    watts: float                   # average power at the sustained rate
    tokens_per_joule: float        # the Pareto efficiency axis
    kv_bytes: int                  # per-chip KV footprint at the decode peak
    peak_mem: float                # per-chip peak live bytes (worst phase)
    mem_capacity: int              # per-chip ceiling (0 = unconstrained)
    feasible: bool                 # True iff no phase overflowed capacity
    per_class: dict = field(default_factory=dict)  # name -> phase detail

    def as_row(self) -> dict:
        return dict(cluster=self.cluster, policy=self.policy,
                    slots=self.slots, chips=self.n_chips, rps=self.rps,
                    tokens_per_s=self.tokens_per_s, p50_ms=self.p50_ms,
                    p99_ms=self.p99_ms, step_us=self.step_us,
                    watts=self.watts, tokens_per_joule=self.tokens_per_joule,
                    kv_bytes=self.kv_bytes, peak_mem=self.peak_mem,
                    mem_capacity=self.mem_capacity, feasible=self.feasible)


def _phase(graph, cluster: ClusterSpec, engine) -> tuple:
    """Schedule one serving phase on the cluster's chip shard and apply the
    capacity model: a phase whose peak live bytes exceed the per-chip
    ceiling pays the overflow twice over the off-chip interface (forced
    page-out + page-back-in, un-overlapped — the thrash regime continuous
    batching tries to stay out of) and marks the cell infeasible.
    Returns ``(seconds, joules, peak_bytes, kv_bytes, fits)``."""
    r = schedule(graph, cluster.chip, engine=engine)
    cycles = r.latency
    fits = True
    cap = cluster.mem_capacity
    if cap and r.peak_mem > cap:
        fits = False
        cycles += 2.0 * (r.peak_mem - cap) / max(cluster.chip.offchip_bw,
                                                 1e-9)
    hz = cluster.chip.freq_ghz * 1e9
    return (cycles / hz, r.energy * 1e-12, r.peak_mem,
            int(r.mem_breakdown.get(KV_CACHE, 0)), fits)


def _percentile(samples: list, q: float) -> float:
    """Weighted percentile of ``(value, weight)`` samples (weights
    normalized, ``q`` in [0, 1])."""
    tot = sum(w for _, w in samples)
    acc = 0.0
    for v, w in sorted(samples):
        acc += w / tot
        if acc >= q - 1e-12:
            return v
    return max(v for v, _ in samples)


def evaluate_serve(cluster: ClusterSpec, mix: RequestMix | None = None,
                   slots: int = 8,
                   policy: ActivationPolicy = ActivationPolicy.KEEP,
                   model: dict | None = None, dtype: str = "bfloat16",
                   engine=None) -> ServeResult:
    """Steady-state continuous-batching estimate for one configuration.

    ``slots`` is the number of concurrently decoding sequences (the decode
    graph's batch); ``cluster.n_chips`` becomes the tensor-parallel degree
    of the per-chip graph shard (raises ``ValueError`` when it does not
    divide the model's head count — sweep cells skip, as in
    ``sweep_parallel``).  Per request class the evaluator prices a prefill
    (batch 1, the class's prompt bucket) and a batched decode step at the
    class's steady-state context, composes them into end-to-end latency,
    and mix-weights the classes into throughput / percentile / power
    figures.  All graphs flow through the shared engine, so repeat calls
    (sweeps, benches) are warm-cache evaluations."""
    mix = mix or DEFAULT_MIX
    m = {**GPT2_SMALL, **(model or {})}
    tp = cluster.n_chips
    if slots < 1:
        raise ValueError("slots must be >= 1")
    eng = engine if engine is not None else get_engine(cluster.chip)

    weights = mix.weights
    per_class: dict = {}
    samples: list = []             # (e2e seconds, weight)
    feasible = True
    peak = 0.0
    kv_peak = 0
    mean_step_s = mean_req_j = 0.0

    for w, c in zip(weights, mix.classes, strict=True):
        ctx = _bucket(c.steady_ctx)
        pre = gpt2_prefill_graph(batch=1, seq=_bucket(c.prompt), tp=tp,
                                 commit_kv=policy != ActivationPolicy.RECOMPUTE,
                                 dtype=dtype, **m)
        if policy == ActivationPolicy.RECOMPUTE:
            dec = gpt2_prefill_graph(batch=slots, seq=_bucket(ctx + 1),
                                     tp=tp, commit_kv=False, dtype=dtype, **m)
        else:
            dec = gpt2_decode_graph(
                batch=slots, past=ctx, tp=tp,
                kv_paged=policy == ActivationPolicy.OFFLOAD,
                dtype=dtype, **m)
        pre_s, pre_j, pre_peak, _, pre_fits = _phase(pre, cluster, eng)
        stp_s, stp_j, stp_peak, stp_kv, stp_fits = _phase(dec, cluster, eng)

        # one batched step advances every slot one token, so a request sees
        # `decode` full steps; its energy share is 1/slots of each step
        e2e_s = pre_s + c.decode * stp_s
        req_j = pre_j + c.decode * stp_j / slots
        per_class[c.name] = dict(ctx=ctx, prefill_ms=pre_s * 1e3,
                                 step_us=stp_s * 1e6, e2e_ms=e2e_s * 1e3,
                                 kv_bytes=stp_kv)
        samples.append((e2e_s, w))
        feasible &= pre_fits and stp_fits
        peak = max(peak, pre_peak, stp_peak)
        kv_peak = max(kv_peak, stp_kv)
        mean_step_s += w * stp_s
        mean_req_j += w * req_j

    mean_e2e = sum(v * w for v, w in samples)
    rps = slots / mean_e2e
    tok_s = rps * mix.mean(lambda c: c.decode)
    watts = rps * mean_req_j
    return ServeResult(
        cluster=cluster.name, policy=policy.name, slots=slots, n_chips=tp,
        rps=rps, tokens_per_s=tok_s,
        p50_ms=_percentile(samples, 0.50) * 1e3,
        p99_ms=_percentile(samples, 0.99) * 1e3,
        step_us=mean_step_s * 1e6, watts=watts,
        tokens_per_joule=tok_s / max(watts, 1e-12),
        kv_bytes=kv_peak, peak_mem=peak,
        mem_capacity=cluster.mem_capacity, feasible=feasible,
        per_class=per_class)


def max_keep_slots(cluster: ClusterSpec, ctx: int,
                   model: dict | None = None,
                   dtype: str = "bfloat16") -> int:
    """Back-of-envelope slot ceiling of the KEEP policy: how many resident
    ``ctx``-token caches fit the per-chip capacity after the weight shard.
    Planning aid only — :func:`evaluate_serve` prices the real graph."""
    m = {**GPT2_SMALL, **(model or {})}
    cap = cluster.mem_capacity
    if not cap:
        return 1 << 30
    eb = dtype_bytes(dtype)
    wb = (12 * m["n_layers"] * m["d_model"] ** 2 // cluster.n_chips
          + m["vocab"] * m["d_model"]) * eb
    per_seq = ctx * kv_bytes_per_token(m, dtype, cluster.n_chips)
    return max(int((cap - wb) // max(per_seq, 1)), 0)


__all__ = ["RequestClass", "RequestMix", "DEFAULT_MIX", "GPT2_SMALL",
           "ServeResult", "evaluate_serve", "kv_bytes_per_token",
           "max_keep_slots"]
