"""Seeded fault-injection harness for the model-invariant verifier.

Resilience cuts both ways: the cost model reasons about hardware faults
(``repro.core.resilience``), and the framework itself must detect state
corruption — a bit-flip in a cached signature table, a stale consumer
list, a skewed schedule result.  This module deliberately corrupts a
freshly built (graph, schedule, cache) context in every way the verifier
(``repro.core.verify``, docs/verify.md) claims to catch, and checks that
the matching rule actually fires.

Each :class:`FaultSpec` names one corruption class, the structure it
attacks (``graph`` / ``cache`` / ``schedule``) and the rule(s) expected to
fire.  Injections bypass the mutation API on purpose — they poke the same
internal fields a real bug (or a real bit-flip) would, so the campaign is
evidence the verifier's coverage holds, not that the API is well-behaved.

Run the campaign (CI's ``faults`` step)::

    PYTHONPATH=src python -m repro_torch.core.faultinject --seed 0

The port's own copy of ``repro.core.faultinject`` (numpy and plain Python):
names, signatures and numeric code are the reference's, held bit for
bit against it by ``tests/test_torch_faultinject.py``.
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass, replace

import numpy as np

from .accelerators import edge_tpu
from .checkpointing import apply_policy
from .engine import Fingerprint, graph_sigs
from .memory import ActivationPolicy
from .scheduling import schedule
from .training_transform import _build_training_graph
from .verify import ERROR, verify_cache, verify_graph, verify_schedule
from .zoo import _build_mlp


@dataclass(frozen=True)
class FaultSpec:
    """One corruption class: what it attacks and which rule must catch it."""

    name: str
    target: str                    # 'graph' | 'cache' | 'schedule'
    rules: tuple                   # rule ids, any of which counts as caught
    description: str


@dataclass
class InjectionReport:
    fault: str
    target: str
    subject: str                   # what was corrupted
    caught: bool
    expected: tuple
    fired: tuple                   # error-severity rules that fired


class _Context:
    """A fresh, verified-clean (graph, hda, partition, result) under test.

    The workload is a small MLP training graph with one RECOMPUTE and one
    OFFLOAD activation, so recompute clones, DMA pairs and spill accounting
    all exist as corruption material."""

    def __init__(self):
        # build through the private constructors, NOT the memoized public
        # entry points: injections mutate the graph in place *bypassing the
        # mutation API*, and `graph.copy()`'s copy-on-write consumer lists
        # would leak that corruption back into the construction-memo
        # masters every later caller receives
        fwd = _build_mlp(4, 64, (16, 16, 16), 10, True)
        tg = _build_training_graph(fwd, "adam", True, "float32", "bfloat16")
        policy = {}
        acts = list(tg.activations)
        if acts:
            policy[acts[0]] = ActivationPolicy.RECOMPUTE
        if len(acts) > 1:
            policy[acts[-1]] = ActivationPolicy.OFFLOAD
        self.graph = apply_policy(tg, policy)
        self.hda = edge_tpu()
        self.partition = [(n,) for n in self.graph.topo_order()]
        self.result = schedule(self.graph, self.hda, list(self.partition))


def _pick(rng, items):
    items = sorted(items)
    return items[int(rng.integers(len(items)))]


# ---------------------------------------------------------------------------
# graph-structure injections (verify_graph)
# ---------------------------------------------------------------------------


def _inj_consumer_phantom(ctx, rng):
    g = ctx.graph
    t = _pick(rng, [t for t, cs in g.consumers.items() if cs])
    other = _pick(rng, [n for n, nd in g.nodes.items() if t not in nd.inputs])
    g.consumers[t].append(other)
    return f"consumers[{t}] += {other}"


def _inj_consumer_drop(ctx, rng):
    g = ctx.graph
    t = _pick(rng, [t for t, cs in g.consumers.items() if cs])
    victim = g.consumers[t].pop(int(rng.integers(len(g.consumers[t]))))
    return f"consumers[{t}] -= {victim}"


def _inj_producer_swap(ctx, rng):
    g = ctx.graph
    t = _pick(rng, g.producer)
    wrong = _pick(rng, [n for n in g.nodes if n != g.producer[t]])
    g.producer[t] = wrong
    return f"producer[{t}] = {wrong}"


def _inj_topo_scramble(ctx, rng):
    g = ctx.graph
    order = g.topo_order()             # force the cache, then corrupt it
    g._topo[1].reverse()
    return f"reversed cached topo order ({len(order)} nodes)"


def _inj_adjacency_drift(ctx, rng):
    g = ctx.graph
    preds, _ = g.adjacency()           # force the cache, then corrupt it
    n = _pick(rng, [n for n, ps in preds.items() if ps])
    preds[n].clear()
    return f"preds[{n}] cleared"


def _inj_edge_cycle(ctx, rng):
    g = ctx.graph
    preds, _ = g.adjacency()
    for q in reversed(g.topo_order()):
        if g.nodes[q].outputs and preds[q]:
            break
    p = q
    for _ in range(3):                 # walk up to an ancestor
        if not preds[p]:
            break
        p = _pick(rng, preds[p])
    t = g.nodes[q].outputs[0]
    g.nodes[p].inputs.append(t)        # back edge: p now reads q's output
    g.consumers.setdefault(t, []).append(p)
    return f"back edge {q} -> {p} via {t}"


def _inj_recompute_drift(ctx, rng):
    g = ctx.graph
    n = _pick(rng, [n for n in g.nodes if n.endswith(".rc")])
    g.nodes[n].flops += max(g.nodes[n].flops // 8, 1)
    return f"{n}.flops inflated"


def _inj_dma_imbalance(ctx, rng):
    g = ctx.graph
    n = _pick(rng, [n for n, nd in g.nodes.items() if nd.op == "offload"])
    nd = g.nodes[n]
    k = next(iter(nd.dims))
    nd.dims[k] *= 2
    return f"{n}.dims[{k}] doubled"


# ---------------------------------------------------------------------------
# engine-cache injections (verify_cache)
# ---------------------------------------------------------------------------


def _inj_sig_drift(ctx, rng):
    sigs = graph_sigs(ctx.graph)
    n = _pick(rng, sigs.sid)
    sigs.sid[n] += 1
    return f"sid[{n}] += 1"


def _inj_byte_table_drift(ctx, rng):
    sigs = graph_sigs(ctx.graph)
    t = _pick(rng, sigs.tb)
    sigs.tb[t] += 64
    return f"tb[{t}] += 64"


def _inj_static_drift(ctx, rng):
    sigs = graph_sigs(ctx.graph)
    sigs.static += 4096
    return "static += 4096"


def _inj_category_drift(ctx, rng):
    sigs = graph_sigs(ctx.graph)
    t = _pick(rng, sigs.cat)
    sigs.cat[t] = (sigs.cat[t] + 1) % 6
    return f"cat[{t}] rotated"


def _inj_macs_drift(ctx, rng):
    sigs = graph_sigs(ctx.graph)
    sigs.macs_total += 7
    return "macs_total += 7"


def _inj_fingerprint_drift(ctx, rng):
    sigs = graph_sigs(ctx.graph)
    sigs._fp = Fingerprint(("bogus", int(rng.integers(1 << 30))))
    return "cached fingerprint replaced"


def _inj_dirty_leak(ctx, rng):
    graph_sigs(ctx.graph)              # tables clean at current version
    n = _pick(rng, ctx.graph.nodes)
    ctx.graph._dirty_nodes.add(n)
    return f"phantom dirty node {n}"


# ---------------------------------------------------------------------------
# schedule-result injections (verify_schedule)
# ---------------------------------------------------------------------------


def _inj_latency_skew(ctx, rng):
    ctx.result = replace(ctx.result, latency=ctx.result.latency * 1.02 + 16)
    return "latency inflated 2%"


def _inj_busy_skew(ctx, rng):
    busy = dict(ctx.result.per_core_busy)
    r = _pick(rng, busy)
    busy[r] = busy[r] * 1.1 + 32
    ctx.result = replace(ctx.result, per_core_busy=busy)
    return f"per_core_busy[{r}] inflated"


def _inj_peak_skew(ctx, rng):
    ctx.result = replace(ctx.result, peak_mem=ctx.result.peak_mem + 4096)
    return "peak_mem += 4096"


def _inj_spill_skew(ctx, rng):
    ctx.result = replace(ctx.result, spill_bytes=ctx.result.spill_bytes + 128)
    return "spill_bytes += 128"


def _inj_partition_dup(ctx, rng):
    n = _pick(rng, ctx.graph.nodes)
    ctx.partition = list(ctx.partition) + [(n,)]
    return f"{n} duplicated across subgraphs"


def _inj_partition_cycle(ctx, rng):
    g = ctx.graph
    preds, _ = g.adjacency()
    # find a path o -> p -> q and fuse (o, q) around p: cyclic quotient
    for q in g.topo_order():
        if preds[q]:
            p = sorted(preds[q])[0]
            if preds[p]:
                o = sorted(preds[p])[0]
                break
    part = [sg for sg in ctx.partition
            if sg[0] not in (o, q)]
    ctx.partition = part + [(o, q)]
    return f"fused ({o}, {q}) around {p}"


FAULTS: list[FaultSpec] = [
    FaultSpec("consumer_phantom", "graph", ("M001",),
              "consumer list names a node that does not read the tensor"),
    FaultSpec("consumer_drop", "graph", ("M002",),
              "a reader removed from its tensor's consumer list"),
    FaultSpec("producer_swap", "graph", ("M003",),
              "producer map points at the wrong node"),
    FaultSpec("topo_scramble", "graph", ("M006",),
              "cached topological order reversed in place"),
    FaultSpec("adjacency_drift", "graph", ("M005",),
              "cached predecessor list emptied"),
    FaultSpec("edge_cycle", "graph", ("M007",),
              "back edge added: the graph is no longer a DAG"),
    FaultSpec("recompute_drift", "graph", ("M022", "M021"),
              "a .rc clone's flops drift from its source"),
    FaultSpec("dma_imbalance", "graph", ("M023",),
              "an offload node's payload dims no longer match the tensor"),
    FaultSpec("sig_drift", "cache", ("C001",),
              "a cached node signature id flipped"),
    FaultSpec("byte_table_drift", "cache", ("C002",),
              "a cached tensor byte count skewed"),
    FaultSpec("static_drift", "cache", ("C003",),
              "the cached static footprint skewed"),
    FaultSpec("category_drift", "cache", ("C004",),
              "a cached memory-category code rotated"),
    FaultSpec("macs_drift", "cache", ("C008",),
              "the cached MAC total skewed"),
    FaultSpec("fingerprint_drift", "cache", ("C005",),
              "the cached schedule fingerprint replaced"),
    FaultSpec("dirty_leak", "cache", ("C006",),
              "a phantom dirty node at a clean version"),
    FaultSpec("latency_skew", "schedule", ("S006",),
              "reported latency disagrees with the replay"),
    FaultSpec("busy_skew", "schedule", ("S006",),
              "a per-resource busy total disagrees with the replay"),
    FaultSpec("peak_skew", "schedule", ("S005",),
              "peak memory no longer matches the breakdown/lifetime model"),
    FaultSpec("spill_skew", "schedule", ("S007",),
              "spill byte accounting skewed"),
    FaultSpec("partition_dup", "schedule", ("S001",),
              "a node duplicated across fused subgraphs"),
    FaultSpec("partition_cycle", "schedule", ("S002",),
              "a non-convex fusion group makes the quotient cyclic"),
]

_INJECTORS = {s.name: globals()[f"_inj_{s.name}"] for s in FAULTS}


def inject(name: str, seed: int = 0) -> InjectionReport:
    """Build a fresh context, apply one corruption, run the matching
    verifier pass, and report whether an expected rule fired at error
    severity."""
    spec = next(s for s in FAULTS if s.name == name)
    rng = np.random.default_rng(seed)
    ctx = _Context()
    subject = _INJECTORS[name](ctx, rng)
    if spec.target == "graph":
        findings = verify_graph(ctx.graph)
    elif spec.target == "cache":
        findings = verify_cache(ctx.graph)
    else:
        findings = verify_schedule(ctx.graph, ctx.hda, ctx.partition,
                                   ctx.result)
    fired = tuple(sorted({f.rule for f in findings
                          if f.severity == ERROR}))
    caught = any(r in fired for r in spec.rules)
    return InjectionReport(fault=name, target=spec.target, subject=subject,
                           caught=caught, expected=spec.rules, fired=fired)


def run_campaign(seed: int = 0) -> list[InjectionReport]:
    """One report per registered fault class, all from ``seed``."""
    return [inject(s.name, seed=seed) for s in FAULTS]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="seeded fault-injection campaign against the verifier")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    # the uncorrupted context must verify clean, or 'caught' means nothing
    ctx = _Context()
    clean = ([f for f in verify_graph(ctx.graph) if f.severity == ERROR]
             + [f for f in verify_cache(ctx.graph) if f.severity == ERROR]
             + [f for f in verify_schedule(ctx.graph, ctx.hda,
                                           ctx.partition, ctx.result)
                if f.severity == ERROR])
    if clean:
        print(f"baseline context is not clean ({len(clean)} findings):")
        for f in clean[:5]:
            print(f"  {f}")
        return 1

    reports = run_campaign(seed=args.seed)
    missed = [r for r in reports if not r.caught]
    for r in reports:
        mark = "caught" if r.caught else "MISSED"
        print(f"{mark:7s} {r.target:8s} {r.fault:20s} "
              f"expected {','.join(r.expected):10s} "
              f"fired {','.join(r.fired) or '-'}")
    print(f"\n{len(reports) - len(missed)}/{len(reports)} injected fault "
          f"classes caught (seed {args.seed})")
    return 1 if missed else 0


if __name__ == "__main__":
    raise SystemExit(main())
