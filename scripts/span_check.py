#!/usr/bin/env python
"""Hold the port's spans (``repro_torch.core.spans``) to the profiler's own
trace over one traced run of a benchmark cell, on the card:

    python3 scripts/span_check.py --workload <name> [--seed N] [--seconds S]

Runs ``portbench``'s harness as ``--trace 1`` does (a warm-up step under a
first profiler, ``PROFILE_STEPS`` steps under a second) and prints one JSON
line:

* ``metrics``, ``device``, ``correct``: the result line's;
* ``step_vs_span``: the ``step`` span's stream ms a step against the profiled
  steps' device span a step (``Trace.span_s() / steps``);
* ``stages_vs_busy``: the outermost stage spans' stream ms a step, every
  phase (``spans.STAGES``; stages inside another left out), against the
  device's busy time a step (``Trace.busy_s() / steps``);
* ``overlaps``: pairs of those stages whose stream intervals overlap within a
  phase, and the largest overlap in ms;
* ``spans``: each span's mean a step by phase (count, host ms, stream ms);
* ``policy_ops``, ``launches``: the counters a step;
* ``gaps``: the longest idle gaps, each with the innermost span the host was
  in, the innermost host event (what ``devtrace`` names it after), and the
  stage whose kernel ended the gap, with when its launch ran;
* ``device_by_stage``: device ms a step of the kernels each stage launched
  (a kernel belongs to the innermost stage span open on the launching thread
  when its launch call ran, ``cuda*`` or ``cuLaunch*``, matched by the
  profiler's correlation id), all kernels and the elementwise / reduction
  ones (named as ``model.elementwise_ms`` names them), ``(none)`` for
  kernels no stage launched.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import statistics
import sys
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def overlaps(recs) -> tuple[int, float]:
    """Overlapping pairs of outermost stage segments within a phase (stream
    intervals), and the largest overlap in ms."""
    n, worst = 0, 0.0
    for r in recs:
        by_phase = defaultdict(list)
        for name, phase, top, segs in r["intervals"]:
            if top:
                by_phase[phase] += [(s[2], s[3], name) for s in segs]
        for segs in by_phase.values():
            segs.sort(key=lambda s: (s[0] is None, s[0] or 0.0))
            end = float("-inf")
            for s0, s1, _ in segs:
                if s0 is not None and s0 < end:
                    n += 1
                    worst = max(worst, end - s0)
                end = max(end, s1 if s1 is not None else end)
    return n, worst


def innermost(rows, t: int, names) -> str | None:
    best = None
    for n, s, e in rows:
        if s <= t < e and (names is None or n in names or n.startswith("gc.gen")) \
                and (best is None or s > best[1]):
            best = (n, s)
    return best[0] if best else None


ELEMENTWISE = ("elementwise", "reduce")


class Launches:
    """The profiled kernels, each with the innermost stage span open on the
    launching thread when its launch call ran (matched by the profiler's
    correlation id)."""

    def __init__(self, prof):
        from torch.autograd import DeviceType

        from repro_torch.core.spans import STAGES

        self.stages, launches, self.kernels = defaultdict(list), {}, []
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                self.kernels.append([e.name(), e.start_ns(), e.duration_ns(),
                                     e.correlation_id(), e.linked_correlation_id()])
            elif e.device_type() == DeviceType.CPU:
                name = e.name()
                if name.startswith(("cuda", "cuLaunch")):     # cuBLAS launches through the driver API
                    launches[e.correlation_id()] = (e.start_ns(), e.start_thread_id())
                elif name in STAGES:
                    self.stages[e.start_thread_id()].append((e.start_ns(), e.end_ns(), name))
        for v in self.stages.values():
            v.sort()
        self.starts = {th: [s for s, _, _ in v] for th, v in self.stages.items()}
        for k in self.kernels:
            at = launches.get(k[3]) or launches.get(k[4])
            k.append(self.owner(*at) if at is not None else "(none)")
            k.append(at[0] if at is not None else None)

    def owner(self, t: int, th: int) -> str:
        v = self.stages.get(th, [])
        i = bisect.bisect_right(self.starts.get(th, []), t)
        for _, s1, name in reversed(v[max(0, i - 64):i]):
            if s1 > t:
                return name
        return "(none)"

    def by_stage(self, steps: int) -> dict:
        """Device ms a step of the kernels each stage launched: all, and the
        elementwise and reduction ones."""
        out: dict = defaultdict(lambda: [0.0, 0.0])
        for name, _, dur, _, _, owner, _ in self.kernels:
            out[owner][0] += dur / 1e6 / steps
            if any(p in name for p in ELEMENTWISE):
                out[owner][1] += dur / 1e6 / steps
        return {k: {"device_ms": v[0], "elementwise_ms": v[1]} for k, v in
                sorted(out.items(), key=lambda kv: -kv[1][0])}

    def resumed_by(self, t: int) -> list:
        """The kernel that ends an idle gap at ``t``: its stage, and how long
        after the gap began the host launched it (ms)."""
        for name, start, _, _, _, owner, launched in self.kernels:
            if start == t:
                return [owner, None if launched is None else launched / 1e6, name[:40]]
        return [None, None, None]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=3_000_000_001)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--device", default="cuda", help="cpu: a rehearsal, no stream ms")
    args = ap.parse_args(argv)
    build = ROOT / "build"
    os.environ.setdefault("REPRO_TORCH_BUILD_DIR", str(build))
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    from portbench import harness
    from portbench.devtrace import Trace
    from repro_torch.core import spans

    kept = {}
    of = Trace.of.__func__

    def keep(cls, prof, steps, wall):
        kept["trace"] = of(cls, prof, steps, wall)
        try:        # a report of its own: its failure must not lose the others
            kept["launches"] = Launches(prof)
        except Exception as exc:  # noqa: BLE001
            kept["launches"] = repr(exc)
        return kept["trace"]

    Trace.of = classmethod(keep)
    cell = harness.resolve(args.workload, ROOT)
    result, _ = harness.run(cell, args.seed, args.seconds, True, args.device)
    trace = kept["trace"]
    n = trace.steps
    recs = spans.steps()[-n:]

    def mean(f):
        vals = [f(r) for r in recs]
        return None if None in vals else statistics.fmean(vals)

    by_span = {name: {ph: {k: mean(lambda r, name=name, ph=ph, k=k:
                                   (r["spans"].get(name, {}).get(ph) or {}).get(k) or 0.0)
                           for k in ("count", "host_ms", "stream_ms")}
                      for ph in phases}
               for name, phases in recs[-1]["spans"].items()}
    stages = mean(lambda r: sum(d["top_stream_ms"] or 0.0 for ph in r["spans"].values()
                                for d in ph.values()))
    names = set(by_span)
    launched = kept["launches"]
    by_stage = launched if isinstance(launched, str) else launched.by_stage(n)
    gaps = []
    m = trace.merged()
    for g, t, t1 in sorted(((m[i + 1][0] - m[i][1], m[i][1], m[i + 1][0])
                            for i in range(len(m) - 1)), reverse=True)[:10]:
        gap = {"ms": g / 1e6, "span": innermost(trace.host, t, names),
               "host": innermost(trace.host, t, None)}
        if not isinstance(launched, str):
            owner, at, kernel = launched.resumed_by(t1)
            gap["resumed_by"] = [owner, None if at is None else at - t / 1e6, kernel]
        gaps.append(gap)
    pairs, worst = overlaps(recs)
    out = {
        "workload": args.workload, "seed": args.seed, "correct": result["correct"],
        "metrics": {k: v["value"] for k, v in result["metrics"].items()},
        "device": result["device"],
        "step_vs_span": [mean(lambda r: r["spans"]["step"]["fwd"]["stream_ms"]),
                         trace.span_s() / n * 1e3],
        "stages_vs_busy": [stages, trace.busy_s() / n * 1e3],
        "overlaps": [pairs, worst],
        "policy_ops": [r["policy_ops"] for r in recs],
        "launches": [r["launches"] for r in recs],
        "spans": by_span, "gaps": gaps, "device_by_stage": by_stage,
        "idle_gaps_devtrace": result.get("breakdown", {}).get("idle_gaps"),
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
