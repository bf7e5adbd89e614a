"""Inference-serving study: KV-cache policies from edge board to pod slice.

Sweeps continuous-batching slot counts and KV residency policies
(KEEP / RECOMPUTE / OFFLOAD — ``repro_torch.core.serving``, docs/serving.md) over
an edge-class and a data-center-class cluster for the small-GPT-2 workload,
prints the requests/sec × tail-latency × per-chip-memory Pareto front and
the throughput-per-watt ranking, and writes every cell to
``artifacts/port/serve_pareto.csv``.

    python examples/port/serve_lm.py
    python examples/port/serve_lm.py --chips 1 4 --slots 8 32

The port's twin of ``examples/serve_lm.py``: the same calls into
``repro_torch.core`` (it imports neither ``jax`` nor ``repro``) and the
same flags, prints and CSV columns, with its default output under ``artifacts/port/``.
"""

import argparse
import csv
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", "src"))

from repro_torch.core import (datacenter_cluster, edge_cluster, pareto_front,  # noqa: E402
                              sweep_serve)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--chips", type=int, nargs="+", default=[1, 4])
    ap.add_argument("--slots", type=int, nargs="+", default=[4, 16, 64])
    ap.add_argument("--out", default="artifacts/port/serve_pareto.csv")
    args = ap.parse_args(argv)

    clusters = {"edge": edge_cluster, "datacenter": datacenter_cluster}
    rows = []
    for cname, make in clusters.items():
        points = sweep_serve(make, args.chips, slots_list=args.slots)
        for p in points:
            rows.append(dict(site=cname, **p.row()))

        # requests/sec × p99 × per-chip memory × power (all minimized;
        # throughput negated) — the front the paper-style serving plot
        # reads off; watts keeps small clusters non-dominated, making the
        # throughput-per-watt trade visible
        front = pareto_front(points, (lambda p: -p.result.rps,
                                      lambda p: p.result.p99_ms,
                                      lambda p: p.result.peak_mem,
                                      lambda p: p.result.watts))
        print(f"\n{cname}: rps × p99 × per-chip-mem × watts front")
        for p in sorted(front, key=lambda p: (p.n_chips, p.slots)):
            r = p.result
            print(f"  {p.n_chips:2d} chips  {p.slots:3d} slots "
                  f"{p.policy:9s} rps={r.rps:8.2f}  p99={r.p99_ms:10.1f}ms  "
                  f"peak={r.peak_mem / 2**20:8.1f}MB  {r.watts:7.2f}W  "
                  f"{'' if r.feasible else '(infeasible)'}")

        best = max(points, key=lambda p: p.result.tokens_per_joule)
        r = best.result
        print(f"{cname}: best tokens/J = {r.tokens_per_joule:.1f} "
              f"({best.n_chips} chips, {best.slots} slots, {best.policy}, "
              f"{r.tokens_per_s:.1f} tok/s @ {r.watts:.2f} W)")

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    keys = sorted({k for r in rows for k in r})
    with open(args.out, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys)
        w.writeheader()
        w.writerows(rows)
    print(f"\n{len(rows)} rows -> {args.out}")


if __name__ == "__main__":
    main()
