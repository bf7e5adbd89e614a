"""Goodput-vs-utilization study: failure-aware training from edge to pod.

Sweeps parallelism strategies over chip counts on an edge-class and a
data-center-class cluster, deflating every ideal-machine estimate into
goodput via the attached fault models (checkpoint interval selection,
replay, restart — ``repro_torch.core.resilience``), and writes the table plus
the per-cluster goodput/efficiency Pareto front to
``artifacts/port/resilience_goodput.csv``.

    python examples/port/resilience.py
    python examples/port/resilience.py --chips 1 2 4 8

The port's twin of ``examples/resilience.py``: the same calls into
``repro_torch.core`` (it imports neither ``jax`` nor ``repro``) and the
same flags, prints and CSV columns, with its default output under ``artifacts/port/``.
"""

import argparse
import csv
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", "src"))

from repro_torch.core import (build_training_graph, datacenter_cluster,  # noqa: E402
                              edge_cluster, mlp_graph, pareto_front,
                              resnet18_graph, sweep_resilience)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--chips", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--batch", type=int, default=2,
                    help="per-chip, per-microbatch local batch")
    ap.add_argument("--out", default="artifacts/port/resilience_goodput.csv")
    args = ap.parse_args(argv)

    workloads = {
        "mlp": build_training_graph(
            mlp_graph(batch=args.batch, widths=(256, 256, 256)), "adam"),
        "resnet18": build_training_graph(
            resnet18_graph(args.batch, 32), "adam"),
    }
    clusters = {"edge": edge_cluster, "datacenter": datacenter_cluster}

    rows = []
    for cname, make in clusters.items():
        points = sweep_resilience(workloads, make, args.chips)
        for p in points:
            rows.append(dict(cluster=cname, **p.row()))
        for wname in workloads:
            # goodput-vs-utilization Pareto: maximize both, so minimize the
            # negations
            front = pareto_front(
                points, (lambda p, w=wname: -p.results[w].goodput,
                         lambda p, w=wname: -p.results[w].efficiency))
            print(f"\n{cname} / {wname}: goodput-vs-utilization front")
            for p in sorted(front, key=lambda p: p.n_chips):
                r = p.results[wname]
                print(f"  {p.n_chips:3d} chips  {p.strategy.label:14s} "
                      f"goodput={r.goodput:10.4g} samples/s  "
                      f"raw={r.raw_throughput:10.4g}  "
                      f"eff={r.efficiency:8.6f}  "
                      f"ckpt every {r.ckpt.interval_s:8.1f}s")

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    keys = sorted({k for r in rows for k in r})
    with open(args.out, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys)
        w.writeheader()
        w.writerows(rows)
    print(f"\n{len(rows)} rows -> {args.out}")


if __name__ == "__main__":
    main()
