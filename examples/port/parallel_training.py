"""Multi-accelerator training scale study (edge boards → data-center pods).

Sweeps parallelism strategies (data / tensor / pipeline and hybrids) over
several chip counts for ResNet-18 and GPT-2 training graphs on both an
edge-class and a data-center-class cluster, and writes the scaling table to
``artifacts/port/parallel_scaling.csv``.

    python examples/port/parallel_training.py
    python examples/port/parallel_training.py --chips 2 4 8 --ga

The port's twin of ``examples/parallel_training.py``: the same calls into
``repro_torch.core`` (it imports neither ``jax`` nor ``repro``) and the
same flags, prints and CSV columns, with its default output under ``artifacts/port/``.
"""

import argparse
import csv
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", "src"))

from repro_torch.core import (build_training_graph, datacenter_cluster,  # noqa: E402
                              edge_cluster, ga_parallel, gpt2_graph, resnet18_graph,
                              sweep_parallel)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--chips", type=int, nargs="+", default=[2, 4, 8])
    ap.add_argument("--batch", type=int, default=2,
                    help="per-chip, per-microbatch local batch")
    ap.add_argument("--out", default="artifacts/port/parallel_scaling.csv")
    ap.add_argument("--ga", action="store_true",
                    help="also run the joint strategy × checkpointing GA")
    args = ap.parse_args(argv)

    workloads = {
        "resnet18": build_training_graph(
            resnet18_graph(args.batch, 32), "adam"),
        "gpt2": build_training_graph(
            gpt2_graph(1, 128, 192, 4, 4, 1024), "adam"),
    }
    clusters = {"edge": edge_cluster, "datacenter": datacenter_cluster}

    rows = []
    for cname, make in clusters.items():
        points = sweep_parallel(workloads, make, args.chips)
        for p in points:
            row = dict(cluster=cname, **p.row())
            rows.append(row)
        # per-cluster scaling headline: best strategy per chip count
        for wname in workloads:
            print(f"\n{cname} / {wname}: best strategy per chip count")
            for n in args.chips:
                cand = [p for p in points
                        if p.n_chips == n and p.results[wname].feasible]
                if not cand:
                    print(f"  {n:3d} chips: no feasible strategy")
                    continue
                best = max(cand, key=lambda p, w=wname: p.results[w].throughput)
                r = best.results[wname]
                print(f"  {n:3d} chips: {best.strategy.label:14s} "
                      f"thr={r.throughput:10.4g} samples/s  "
                      f"E={r.energy:10.4g} pJ  peak={r.peak_mem / 2**20:8.2f}"
                      f" MiB/chip  wire={r.wire_bytes / 2**20:8.2f} MiB")

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    keys = sorted({k for r in rows for k in r})
    with open(args.out, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys)
        w.writeheader()
        w.writerows(rows)
    print(f"\n{len(rows)} rows -> {args.out}")

    if args.ga:
        tg = workloads["resnet18"]
        res, decode = ga_parallel(tg, edge_cluster, args.chips,
                                  pop_size=12, generations=6)
        print("\njoint (chips × strategy × ckpt-budget) GA Pareto front:")
        for x, f in zip(res.pareto_X, res.pareto_F, strict=True):
            cluster, strat, frac = decode(x)
            print(f"  {cluster.n_chips:3d} chips  {strat.label:14s} "
                  f"keep={frac:4.2f}  thr={-f[0]:10.4g}  E={f[1]:10.4g}  "
                  f"peak={f[2] / 2**20:8.2f} MiB")


if __name__ == "__main__":
    main()
