"""Paper §IV-A study driver: Edge-TPU hardware DSE for ResNet-18,
inference vs training (Figs. 1 & 8).  Writes artifacts/port/example_dse.csv.

    python examples/port/dse_resnet.py --sample 100

The port's twin of ``examples/dse_resnet.py``: the same calls into
``repro_torch.core`` (it imports neither ``jax`` nor ``repro``) and the
same flags, prints and CSV columns, with its default output under ``artifacts/port/``.
"""

import argparse
import csv
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", "src"))

from repro_torch.core import (EDGE_TPU_SPACE, build_training_graph,  # noqa: E402
                              compute_resource, edge_tpu, pareto_front,
                              resnet18_graph, sweep)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sample", type=int, default=100)
    ap.add_argument("--out", default="artifacts/port/example_dse.csv")
    args = ap.parse_args(argv)

    fwd = resnet18_graph(1, 32)
    tg = build_training_graph(fwd, "adam").graph
    points = sweep(edge_tpu, EDGE_TPU_SPACE, {"inf": fwd, "train": tg},
                   sample=args.sample)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["compute_resource", "inf_latency", "inf_energy",
                    "train_latency", "train_energy", "config"])
        for p in points:
            w.writerow([compute_resource(p.config),
                        p.results["inf"].latency, p.results["inf"].energy,
                        p.results["train"].latency,
                        p.results["train"].energy, p.config])

    for mode in ("inf", "train"):
        front = pareto_front(points, [lambda p, m=mode: p.results[m].latency,
                                      lambda p, m=mode: p.results[m].energy])
        print(f"\n{mode}: {len(front)} Pareto-optimal configs "
              f"of {len(points)}:")
        for p in sorted(front, key=lambda p, m=mode: p.results[m].latency)[:5]:
            r = p.results[mode]
            print(f"  lat={r.latency:11.4g}  E={r.energy:11.4g}  "
                  f"{p.config}")
    print(f"\nfull table -> {args.out}")


if __name__ == "__main__":
    main()
