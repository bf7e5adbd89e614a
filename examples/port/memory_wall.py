"""Memory-wall study: SRAM size × activation policy (recompute vs offload).

Sweeps the Edge-TPU local-SRAM provisioning against the three activation
policies of the unified memory subsystem (KEEP / RECOMPUTE / OFFLOAD, plus a
knapsack-guided hybrid that keeps the most recompute-expensive half and
offloads the rest) for ResNet-18 and a small GPT-2 training iteration, and
writes the recompute-vs-offload Pareto table to ``artifacts/port/memory_wall.csv``
— per-category memory breakdown and DMA spill included (extends paper
Figs. 11/12 along the NeuroTrainer offload axis).

    python examples/port/memory_wall.py
    python examples/port/memory_wall.py --sram 0.5 2 4

The port's twin of ``examples/memory_wall.py``: the same calls into
``repro_torch.core`` (it imports neither ``jax`` nor ``repro``) and the
same flags, prints and CSV columns, with its default output under ``artifacts/port/``.
"""

import argparse
import csv
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", "src"))

from repro_torch.core import (ActivationPolicy, activation_set,  # noqa: E402
                              build_training_graph, edge_tpu, evaluate_policy,
                              get_engine, gpt2_graph, knapsack_baseline,
                              resnet18_graph, stored_activation_bytes,
                              uniform_policy)


def hybrid_policy(tg):
    """Keep the knapsack-chosen (recompute-expensive) half on-chip, offload
    the rest — the linear-model seed for the offload side of the front."""
    total = stored_activation_bytes(tg, activation_set(tg))
    kept, _ = knapsack_baseline(tg, total // 2)
    kept = set(kept)
    return {a: (ActivationPolicy.KEEP if a in kept
                else ActivationPolicy.OFFLOAD)
            for a in activation_set(tg)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sram", type=float, nargs="+", default=[0.5, 1, 2, 4],
                    help="Edge-TPU local SRAM sizes (MB) to sweep")
    ap.add_argument("--out", default="artifacts/port/memory_wall.csv")
    args = ap.parse_args(argv)

    workloads = {
        "resnet18": build_training_graph(resnet18_graph(4, 32), "adam"),
        "gpt2": build_training_graph(gpt2_graph(1, 128, 192, 2, 4, 1024),
                                     "adam"),
    }

    rows = []
    for wname, tg in workloads.items():
        policies = {
            "keep": {},
            "recompute": uniform_policy(tg, ActivationPolicy.RECOMPUTE),
            "offload": uniform_policy(tg, ActivationPolicy.OFFLOAD),
            "hybrid": hybrid_policy(tg),
        }
        for sram_mb in args.sram:
            hda = edge_tpu(local_mb=sram_mb)
            engine = get_engine(hda)
            base = None
            for pname, pol in policies.items():
                s = evaluate_policy(tg, hda, pol, engine=engine)
                if pname == "keep":
                    base = s
                row = dict(s.schedule.as_row(), workload=wname,
                           sram_mb=sram_mb, policy=pname,
                           peak_mem=s.peak_mem, act_bytes=s.act_bytes,
                           lat_vs_keep=s.latency / base.latency,
                           peak_vs_keep=s.peak_mem / base.peak_mem)
                rows.append(row)
                print(f"{wname:9s} sram={sram_mb:4.1f}MB {pname:9s} "
                      f"lat x{row['lat_vs_keep']:.3f}  "
                      f"peak {s.peak_mem / 1e6:8.2f}MB "
                      f"(x{row['peak_vs_keep']:.3f})  "
                      f"spill {s.spill_bytes / 1e6:6.2f}MB")
        # recompute-vs-offload Pareto headline at the baseline SRAM
        print(f"\n{wname}: recompute-vs-offload at "
              f"{args.sram[-1]}MB SRAM — points on the "
              "(latency, peak) front:")
        last = [r for r in rows
                if r["workload"] == wname and r["sram_mb"] == args.sram[-1]]
        for r in last:
            dominated = any(
                o is not r and o["latency"] <= r["latency"]
                and o["peak_mem"] <= r["peak_mem"]
                and (o["latency"] < r["latency"]
                     or o["peak_mem"] < r["peak_mem"]) for o in last)
            mark = "  " if dominated else "* "
            print(f"  {mark}{r['policy']:9s} lat x{r['lat_vs_keep']:.3f} "
                  f"peak x{r['peak_vs_keep']:.3f}")
        print()

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    keys = sorted({k for r in rows for k in r})
    with open(args.out, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys)
        w.writeheader()
        w.writerows(rows)
    print(f"{len(rows)} rows -> {args.out}")


if __name__ == "__main__":
    main()
