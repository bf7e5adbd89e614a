"""Fusion-configuration search study (paper §V-A, extended to training).

Runs the boundary-genome NSGA-II fusion search (``repro_torch.core.fusion_search``)
over full training iterations (fwd + bwd + Adam) of ResNet-18 and a small
GPT-2 on the Edge-TPU HDA, and writes the Pareto fronts to
``artifacts/port/fusion_pareto.csv``.  For each workload it reports

* the unfused layer-by-layer baseline and the greedy SRAM-feasible seed,
* the searched front on (latency, peak memory, energy),
* whether the searched-best config dominates the unfused baseline on
  (latency, peak memory) — the paper's headline fusion claim, and
* the same search composed with the activation-policy axis (all-RECOMPUTE
  and all-OFFLOAD rewrites searched end-to-end).

    python examples/port/fusion_search.py
    python examples/port/fusion_search.py --pop 32 --gens 16

The port's twin of ``examples/fusion_search.py``: the same calls into
``repro_torch.core`` (it imports neither ``jax`` nor ``repro``) and the
same flags, prints and CSV columns, with its default output under ``artifacts/port/``.
"""

import argparse
import csv
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", "src"))

from repro_torch.core import (ActivationPolicy, FusionSearchConfig,  # noqa: E402
                              build_training_graph, edge_tpu, get_engine,
                              gpt2_graph, resnet18_graph, search_fusion,
                              search_fusion_policy, uniform_policy)


def report(tag, res, rows):
    base, best = res.baseline, res.best
    print(f"{tag}: front {len(res.pareto)} configs | "
          f"baseline lat {base.latency:.0f} peak {base.peak_mem / 1e6:.1f}MB"
          f" | best lat {best.latency:.0f} (x"
          f"{best.latency / base.latency:.3f}) peak "
          f"{best.peak_mem / 1e6:.1f}MB | dominates baseline: "
          f"{res.best_dominates_baseline}")
    front_parts = {c.partition for c in res.pareto}
    for kind, c in (("baseline", base), ("greedy", res.greedy),
                    ("best", best)):
        rows.append(dict(c.as_row(), workload=tag, point=kind,
                         on_front=c.partition in front_parts))
    for i, c in enumerate(res.pareto):
        print(f"    front[{i}]: lat x{c.latency / base.latency:.3f}  "
              f"peak x{c.peak_mem / base.peak_mem:.3f}  "
              f"energy x{c.energy / base.energy:.3f}  "
              f"groups {c.n_subgraphs}")
        rows.append(dict(c.as_row(), workload=tag, point=f"front{i}",
                         on_front=True))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pop", type=int, default=24)
    ap.add_argument("--gens", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="artifacts/port/fusion_pareto.csv")
    args = ap.parse_args(argv)

    cfg = FusionSearchConfig(pop_size=args.pop, generations=args.gens,
                             seed=args.seed)
    policy_cfg = FusionSearchConfig(pop_size=max(8, args.pop // 2),
                                    generations=max(4, args.gens // 2),
                                    seed=args.seed)
    hda = edge_tpu()
    engine = get_engine(hda)
    workloads = {
        "resnet18": build_training_graph(resnet18_graph(4, 32), "adam"),
        "gpt2": build_training_graph(gpt2_graph(1, 128, 192, 2, 4, 1024),
                                     "adam"),
    }

    rows: list = []
    all_dominate = True
    for wname, tg in workloads.items():
        res = search_fusion(tg.graph, hda, cfg, engine=engine)
        report(wname, res, rows)
        all_dominate &= res.best_dominates_baseline
        print(f"    cache: {res.stats['memo_hits']} memo hits / "
              f"{res.stats['genome_evals']} genome evals, "
              f"{res.stats['unique_partitions']} unique partitions, "
              f"{res.stats['fresh_signings']} fresh node signings, "
              f"subgraph-cache hits "
              f"{res.stats['engine_sg_hits']}\n")

        # fusion × activation-policy composition (memory axis)
        for pname, which in (("recompute", ActivationPolicy.RECOMPUTE),
                             ("offload", ActivationPolicy.OFFLOAD)):
            pres = search_fusion_policy(tg, hda, uniform_policy(tg, which),
                                        policy_cfg, engine=engine)
            report(f"{wname}+{pname}", pres, rows)
        print()

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    keys = sorted({k for r in rows for k in r})
    with open(args.out, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys)
        w.writeheader()
        w.writerows(rows)
    print(f"{len(rows)} rows -> {args.out}")
    if not all_dominate:
        print("WARNING: searched best did not dominate the unfused "
              "baseline on every workload — raise --pop/--gens")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
