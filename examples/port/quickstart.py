"""MONET quickstart: model → full training graph → HDA cost → fusion →
activation-checkpointing GA, in ~60 lines.

    python examples/port/quickstart.py

The port's twin of ``examples/quickstart.py``: the same calls into
``repro_torch.core`` (it imports neither ``jax`` nor ``repro``) and the
same prints.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", "src"))

from repro_torch.core import (FusionConfig, build_training_graph, edge_tpu,  # noqa: E402
                              ga_checkpointing, resnet18_graph,
                              schedule, solve_fusion)


def main(argv=None):
    argparse.ArgumentParser().parse_args(argv)
    # 1. the workload: ResNet-18 (CIFAR-10 size), forward graph
    fwd = resnet18_graph(batch=1, image=32)
    print(f"forward graph:  {fwd}")

    # 2. MONET's training transformation: + backward + ADAM (paper §III)
    tg = build_training_graph(fwd, optimizer="adam")
    print(f"training graph: {tg.graph}  (activations |A| = "
          f"{len(tg.activations)})")

    # 3. cost on the baseline Edge TPU (paper Fig. 4, Table II bold)
    hda = edge_tpu()
    inf = schedule(fwd, hda)
    trn = schedule(tg.graph, hda)
    print(f"\nEdge TPU baseline, layer-by-layer:")
    print(f"  inference: {inf.latency:12.3e} cycles  {inf.energy:12.3e} pJ")
    print(f"  training : {trn.latency:12.3e} cycles  {trn.energy:12.3e} pJ  "
          f"peak {trn.peak_mem / 1e6:.0f} MB")

    # 4. constraint-based layer fusion (paper §V-A)
    part = solve_fusion(tg.graph, hda, FusionConfig(max_len=6,
                                                    time_limit_s=5))
    fused = schedule(tg.graph, hda, part)
    print(f"\nfused training ({fused.n_subgraphs} subgraphs vs "
          f"{len(tg.graph)} nodes):")
    print(f"  latency {fused.latency / trn.latency:.2%} of base, "
          f"energy {fused.energy / trn.energy:.2%} of base")

    # 5. activation checkpointing via NSGA-II (paper §V-B)
    res = ga_checkpointing(tg, hda, pop_size=12, generations=6, seed=0)
    print(f"\nAC Pareto front ({len(res.pareto)} points), baseline act = "
          f"{res.baseline.act_bytes / 1e6:.2f} MB:")
    for s in res.pareto[:6]:
        print(f"  keep {s.act_bytes / 1e6:6.2f} MB  "
              f"lat ×{s.latency / res.baseline.latency:.3f}  "
              f"energy ×{s.energy / res.baseline.energy:.3f}")


if __name__ == "__main__":
    main()
