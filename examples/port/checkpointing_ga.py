"""Paper §V-B end-to-end: NSGA-II activation-checkpointing search on the
MONET cost model, then apply the chosen keep-set to a REAL PyTorch training
step as a selective-checkpointing policy (the beyond-paper integration).

    python examples/port/checkpointing_ga.py                 # on the GPU
    python examples/port/checkpointing_ga.py --device cpu

The port's twin of ``examples/checkpointing_ga.py``: the same search on
``repro_torch.core`` (it imports neither ``jax`` nor ``repro``) and the same
prints; step 3 runs the toy block under ``torch.utils.checkpoint`` with the
policy ``keepset_to_policy`` gives, on ``--device`` (the GPU unless ``cpu``
is named).  In fp32 its loss is 8·64·64 = 32768 and its grad norm 512: w2's
gradient is 8 everywhere, w1's 0 (tanh′(64) rounds to 0).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", "src"))

import torch  # noqa: E402

from repro_torch import resolve_device  # noqa: E402
from repro_torch.core import (build_training_graph, edge_tpu, ga_checkpointing,  # noqa: E402
                              gpt2_graph, keepset_to_policy)
from repro_torch.core.remat_policy import (checkpoint_name, checkpointed,  # noqa: E402
                                           family_of)


def block(w, x):
    h = checkpoint_name(torch.tanh(x @ w["w1"]), "mlp_hidden")
    o = checkpoint_name(h @ w["w2"], "attn_out")
    return o.sum()


def value_and_grad(f, device):
    """(loss, {name: gradient}) of ``f(w, x)`` at w1 = w2 = ones(64, 64),
    x = ones(8, 64), fp32 on ``device``."""
    w = {k: torch.ones(64, 64, device=device, requires_grad=True) for k in ("w1", "w2")}
    x = torch.ones(8, 64, device=device)
    loss = f(w, x)
    return loss.detach(), dict(zip(w, torch.autograd.grad(loss, list(w.values())),
                                   strict=True))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a GPU) | cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # 1. search on the simulator (small GPT-2, the paper's NLP case study)
    g = gpt2_graph(batch=1, seq=128, d_model=256, n_layers=2, n_heads=4,
                   vocab=2048)
    tg = build_training_graph(g, "adam")
    hda = edge_tpu()
    res = ga_checkpointing(tg, hda, pop_size=16, generations=8, seed=0)

    print(f"baseline: {res.baseline.act_bytes / 1e6:.2f} MB activations, "
          f"latency {res.baseline.latency:.4g}")
    print(f"Pareto front ({len(res.pareto)} points):")
    for s in res.pareto:
        print(f"  {s.act_bytes / 1e6:6.2f} MB  "
              f"lat ×{s.latency / res.baseline.latency:.3f}  "
              f"E ×{s.energy / res.baseline.energy:.3f}")

    # 2. pick the most memory-frugal point within 10% latency
    ok = [s for s in res.pareto
          if s.latency <= 1.1 * res.baseline.latency]
    chosen = min(ok or res.pareto, key=lambda s: s.act_bytes)
    fams = sorted({f for f in map(family_of, chosen.keep) if f})
    print(f"\nchosen keep-set -> activation families: {fams}")

    # 3. turn it into a selective-checkpointing policy on a real block
    policy = keepset_to_policy(chosen.keep)
    loss, grads = value_and_grad(checkpointed(block, policy), device)
    gnorm = torch.sqrt(sum(torch.sum(g ** 2) for g in grads.values()))
    print(f"real PyTorch step under the MONET-chosen policy: loss={loss:.1f}, "
          f"grad norm={gnorm:.1f}")
    print("(the production stack consumes the same policy via "
          "ModelConfig.remat = 'save:<families>')")
    return float(loss), float(gnorm)


if __name__ == "__main__":
    main()
