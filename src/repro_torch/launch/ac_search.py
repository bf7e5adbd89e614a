"""MONET's activation-checkpointing search for a model of the port, and the
``cfg.remat`` policy each of its keep-sets becomes.

The search runs on the training graph of MONET's GPT-2 builder
(``core/zoo.gpt2_graph``) at the model's batch, sequence, width, depth, head
count and vocabulary (``search_graph``; what that graph leaves out of the
model is its ``reduced``).  It has two legs, as
``benchmarks/bench_checkpointing.py::run_milp_vs_ga`` runs them: the exact
knapsack at half the bytes of keeping every activation, and NSGA-II
(``ga_checkpointing``), whose fastest Pareto point within the knapsack's bytes
is taken.  Each keep-set becomes a ``save:`` policy through
``core/remat_policy.keepset_to_policy``, which maps graph tensors onto the
model's activation families: the training step keeps families, not layers,
so every point of the front whose tensors fall in the same families gives the
same policy.

The cycles, energy and bytes of a ``Choice`` are MONET's analytic model on
``hda``, not a measurement of any device.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

from ..core import checkpointing, remat_policy
from ..core.checkpointing import (activation_set, evaluate_checkpointing, ga_checkpointing,
                                  knapsack_baseline, stored_activation_bytes)
from ..core.engine import clear_engines
from ..core.training_transform import TrainingGraph, build_training_graph
from ..core.zoo import gpt2_graph


@dataclass(frozen=True)
class Choice:
    """One leg's keep-set, what MONET's model says of it, and its policy."""
    keep: tuple            # graph tensor names, sorted
    latency: float         # modelled cycles of one training step
    energy: float          # modelled energy
    act_bytes: int         # modelled stored activation bytes
    seconds: float         # host time of the leg (search and evaluation)
    policy: str            # ``cfg.remat``: ``save:`` and the families

    def summary(self) -> dict:
        return {"keeps": len(self.keep), "modelled_cycles": self.latency,
                "modelled_energy": self.energy, "modelled_stored_bytes": self.act_bytes,
                "policy": self.policy, "search_seconds": self.seconds}


def search_graph(cfg, batch: int, seq: int) -> tuple[TrainingGraph, str]:
    """(the AdamW training graph MONET searches for ``cfg`` at ``batch`` ×
    ``seq``, what it leaves out of the model)."""
    g = gpt2_graph(batch=batch, seq=seq, d_model=cfg.d_model, n_layers=cfg.n_layers,
                   n_heads=cfg.n_heads, vocab=cfg.vocab)
    reduced = (f"MONET's GPT-2 builder at {cfg.name}'s batch, sequence, width, depth, heads "
               f"and vocabulary: multi-head attention, {cfg.n_heads} heads of "
               f"{cfg.d_model // cfg.n_heads} ({cfg.name}: kv heads {cfg.n_kv_heads}, head dim "
               f"{cfg.head_dim_}), d_ff 4 x {cfg.d_model} ({cfg.d_ff}), GELU ({cfg.mlp}), "
               f"LayerNorm (RMSNorm), learned positions (RoPE), no window "
               f"({cfg.window or 'none'})")
    return build_training_graph(g, "adam"), reduced


def policy_of(keep) -> str:
    """``cfg.remat`` for a keep-set: ``save:`` and the families that
    ``keepset_to_policy`` keeps (``save:`` alone keeps nothing)."""
    policy = remat_policy.keepset_to_policy(keep)
    names = () if policy is remat_policy.nothing_saveable else sorted(policy.names)
    return "save:" + ",".join(names)


def search(tg: TrainingGraph, hda) -> dict:
    """{"knapsack": Choice, "ga": Choice, "front": [policy of each GA Pareto
    point]}: ``ga_checkpointing`` at its defaults and seed 0, from cold caches
    (the engines and the knapsack's tables are dropped first, so a second call
    recomputes everything)."""
    clear_engines()
    checkpointing._KNAPSACK.clear()
    acts = activation_set(tg)
    t0 = time.perf_counter()
    kept, _ = knapsack_baseline(tg, stored_activation_bytes(tg, acts) // 2)
    ks = evaluate_checkpointing(tg, hda, set(kept))
    t1 = time.perf_counter()
    res = ga_checkpointing(tg, hda, seed=0)
    t2 = time.perf_counter()
    within = [s for s in res.pareto if s.act_bytes <= ks.act_bytes]
    if not within:
        raise RuntimeError(f"no GA Pareto point stores at most the knapsack's "
                           f"{ks.act_bytes} bytes")
    ga = min(within, key=lambda s: s.latency)
    return {"knapsack": Choice(ks.keep, ks.latency, ks.energy, ks.act_bytes, t1 - t0,
                               policy_of(ks.keep)),
            "ga": Choice(ga.keep, float(ga.latency), float(ga.energy), ga.act_bytes, t2 - t1,
                         policy_of(ga.keep)),
            "front": [policy_of(s.keep) for s in res.pareto]}
