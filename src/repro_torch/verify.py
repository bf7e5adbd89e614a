"""``python -m repro_torch.verify`` — run the model-invariant verifier
(``repro.core.verify``, docs/verify.md) over the reference workloads.

Covers the acceptance matrix: ResNet-18 and a small GPT-2 training graph,
each under ``fusion="search"`` and all three uniform activation policies
(KEEP / RECOMPUTE / OFFLOAD), plus one dp/tp/pp parallel configuration and
its degraded-mode (survivor-set) remap — the C009 coherence pass plus a
zero-fresh-signings assertion that the degrade rewrite stayed on the
engine's warm path — and the inference-serving graphs (prefill, resident
decode, paged decode) under the M-series KV-conservation rules (M025).
Prints every finding (rule id, severity, offending name) and exits
non-zero if any is reported.

Options:
  --quick    verify a small MLP only (seconds instead of ~a minute)
  --rules    print the rule registry and exit

The port's own copy of ``repro/verify.py``: the same acceptance matrix
and output over the port's ``core`` (only ``prog`` differs), held
against the reference's by ``tests/test_torch_cli.py``.
"""

from __future__ import annotations

import argparse
import sys

from .core import (ActivationPolicy, Finding, FusionSearchConfig,
                   ParallelStrategy, build_training_graph, degrade,
                   edge_cluster, edge_tpu, evaluate_parallel, get_engine,
                   gpt2_decode_graph, gpt2_graph, gpt2_prefill_graph,
                   mlp_graph, parallelize, resnet18_graph, schedule,
                   uniform_policy)
from .core.checkpointing import apply_policy
from .core.engine import sign_count
from .core.fusion_search import fusion_partition
from .core.verify import RULES, verify_parallel, verify_result

_SEARCH = FusionSearchConfig(pop_size=8, generations=4, seed=0)
_POLICIES = (ActivationPolicy.KEEP, ActivationPolicy.RECOMPUTE,
             ActivationPolicy.OFFLOAD)


def _verify_policies(label: str, tg, hda, engine) -> list:
    """fusion=search × {KEEP, RECOMPUTE, OFFLOAD} on one training graph."""
    findings = []
    for pol in _POLICIES:
        g2 = apply_policy(tg, uniform_policy(tg, pol))
        part, quotient = fusion_partition(g2, hda, "search", _SEARCH, engine)
        res = schedule(g2, hda, part, engine=engine, quotient=quotient)
        fs = verify_result(g2, hda,
                           part or [(n,) for n in g2.topo_order()],
                           res, engine=engine, strict=False)
        print(f"  {label} policy={pol.name:<9} fusion=search  "
              f"{len(fs)} finding(s)")
        findings += fs
    return findings


def _verify_parallel(label: str, tg, strategy) -> list:
    """One dp/tp/pp configuration: plan symmetry + per-stage verification."""
    cluster = edge_cluster(strategy.chips)
    engine = get_engine(cluster.chip)
    pres = evaluate_parallel(tg, cluster, strategy, fusion="manual",
                             engine=engine)
    findings = list(pres.findings)
    plan = parallelize(tg, strategy, cluster)
    findings += verify_parallel(tg, plan)
    for i, sg in enumerate(plan.stage_graphs):
        part, quotient = fusion_partition(sg, cluster.chip, "manual", None,
                                          engine)
        res = schedule(sg, cluster.chip, part, engine=engine,
                       quotient=quotient)
        fs = verify_result(sg, cluster.chip,
                           part or [(n,) for n in sg.topo_order()],
                           res, engine=engine, strict=False)
        print(f"  {label} {strategy.label} stage {i}: {len(fs)} finding(s)")
        findings += fs
    return findings


def _verify_degrade(label: str, tg, strategy, failed: int = 1) -> list:
    """Survivor-set remap: C009 coherence + warm-path (zero fresh signings)
    assertion on re-scheduling the degraded stage graphs."""
    cluster = edge_cluster(strategy.chips)
    engine = get_engine(cluster.chip)
    d = degrade(tg, cluster, strategy, failed, engine=engine)
    findings = list(d.findings)
    # the degrade rewrite must stay on the engine's warm path: its stage
    # graphs are fully signed, so re-scheduling them is pure cache traffic
    before = sign_count()
    for sg in d.plan.stage_graphs:
        part, quotient = fusion_partition(sg, cluster.chip, "manual", None,
                                          engine)
        schedule(sg, cluster.chip, part, engine=engine, quotient=quotient)
    fresh = sign_count() - before
    if fresh:
        findings.append(Finding(
            "C009", "error", d.strategy.label,
            f"degraded reschedule left the warm path: {fresh} fresh "
            f"signings (expected 0)"))
    print(f"  {label} degrade {strategy.label} -{failed} chip -> "
          f"{d.strategy.label}: {len(findings)} finding(s), "
          f"{fresh} fresh signings")
    return findings


def _verify_serving(label: str, hda, engine, tiny: dict) -> list:
    """Inference-serving leg: M-series conservation (incl. M025 KV rules)
    on prefill and decode graphs, resident and paged, plus the scheduled
    decode step through verify_result."""
    findings = []
    graphs = {
        "prefill": gpt2_prefill_graph(batch=1, seq=64, **tiny),
        "decode": gpt2_decode_graph(batch=4, past=64, **tiny),
        "decode-paged": gpt2_decode_graph(batch=4, past=64, kv_paged=True,
                                          **tiny),
    }
    for name, g in graphs.items():
        res = schedule(g, hda, engine=engine)
        fs = verify_result(g, hda, result=res, engine=engine, strict=False)
        print(f"  {label} serve {name}: {len(fs)} finding(s)")
        findings += fs
    return findings


def main(argv: list | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.verify",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="small MLP only (fast smoke run)")
    ap.add_argument("--rules", action="store_true",
                    help="print the rule registry and exit")
    args = ap.parse_args(argv)

    if args.rules:
        for code, desc in sorted(RULES.items()):
            print(f"{code}  {desc}")
        return 0

    hda = edge_tpu()
    engine = get_engine(hda)
    if args.quick:
        workloads = {"mlp": build_training_graph(mlp_graph(batch=8,
                                                           widths=(32, 32)),
                                                 "adam")}
    else:
        workloads = {
            "resnet18": build_training_graph(resnet18_graph(1, 32), "adam"),
            "gpt2-small": build_training_graph(
                gpt2_graph(batch=1, seq=64, d_model=128, n_layers=2,
                           n_heads=4, vocab=512), "adam"),
        }

    findings = []
    for name, tg in workloads.items():
        findings += _verify_policies(name, tg, hda, engine)
        findings += _verify_parallel(name, tg,
                                     ParallelStrategy(2, 2, 2, microbatches=4))
        findings += _verify_degrade(name, tg,
                                    ParallelStrategy(2, 2, 2, microbatches=4))
    findings += _verify_serving(
        "gpt2-tiny", hda, engine,
        dict(d_model=128, n_layers=2, n_heads=4, vocab=512))

    if findings:
        print(f"\n{len(findings)} finding(s):")
        for f in findings:
            print(f"  {f}")
        return 1
    print("\nall clean: 0 findings")
    return 0


if __name__ == "__main__":
    sys.exit(main())
