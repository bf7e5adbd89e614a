"""Serving front-end: price one continuous-batching deployment cell.

Thin CLI over :mod:`repro.core.serving` (see docs/serving.md).  Picks a
cluster site, slot count, and KV residency policy, evaluates the
steady-state continuous-batching model for the small-GPT-2 workload, and
prints the throughput / tail-latency / memory / power report for that one
cell.  For full sweeps and Pareto fronts use ``examples/serve_lm.py`` or
:func:`repro.core.dse.sweep_serve`.

    PYTHONPATH=src python -m repro_torch.launch.serve --site edge --chips 4 \
        --slots 16 --policy offload

The port's own copy of ``repro.launch.serve``: the same flags, the same
report and the same exit codes, over the port's ``core.serving``; held
against the reference's output by ``tests/test_torch_cli.py``.
"""

from __future__ import annotations

import argparse

from ..core.accelerators import datacenter_cluster, edge_cluster
from ..core.memory import ActivationPolicy
from ..core.serving import DEFAULT_MIX, evaluate_serve, max_keep_slots

_SITES = {"edge": edge_cluster, "datacenter": datacenter_cluster}
_POLICIES = {p.name.lower(): p for p in ActivationPolicy}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--site", choices=sorted(_SITES), default="edge")
    ap.add_argument("--chips", type=int, default=4)
    ap.add_argument("--slots", type=int, default=16)
    ap.add_argument("--policy", choices=sorted(_POLICIES), default="keep")
    args = ap.parse_args(argv)

    cluster = _SITES[args.site](n_chips=args.chips)
    try:
        res = evaluate_serve(cluster, slots=args.slots,
                             policy=_POLICIES[args.policy])
    except ValueError as e:          # e.g. tp degree not dividing n_heads
        ap.error(str(e))

    print(f"{args.site} x{args.chips} ({cluster.chip.name}), "
          f"{args.slots} slots, policy={args.policy}")
    print(f"  throughput : {res.rps:10.2f} req/s   "
          f"{res.tokens_per_s:10.1f} tok/s")
    print(f"  latency    : p50 {res.p50_ms:10.1f} ms   "
          f"p99 {res.p99_ms:10.1f} ms   step {res.step_us:.1f} us")
    print(f"  memory     : peak {res.peak_mem / 2**20:8.1f} MB of "
          f"{res.mem_capacity / 2**20:.1f} MB/chip   "
          f"kv {res.kv_bytes / 2**20:.1f} MB"
          f"{'' if res.feasible else '   (OVER CAPACITY)'}")
    print(f"  power      : {res.watts:8.2f} W   "
          f"{res.tokens_per_joule:.1f} tok/J")
    for name, d in sorted(res.per_class.items()):
        print(f"  class {name:10s}: ctx {d['ctx']:5d}  "
              f"prefill {d['prefill_ms']:8.1f} ms  "
              f"step {d['step_us']:8.1f} us  e2e {d['e2e_ms']:10.1f} ms")
    ctx = int(DEFAULT_MIX.mean(lambda c: c.steady_ctx))
    print(f"  planning   : max KEEP slots at mean ctx {ctx} = "
          f"{max_keep_slots(cluster, ctx)}")
    return 0 if res.feasible else 1


if __name__ == "__main__":
    raise SystemExit(main())
