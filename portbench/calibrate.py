"""The readings that the comparison's limits are set from, on the card.

    python3 portbench/calibrate.py --workloads A,B --seeds 1,2,... \\
        --control-seeds 1,2,3 --out chiprun_out/calibrate.json

For each seed: the program's readings of each workload (its first
``check_steps`` steps, as a run's set-up takes them) and the fp32
reference's, once for the workloads (they must share a configuration and a
job apart from the remat policy, which the reference does not have), and
each workload's numbers.  For each control seed besides: the control (the
reference with its weight products in fp8, ``reference/common.py``), the same
in bf16 (a witness of what the configuration's own precision does) and the
reference given half of each batch (a planted fault: half of the batch left
out, the mean over the rest), each held against the fp32 reference.  A step
that returns its state unchanged reads 1 on ``update_gap`` by construction
and needs no run.  Writes one JSON file and prints a line a reading.

Witnesses of where a reading comes from take the cells changed:
``--set n_layers=8`` (a key of the configuration's model, the value in
JSON; repeatable), ``--init published`` (Mamba-2's published draws of
``A_log`` and ``dt_bias`` in place of the system's zeros), and
``--controls bf16`` (only those of the controls).
"""

import argparse
import dataclasses
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def leaf_errors(got: dict, ref: dict) -> dict:
    """Each leaf's ‖g − g_ref‖ / ‖g_ref‖ of the first gradient, on the
    sampled entries."""
    import torch

    return {k: float(torch.linalg.vector_norm(got["grad_samples"][k] - r)
                     / torch.linalg.vector_norm(r).clamp_min(1e-30))
            for k, r in ref["grad_samples"].items()}


def plain(readings: dict) -> dict:
    """The readings without their sampled entries (kept out of the file)."""
    return {k: v for k, v in readings.items() if not k.endswith("_samples")}


#: ``--init published``: the leaves drawn otherwise, by the last part of their path
PUBLISHED = {"A_log": "a_log", "dt_bias": "dt_bias"}


class Family:
    """A family's reference whose leaves named in ``init`` are drawn by
    another kind (``harness.make_leaf``)."""

    def __init__(self, mod, init: dict):
        self.mod, self.init = mod, init

    def __getattr__(self, name):
        return getattr(self.mod, name)

    def leaves(self, model):
        return {p: (s[0], s[1], self.init.get(p.rsplit("/", 1)[-1], s[2]), s[3])
                for p, s in self.mod.leaves(model).items()}


def witness(cell, sets: dict, init: dict):
    """``cell`` with its model's keys ``sets`` changed and the leaves
    ``init`` drawn otherwise."""
    from portbench import harness

    @dataclasses.dataclass
    class Witness(harness.Cell):
        def family(self):
            return Family(super().family(), init)

    fields = {f.name: getattr(cell, f.name) for f in dataclasses.fields(cell)}
    fields["config"] = dict(cell.config, model=dict(cell.model, **sets))
    return Witness(**fields)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workloads", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", required=True)
    ap.add_argument("--set", action="append", default=[], metavar="KEY=JSON")
    ap.add_argument("--init", choices=("system", "published"), default="system")
    ap.add_argument("--controls", default="fp8,bf16,half_batch")
    args = ap.parse_args(argv)
    sys.path[:1] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from portbench import check, harness

    sets = {k: json.loads(v) for k, v in (kv.split("=", 1) for kv in args.set)}
    init = PUBLISHED if args.init == "published" else {}
    cells = [harness.resolve(w, ROOT) for w in args.workloads.split(",")]
    if sets or init:
        cells = [witness(c, sets, init) for c in cells]
    device = "cuda" if torch.cuda.is_available() else "cpu"
    out = {"device": torch.cuda.get_device_name() if device == "cuda" else "cpu",
           "power_limit": harness.power_limit() if device == "cuda" else "cpu",
           "set": sets, "init": args.init, "seeds": {}, "controls": {}}
    control = {int(s) for s in args.control_seeds.split(",") if s}
    sizes = harness.leaf_sizes(cells[0])

    def emit(tag, **kw):
        print(json.dumps({"tag": tag, **kw}), flush=True)

    def free():
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()

    for seed in [int(s) for s in args.seeds.split(",")]:
        row = {}
        for cell in cells:
            t0 = time.perf_counter()
            prog = harness.Program(cell, seed, device)
            row[cell.name] = prog.readings()
            del prog
            free()
            emit("program", workload=cell.name, seed=seed, s=time.perf_counter() - t0)
        t0 = time.perf_counter()
        ref = harness.reference_readings(cells[0], seed, device)
        emit("reference", seed=seed, s=time.perf_counter() - t0)
        free()
        out["seeds"][seed] = {"reference": plain(ref)}
        for cell in cells:
            nums, at = check.gaps(row[cell.name], ref, sizes)
            out["seeds"][seed][cell.name] = {"readings": plain(row[cell.name]), "gaps": nums,
                                              "at": at, "leaf": leaf_errors(row[cell.name], ref)}
            emit("gaps", workload=cell.name, seed=seed, **nums, at=at)
        if seed in control:
            half = slice(0, cells[0].job["batch"] // 2)
            for tag, kw in (("fp8", {"prec": "fp8"}), ("bf16", {"prec": "bf16"}),
                            ("half_batch", {"rows": half})):
                if tag not in args.controls.split(","):
                    continue
                t0 = time.perf_counter()
                got = harness.reference_readings(cells[0], seed, device, **kw)
                free()
                nums, at = check.gaps(got, ref, sizes)
                out["controls"].setdefault(tag, {})[seed] = {"gaps": nums, "at": at,
                                                             "leaf": leaf_errors(got, ref)}
                emit(tag, seed=seed, **nums, at=at, s=time.perf_counter() - t0)
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
