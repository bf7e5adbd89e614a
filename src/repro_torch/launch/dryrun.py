"""Multi-pod dry-run: every (arch × shape) cell on the production meshes,
without one device per rank.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b \\
        --shape train_4k --mesh both --out artifacts/dryrun_torch

Before any mesh exists it starts PyTorch's fake process group of 512 ranks
(``init_process_group("fake", store=FakeStore(), rank=0, world_size=512)``):
the single-pod mesh (16, 16) takes its first 256 ranks, the multi-pod mesh
(2, 16, 16) all of them.  This process is rank 0; every cell runs its step
once on DTensors whose local shards are ``meta`` tensors
(``launch/cell.py``), so nothing is computed or allocated and no device is
needed.  One JSON a cell; a cell that fails is recorded, counted, and makes
the exit status 1.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch.distributed as dist

from ..configs import all_cells, cell_status
from .cell import lower_cell
from .mesh import make_production_mesh

WORLD = 512


def start_fake_group(world: int = WORLD) -> None:
    """The fake process group of ``world`` ranks, this process rank 0."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def run_cell(arch: str, shape: str, multi_pod: bool, out_dir: str,
             variant: dict | None = None, tag: str = "") -> dict:
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    status = cell_status(arch, shape)
    key = f"{arch}__{shape}__{mesh_name}{tag}"
    if status != "run":
        row = dict(arch=arch, shape=shape, mesh=mesh_name, skipped=status)
        _write(out_dir, key, row)
        print(f"SKIP {key}: {status}")
        return row

    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    t0 = time.time()
    res, comm = lower_cell(arch, shape, mesh, variant)
    row = res.to_json()
    row["mesh"] = mesh_name
    row["wall_s"] = time.time() - t0
    row["variant"] = variant or {}
    _write(out_dir, key, row)
    if res.error:
        print(f"FAIL {key}: {res.error[:300]}")
    else:
        by_kind = {k: v for k, v in res.collective_bytes.items() if v}
        print(f"OK   {key}: flops/dev={res.flops:.4g} flops_global={res.flops_global:.4g} "
              f"collectives={res.n_collectives} bytes={by_kind} "
              f"args/dev={res.argument_bytes / 2**30:.3f}GiB wall={row['wall_s']:.1f}s")
    sys.stdout.flush()
    return row


def _write(out_dir: str, key: str, row: dict) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, key + ".json"), "w") as f:
        json.dump(row, f, indent=1)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description="multi-pod dry-run on a fake process group")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--variant", default="", help="JSON dict of perf-iteration knobs")
    ap.add_argument("--tag", default="", help="suffix for output files")
    args = ap.parse_args(argv)

    variant = json.loads(args.variant) if args.variant else None
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    cells = [(a, s) for a, s, _ in all_cells()
             if args.arch in ("all", a) and args.shape in ("all", s)]

    start_fake_group()
    failures = 0
    try:
        for arch, shape in cells:
            for mp in meshes:
                row = run_cell(arch, shape, mp, args.out, variant, args.tag)
                if row.get("error"):
                    failures += 1
    finally:
        dist.destroy_process_group()
    print(f"dry-run complete: {len(cells) * len(meshes)} cells, {failures} failures")
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
