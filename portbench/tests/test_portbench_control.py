"""The control of the comparison: the reference with its weight products in
fp8 (one step below the configuration's bf16), put in the program's place,
must come out as not correct against the fp32 reference.  On the card at
the cells' own size, on three seeds (``portbench/calibrate.py``; the
readings in PERF.md); here, at a small size on the CPU, that it is a step
below bf16."""

import subprocess
import sys

import pytest
from conftest import CELLS, ROOT, tiny_cell

from portbench import check, harness


@pytest.mark.parametrize("seed", [11, 2**31 + 5, 4_000_000_007])
@pytest.mark.parametrize("workload", ["mamba2-1.3b.train-b4s4096",
                                      "olmoe-1b-7b.l8.train-b4s4096"])
def test_fp8_control_is_a_step_below(workload, seed):
    """The control's gradient errs three times or more what bf16 products do
    (the witness), at a size where the cells' limits do not apply."""
    cell = tiny_cell(workload, batch=4, seq=256)
    sizes = harness.leaf_sizes(cell)
    ref = harness.reference_readings(cell, seed, "cpu")
    control, _ = check.gaps(harness.reference_readings(cell, seed, "cpu", prec="fp8"), ref, sizes)
    witness, _ = check.gaps(harness.reference_readings(cell, seed, "cpu", prec="bf16"), ref, sizes)
    assert control["grad_err"] >= 3 * witness["grad_err"], (control, witness)


@pytest.mark.card
@pytest.mark.parametrize("group", [CELLS[0] + "," + CELLS[2], CELLS[1]])
def test_control_at_the_cells_size(card, tmp_path, group):
    out = tmp_path / "calibrate.json"
    subprocess.run([sys.executable, str(ROOT / "portbench" / "calibrate.py"),
                    "--workloads", group, "--seeds", "101,102,103",
                    "--control-seeds", "101,102,103", "--out", str(out)], check=True,
                   timeout=3000)
    import json

    data = json.loads(out.read_text())
    for seed, row in data["seeds"].items():
        for w in group.split(","):
            assert check.passes(row[w]["gaps"], harness.resolve(w, ROOT).limits), (w, seed)
    for tag in ("fp8", "half_batch"):   # each fails one number at least
        for seed, row in data["controls"][tag].items():
            for w in group.split(","):
                assert not check.passes(row["gaps"], harness.resolve(w, ROOT).limits), (tag, seed)


def test_witness_with_the_published_init():
    """``calibrate.py``'s witness cells: a key of the model changed and
    Mamba-2's published draws of A and dt (A in [1, 16], dt in [1e-3, 0.1]),
    the same leaves on the program's side and the reference's, which agree
    at a tiny size as the cells do (``test_portbench_run.TINY``)."""
    import torch.nn.functional as F
    from test_portbench_run import TINY

    from portbench import calibrate

    cell = calibrate.witness(tiny_cell(CELLS[0]), {"n_layers": 3}, calibrate.PUBLISHED)
    leaves = cell.family().leaves(cell.model)
    assert cell.model["n_layers"] == 3 and leaves["scan/0/mixer/A_log"][0] == (3, 16)
    A = harness.make_leaf(leaves["scan/0/mixer/A_log"], 5, 0, "cpu").exp()
    dt = F.softplus(harness.make_leaf(leaves["scan/0/mixer/dt_bias"], 5, 1, "cpu"))
    assert 1 <= float(A.min()) and float(A.max()) <= 16
    assert 1e-4 <= float(dt.min()) and float(dt.max()) <= 0.1 * (1 + 1e-5)
    seed = 2**31 + 41
    got = harness.Program(cell, seed, "cpu").readings()
    nums, _ = check.gaps(got, harness.reference_readings(cell, seed, "cpu"),
                         harness.leaf_sizes(cell))
    assert all(nums[k] <= lim for k, lim in TINY.items()), nums
