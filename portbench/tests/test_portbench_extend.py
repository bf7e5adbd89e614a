"""A later change adds a configuration, a job mix, a per-layer metric, a
mixer's FLOP term and a kernel's bound as new files and new entries in
BENCHMARK.json, and edits no file that is there: here a dummy of each under
a temporary root, found by its name."""

import filecmp
import json
import shutil

from conftest import ROOT

from portbench import harness, modelflops


def test_dummies_are_found_by_name(tmp_path):
    base = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench", base, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())

    # a configuration: the mamba2 file under a new name, with a mixer "dummy"
    config = json.loads((base / "configs" / "mamba2-1.3b.json").read_text())
    config["model"]["pattern"] = ["mamba", "dummy"]
    (base / "configs" / "dummy-1b.json").write_text(json.dumps(config))
    bench["configs"].append({"name": "dummy-1b", "source": "https://example.org/dummy",
                             "file": "portbench/configs/dummy-1b.json", "reduced": [],
                             "why": "a dummy"})
    # a job mix
    job = json.loads((base / "traffic" / "train-b4s4096.json").read_text())
    (base / "traffic" / "train-b2s8192.json").write_text(json.dumps(dict(job, batch=2, seq=8192)))
    bench["workloads"].append({"name": "dummy-1b.train-b2s8192", "config": "dummy-1b",
                               "traffic": "train-b2s8192", "chips": 1, "why": "a dummy"})
    (base / "limits" / "dummy-1b.train-b2s8192.json").write_text(
        json.dumps({"limits": {"grad_gap": 1}}))
    # a mixer's FLOP term, a kernel's bound, a per-layer metric
    (base / "flops" / "dummy.py").write_text("def flops(model, B, S):\n    return 1e12\n")
    (base / "kernels" / "dummy_op.py").write_text(
        "PATTERNS = ('dm::dummy',)\n\ndef work(model, job, family):\n"
        "    return [(3, 2e12, 1e9, 989e12)]\n")
    (base / "metrics" / "dummy.count.py").write_text(
        "def read(ctx):\n    return 42.0 if ctx.trace is None else None\n")
    bench["per_layer"].append({"name": "dummy.count", "unit": "count", "better": "lower",
                               "source": "program_counter", "layer": "model",
                               "moves": "train_tokens_per_s",
                               "workloads": ["dummy-1b.train-b2s8192"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.resolve("dummy-1b.train-b2s8192", tmp_path)
    assert cell.job["seq"] == 8192 and cell.model["pattern"] == ["mamba", "dummy"]
    assert set(cell.metrics) == {"dummy.count"}
    assert cell.reader("dummy.count").read(harness.Context(cell, "cpu", {}, None)) == 42.0
    m, B, S = cell.model, 2, 8192
    half = m["n_layers"] // 2
    want = (6 * modelflops.matmul_params(m, cell.family()) * B * S
            + half * cell.mixer("mamba").flops(m, B, S) + half * 1e12)
    assert cell.step_flops() == want
    assert "dummy_op" in cell.ops()
    bounds = harness.Context(cell, "cpu", {}, None).kernel_bounds()
    assert abs(bounds["dummy_op"] - 3 * 2e12 / 989e12 * 1e3) < 1e-9
    # the files that were there are unchanged
    for src in (ROOT / "portbench").rglob("*"):
        rel = src.relative_to(ROOT / "portbench")
        if src.is_file() and rel.parts[0] != "tests" and "__pycache__" not in rel.parts:
            assert filecmp.cmp(src, base / rel, shallow=False), rel
