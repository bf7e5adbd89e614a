"""BENCHMARK.json against the contract's shape, and every cell resolving to
its files: configuration, job mix, limits, reference, FLOP terms, readers."""

import json
import re

import pytest
from conftest import CELLS, ROOT

from portbench import check, harness

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert [w["name"] for w in BENCH["workloads"]] == list(CELLS)
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert {"train_tokens_per_s", "peak_mem_gb", "setup_s"} == set(e2e)
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["moves"] == "train_tokens_per_s" for m in BENCH["per_layer"])
    assert len(BENCH["per_layer"]) == 7
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("workload", CELLS)
def test_workload_resolves(workload):
    cell = harness.resolve(workload, ROOT)
    assert cell.chips == 1
    assert cell.limits and set(cell.limits) <= set(check.NUMBERS)
    assert cell.job["kind"] == "train" and cell.job["batch"] * cell.job["seq"] == 16384
    cell.family()
    for name in cell.metrics:
        assert callable(cell.reader(name).read)
    for mixer in set(cell.model["pattern"]):
        assert cell.step_flops() > 0 and callable(cell.mixer(mixer).flops)
    assert set(cell.ops()) == {"flash_fwd", "flash_dq", "flash_dkv", "rmsnorm",
                               "rmsnorm_bwd", "fused_adam", "ssd_chunk", "ssd_chunk_bwd"}


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_is_the_ports_but_for_reduced(config):
    """The file states the port's registry config, changed only in the keys
    ``reduced`` names; the port builds it; the reference's leaves are its tree."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import abstract_params

    data = json.loads((ROOT / config["file"]).read_text())
    assert data["source"] == config["source"] and data["reduced"] == config["reduced"]
    base = dataclasses.asdict(get_config(data["arch"]))
    changed = {k for k, v in data["model"].items()
               if (list(base[k]) if k == "pattern" else base[k]) != v}
    assert changed <= set(config["reduced"]) | {"use_flash"}
    # every model key whose published value the file records is named in reduced
    assert set(data.get("published", {})) & set(data["model"]) <= set(config["reduced"])
    cell = harness.Cell("x", data, {"remat": "dots"}, {}, {}, 1)
    cfg = harness.port_config(cell)
    assert cfg.param_count() == data["parameters"]
    got = {p: tuple(t.shape) for p, t in harness.flat(abstract_params(cfg)).items()}
    want = {p: tuple(s[0]) for p, s in cell.family().leaves(data["model"]).items()}
    assert got == want


def test_no_result_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's folder: the
    command exits non-zero and prints no result (here for want of a card or,
    on a card, of the port)."""
    import shutil
    import subprocess
    import sys

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0],
                          "--seed", "7", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
