"""Shared pieces of the benchmark's tests: the ``card`` marker, the fixture
that decides whether a card is there, and small cells for the CPU.

Run them with ``python -m pytest portbench/tests`` from the repository's
root; the tests marked ``card`` run on an H100 and skip elsewhere."""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

CELLS = ("mamba2-1.3b.train-b4s4096", "olmoe-1b-7b.l8.train-b4s4096",
         "mamba2-1.3b.train-b4s4096.full")


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (an H100); skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda")


def tiny_cell(workload: str, **job):
    """The cell ``workload`` cut to a CPU's size: 2 layers of width 64, a
    vocabulary of 256, 2 × 128 tokens a step.  bf16 as the cell (the port's
    products are bf16 whatever the configuration says)."""
    from portbench import harness

    cell = copy.deepcopy(harness.resolve(workload, ROOT))
    m = cell.config["model"]
    m.update(n_layers=2, d_model=64, vocab=256)
    if m["family"] == "ssm":
        m["ssm"] = dict(m["ssm"], d_state=16, headdim=8, chunk=32)
    else:
        m.update(n_heads=4, n_kv_heads=4, head_dim=16)
        m["moe"] = dict(m["moe"], n_experts=4, top_k=2, d_ff_expert=32)
    cell.job.update({"batch": 2, "seq": 128, **job})
    return cell
