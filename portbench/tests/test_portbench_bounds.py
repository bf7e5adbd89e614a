"""The frozen bound formulas against PERF.md's bound column, and the calls a
step that the kernels' roofline counts: the operation's work, one forward and
one backward a layer whatever the remat policy.  (The port's smoke script
derives the launches a step, in which a remat policy runs each forward
kernel twice: rmsnorm 193 = 2 · 96 + 1, ssd_chunk 96, flash_fwd 16.)"""

import pytest
from conftest import ROOT

from portbench import harness
from portbench import roofline as rf
from portbench.kernels import flash_fwd, rmsnorm, ssd_chunk, ssd_chunk_bwd

OLMOE = (4, 4096, 4096, 16, 16, 128)      # B, S, T, H, Kv, hd
SSD = (4, 16, 256, 64, 64, 1, 128)        # B, nc, Q, H, hp, G, N


@pytest.mark.parametrize("kind,want", [("fwd", 0.2780), ("dq", 0.4170), ("dkv", 0.5560)])
def test_flash_at_olmoe(kind, want):
    kw = {"fwd": {}, "dq": dict(products=3, q_like=3, kv_like=2, row_vecs=2),
          "dkv": dict(products=4, q_like=2, kv_like=4, row_vecs=2)}[kind]
    f, b = flash_fwd.bound(*OLMOE, True, None, 2, **kw)
    assert rf.bound_ms(f, b, rf.PEAK_BF16) == pytest.approx(want, abs=5e-5)


@pytest.mark.parametrize("mod,want", [(ssd_chunk, 0.1252), (ssd_chunk_bwd, 0.1690)])
def test_ssd(mod, want):
    f, b = mod.bound(*SSD, 2)
    assert rf.bound_ms(f, b, rf.PEAK_BF16) == pytest.approx(want, abs=5e-5)


def test_rmsnorm():
    assert rf.bound_ms(*rmsnorm.bound(16384, 2048, 2), rf.PEAK_FP32) == pytest.approx(
        0.0401, abs=5e-5)


@pytest.mark.parametrize("workload,calls", [
    ("mamba2-1.3b.train-b4s4096", {"rmsnorm": 97, "rmsnorm_bwd": 97, "ssd_chunk": 48,
                                   "ssd_chunk_bwd": 48, "fused_adam": 1}),
    ("mamba2-1.3b.train-b4s4096.full", {"rmsnorm": 97, "rmsnorm_bwd": 97, "ssd_chunk": 48,
                                        "ssd_chunk_bwd": 48, "fused_adam": 1}),
    ("olmoe-1b-7b.l8.train-b4s4096", {"rmsnorm": 17, "rmsnorm_bwd": 17, "flash_fwd": 8,
                                      "flash_dq": 8, "flash_dkv": 8, "fused_adam": 1})])
def test_calls_a_step(workload, calls):
    cell = harness.resolve(workload, ROOT)
    got = {op: sum(n for n, *_ in mod.work(cell.model, cell.job, cell.family()))
           for op, mod in cell.ops().items()}
    assert {k: v for k, v in got.items() if v} == calls
