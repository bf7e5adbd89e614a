"""A whole run on the CPU at a tiny size (the harness's look for a card
skipped): the reference agrees with the port's CPU path, the result line has
the contract's keys only, and the comparison fails when the timed path is
broken underneath (a step that returns its state unchanged; half of each
batch left out, the mean taken over the rest)."""

import json

import pytest
from conftest import tiny_cell

from portbench import check, harness

KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}
SEED = 2**31 + 977


def run(cell, trace=False, seed=SEED):
    return harness.run(cell, seed, 0.3, trace, "cpu")


#: what a two-layer bf16 model of width 64 may read against its fp32 reference
#: (the fp8 control reads grad_err 0.24-0.42 at this size): the cells' own
#: limits hold at their sizes, where other errors dominate (PERF.md)
TINY = {"grad_gap": 0.05, "update_gap": 0.05, "grad_err": 0.2}


@pytest.mark.parametrize("workload", ["mamba2-1.3b.train-b4s4096",
                                      "olmoe-1b-7b.l8.train-b4s4096"])
def test_reference_agrees_with_the_port(workload):
    cell = tiny_cell(workload)
    result, lines = run(cell)
    notes = json.loads(lines[0].removeprefix("portbench: "))
    for k, lim in TINY.items():
        assert result["checks"][k]["value"] <= lim, lines
    assert notes["not_compared"]["loss_gap"] < 1e-3
    assert result["attempted"] >= 1 and result["failed"] == 0


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(trace):
    result, lines = run(tiny_cell("mamba2-1.3b.train-b4s4096"), trace)
    assert set(result) == KEYS
    assert list(result)[-1] == "checks"
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert result["device"]["platform"] == "cpu"
    json.loads(json.dumps(result))
    want = {"train_tokens_per_s", "peak_mem_gb", "setup_s"}
    if trace:
        # on the CPU only the host-clock reader finds something to read
        assert set(result["metrics"]) == {"trainer.issue_ms"}
    else:
        assert set(result["metrics"]) == want
    cell = tiny_cell("mamba2-1.3b.train-b4s4096")
    assert [ln.split()[1] for ln in lines[1:]] == list(cell.limits)
    assert set(result["checks"]) == set(cell.limits) <= set(check.NUMBERS)


def test_state_left_unchanged_fails(monkeypatch):
    from repro_torch.kernels import ops

    monkeypatch.setattr(ops, "fused_adam_multi", lambda *a, **k: None)
    result, lines = run(tiny_cell("mamba2-1.3b.train-b4s4096"))
    assert not result["correct"], lines
    assert result["checks"]["update_gap"]["value"] == pytest.approx(1.0)
    assert result["checks"]["grad_err"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("workload", ["mamba2-1.3b.train-b4s4096",
                                      "olmoe-1b-7b.l8.train-b4s4096"])
def test_half_batch_fails(monkeypatch, workload):
    from repro_torch.training import train_step

    loss = train_step.lm_loss

    def half(params, cfg, inputs, labels, *a, **k):
        n = inputs.shape[0] // 2
        return loss(params, cfg, inputs[:n], labels[:n], *a, **k)

    monkeypatch.setattr(train_step, "lm_loss", half)
    result, lines = run(tiny_cell(workload))
    assert not result["correct"], lines


def test_update_applied_twice_fails(monkeypatch):
    """An answer altered where it is produced: each optimizer step applied twice."""
    from repro_torch.kernels import ops

    adam = ops.fused_adam_multi

    def twice(*a, **k):
        adam(*a, **k)
        adam(*a, **k)

    monkeypatch.setattr(ops, "fused_adam_multi", twice)
    result, lines = run(tiny_cell("olmoe-1b-7b.l8.train-b4s4096"))
    assert not result["correct"], lines


def test_trace_reads_the_profilers_events():
    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench.devtrace import Trace

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.relu(torch.randn(64, 64) @ torch.randn(64, 64)).sum()
    t = Trace.of(prof, 1, 0.01)
    assert any(name == "aten::mm" for name, _, _ in t.host)
    assert t.device == [] and t.idle_pct() is None and t.idle_gaps() == []
