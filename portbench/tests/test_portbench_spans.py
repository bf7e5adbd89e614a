"""The readers of the metrics named after the port's spans
(``metrics/<metric>.py`` through ``spanrecords.py``), each on a hand-made
list of step records in the form ``repro_torch.core.spans.steps()`` gives:
the last ``PROFILE_STEPS`` records only, the phases summed, ``None`` where a
cell has no such span or counter, off the card, and for a program without
spans; and the new entries of ``BENCHMARK.json``."""

import json
import sys

import pytest
from conftest import CELLS, ROOT

from portbench import harness

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
#: the metrics this reader family adds, by the name of their file
SPAN_METRICS = ("ssm.conv_ms", "ssm.scan_ms", "ssm.gate_ms", "moe.dispatch_ms",
                "moe.combine_ms", "kernels.span_ms", "step.forward_host_ms",
                "step.backward_host_ms", "remat.recompute_host_ms", "remat.policy_ops")


def stats(stream, host=None, top=False, count=1):
    host = stream if host is None else host
    return {"count": count, "host_ms": host, "stream_ms": stream,
            "top_host_ms": host if top else 0.0, "top_stream_ms": stream if top else 0.0}


def mamba_record(k: float, policy_ops=None):
    """A mamba2 step whose every time is scaled by ``k``."""
    def stage(f, r, b):
        return {"fwd": stats(f * k, top=True), "rec": stats(r * k, top=True),
                "bwd": stats(b * k, top=True)}
    return {"spans": {
        "step": {"fwd": stats(100 * k)}, "step.forward": {"fwd": stats(20 * k, 25 * k)},
        "step.backward": {"fwd": stats(70 * k, 75 * k)},
        "ssm.conv": stage(1, 2, 3), "ssm.scan": stage(4, 5, 6), "ssm.gate": stage(7, 8, 9),
        "norm": {"fwd": stats(0.5 * k, top=True), "bwd": stats(0.5 * k, top=True)},
        "kernel.ssd_chunk": {"fwd": stats(10 * k), "rec": stats(10 * k)},
        "kernel.ssd_chunk_bwd": {"bwd": stats(30 * k)},
        "gc.gen0": {"rec": {**stats(None, 2 * k)}}},
        "policy_ops": policy_ops, "launches": 5, "intervals": []}


def moe_record(k: float):
    return {"spans": {
        "step.forward": {"fwd": stats(10 * k, 12 * k)},
        "step.backward": {"fwd": stats(20 * k, 22 * k)},
        "moe.route": {"fwd": stats(1 * k, top=True), "bwd": stats(2 * k, top=True)},
        "moe.dispatch": {"fwd": stats(3 * k, top=True), "bwd": stats(4 * k, top=True)},
        "moe.combine": {"fwd": stats(5 * k, top=True), "bwd": stats(6 * k, top=True)},
        "kernel.flash_fwd": {"fwd": stats(7 * k)}},
        "policy_ops": None, "launches": 3, "intervals": []}


def read(monkeypatch, metric, records, device_type="cuda"):
    from repro_torch.core import spans

    monkeypatch.setattr(spans, "steps", lambda: list(records))
    cell = harness.resolve(CELLS[0], ROOT)
    ctx = harness.Context(cell, device_type, {"steps": 0, "seconds": 0.0, "issue_s": []}, None)
    return cell.reader(metric).read(ctx)


#: (metric, its reading of ``mamba_record(1)``): the phases summed
MAMBA = {"ssm.conv_ms": 6.0, "ssm.scan_ms": 15.0, "ssm.gate_ms": 24.0,
         "kernels.span_ms": 50.0, "step.forward_host_ms": 25.0,
         "step.backward_host_ms": 75.0, "remat.recompute_host_ms": 15.0}


@pytest.mark.parametrize("metric", sorted(MAMBA))
def test_last_steps_and_phases_summed(monkeypatch, metric):
    """A warm-up record with other times comes first; the two recorded steps
    read 1× and 3×, so the mean a step is 2× ``mamba_record(1)``'s."""
    recs = [mamba_record(1000.0), mamba_record(1.0), mamba_record(3.0)]
    assert harness.PROFILE_STEPS == 2
    assert read(monkeypatch, metric, recs) == pytest.approx(2 * MAMBA[metric])


def test_moe_readers(monkeypatch):
    recs = [moe_record(50.0), moe_record(1.0), moe_record(1.0)]
    assert read(monkeypatch, "moe.dispatch_ms", recs) == pytest.approx(10.0)
    assert read(monkeypatch, "moe.combine_ms", recs) == pytest.approx(11.0)
    assert read(monkeypatch, "kernels.span_ms", recs) == pytest.approx(7.0)


def test_policy_ops(monkeypatch):
    recs = [mamba_record(1, 1), mamba_record(1, 900), mamba_record(1, 1100)]
    assert read(monkeypatch, "remat.policy_ops", recs) == pytest.approx(1000.0)


@pytest.mark.parametrize("metric", ["ssm.conv_ms", "ssm.scan_ms", "ssm.gate_ms",
                                    "remat.policy_ops", "remat.recompute_host_ms"])
def test_none_where_the_cell_has_none(monkeypatch, metric):
    """ssm.* on olmoe's records; no SAC policy (``remat="full"``, or none);
    no recompute (``remat="none"``)."""
    assert read(monkeypatch, metric, [moe_record(1.0)] * 3) is None


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_none_off_the_card_and_without_spans(monkeypatch, metric):
    recs = [mamba_record(1.0, 7)] * 3
    assert read(monkeypatch, metric, recs, device_type="cpu") is None
    import repro_torch.core

    monkeypatch.delattr(repro_torch.core, "spans")
    monkeypatch.setitem(sys.modules, "repro_torch.core.spans", None)   # ImportError
    cell = harness.resolve(CELLS[0], ROOT)
    ctx = harness.Context(cell, "cuda", {"steps": 0, "seconds": 0.0, "issue_s": []}, None)
    assert cell.reader(metric).read(ctx) is None


def test_stream_ms_missing_reads_none(monkeypatch):
    recs = [mamba_record(1.0)] * 3
    recs[-1]["spans"]["ssm.conv"]["bwd"]["stream_ms"] = None
    assert read(monkeypatch, "ssm.conv_ms", recs) is None


def test_entries_name_accepted_cells():
    """Every new entry: a reader file, an existing layer or ``remat policy``,
    ``train_tokens_per_s`` moved, and cells that report it."""
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    reporting = set(e2e["train_tokens_per_s"]["workloads"])
    layers = {m["layer"] for m in BENCH["per_layer"] if m["name"] not in SPAN_METRICS}
    assert list(entries)[-len(SPAN_METRICS):] == list(SPAN_METRICS)
    for name in SPAN_METRICS:
        m = entries[name]
        assert (ROOT / "portbench" / "metrics" / f"{name}.py").is_file()
        assert m["moves"] == "train_tokens_per_s" and m["better"] == "lower"
        assert m["source"] in ("program_span", "program_counter")
        assert m["layer"] in layers | {"remat policy"}
        assert m["workloads"] and set(m["workloads"]) <= reporting <= set(CELLS)
    assert set(entries["ssm.conv_ms"]["workloads"]) == {CELLS[0], CELLS[2]}
    assert entries["moe.dispatch_ms"]["workloads"] == [CELLS[1]]
    assert entries["remat.policy_ops"]["workloads"] == [CELLS[0], CELLS[1]]
