"""The port's copy of MONET's fault-injection campaign
(``repro_torch.core.faultinject``) held against ``repro.core``.

Each test of ``tests/test_faultinject.py`` has a counterpart here that runs
the port's function, asserts the same property and, on the same seed, that
every ``InjectionReport`` equals the reference's (the corrupted subject
included), and that ``python -m repro_torch.core.faultinject`` prints what
the reference's prints.

Traps held here: ``_pick`` sorts before it draws, so a copy that drew from
dict order would hit other subjects (the reports name them); the campaign
builds its context through the port's private ``_build_training_graph``
and ``_build_mlp``, not the reference's."""

import importlib

import pytest
from test_torch_core import canonical
from test_torch_parallel import same

import repro.core as ref
import repro_torch.core as core
from repro_torch.core.verify import ERROR, verify_cache, verify_graph, verify_schedule

faultinject = importlib.import_module("repro_torch.core.faultinject")
ref_faultinject = importlib.import_module("repro.core.faultinject")


def test_baseline_context_is_clean():
    ctx = faultinject._Context()
    findings = (verify_graph(ctx.graph) + verify_cache(ctx.graph)
                + verify_schedule(ctx.graph, ctx.hda, ctx.partition, ctx.result))
    assert [f for f in findings if f.severity == ERROR] == []
    want = ref_faultinject._Context()
    assert canonical(ctx.graph) == canonical(want.graph)
    same((ctx.hda, ctx.partition, ctx.result), (want.hda, want.partition, want.result))
    assert faultinject._build_mlp.__module__ == "repro_torch.core.zoo"
    assert faultinject._build_training_graph.__module__ == "repro_torch.core.training_transform"


@pytest.mark.parametrize("name", [s.name for s in ref.FAULTS])
def test_every_injected_fault_is_caught(name):
    r = core.inject(name, seed=0)
    assert r.caught, f"{name}: expected one of {r.expected}, fired {r.fired or '(nothing)'}"
    assert r.subject
    same(r, ref.inject(name, seed=0))


def test_fault_registry_covers_all_targets():
    assert {s.target for s in core.FAULTS} == {"graph", "cache", "schedule"}
    assert len({s.name for s in core.FAULTS}) == len(core.FAULTS) == 21
    same(core.FAULTS, ref.FAULTS)


def test_campaign_is_deterministic_per_seed():
    a = core.run_campaign(seed=7)
    b = core.run_campaign(seed=7)
    assert [(r.fault, r.subject, r.caught, r.fired) for r in a] == \
        [(r.fault, r.subject, r.caught, r.fired) for r in b]
    assert all(r.caught for r in a)
    same(a, ref.run_campaign(seed=7))


def test_campaign_catches_under_other_seeds():
    got = core.run_campaign(seed=3)
    assert all(r.caught for r in got)
    same(got, ref.run_campaign(seed=3))


def test_pick_sorts_before_it_draws():
    import numpy as np
    items = {"b": 0, "a": 1, "c": 2}
    for seed in range(4):
        assert faultinject._pick(np.random.default_rng(seed), items) == \
            ref_faultinject._pick(np.random.default_rng(seed), sorted(items, reverse=True))


@pytest.mark.parametrize("seed", [0, 5])
def test_cli_campaign_green(capsys, seed):
    assert faultinject.main(["--seed", str(seed)]) == 0
    out = capsys.readouterr().out
    assert "MISSED" not in out
    assert f"{len(core.FAULTS)}/{len(core.FAULTS)}" in out
    assert ref_faultinject.main(["--seed", str(seed)]) == 0
    assert out == capsys.readouterr().out
