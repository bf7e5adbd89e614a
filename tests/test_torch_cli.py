"""The port's two MONET command lines held against the reference's:
``python -m repro_torch.verify`` (the acceptance matrix, ``--quick``,
``--rules``) and ``python -m repro_torch.launch.serve`` on both sites and
every KV policy.  Each is run through ``main(argv)`` in this process beside
the reference's, and its standard output and exit code must be the
reference's byte for byte (``repro_torch.verify`` differs only in its
``prog``, which these outputs do not print)."""

import importlib

import pytest

import repro.core as ref
import repro_torch.core as core

VERIFY = ("repro_torch.verify", "repro.verify")
SERVE = ("repro_torch.launch.serve", "repro.launch.serve")


def run_both(capsys, modules, argv):
    """(exit code, stdout) of the port's ``main(argv)``, asserted equal to the
    reference's; both sides start from cold engines and rewrite caches, as
    the command line does in a fresh process."""
    out = []
    for name in modules:
        for m in (core, ref):
            m.clear_engines()
            m.parallel._REWRITES.clear()
        rc = importlib.import_module(name).main(list(argv))
        out.append((rc, capsys.readouterr().out))
    assert out[0] == out[1]
    return out[0]


@pytest.mark.parametrize("argv", [[], ["--quick"], ["--rules"]], ids=["full", "quick", "rules"])
def test_verify_cli_equals_reference(capsys, argv):
    rc, out = run_both(capsys, VERIFY, argv)
    assert rc == 0
    if argv == ["--rules"]:
        assert out.splitlines()[0].startswith("C001")
        assert len(out.splitlines()) == len(core.RULES)
    else:
        assert out.endswith("\nall clean: 0 findings\n")
        assert "degrade dp2+tp2+pp2@mb4 -1 chip -> " in out
        assert ("resnet18 " in out and "gpt2-small " in out) == (argv == [])
        assert "0 fresh signings" in out


def test_verify_cli_prog_is_the_ports(capsys):
    verify = importlib.import_module("repro_torch.verify")
    with pytest.raises(SystemExit) as e:
        verify.main(["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert out.startswith("usage: python -m repro_torch.verify")
    assert "repro.verify" not in out.replace("repro_torch.verify", "")


@pytest.mark.parametrize("policy", ["keep", "recompute", "offload"])
@pytest.mark.parametrize("site", ["edge", "datacenter"])
def test_serve_cli_equals_reference(capsys, site, policy):
    """Every site and policy at the defaults (4 chips, 16 slots): the report
    and the exit code (1 when a phase overflows capacity) are the
    reference's."""
    rc, out = run_both(capsys, SERVE, ["--site", site, "--policy", policy])
    assert rc in (0, 1)
    assert ("OVER CAPACITY" in out) == (rc == 1)
    assert out.startswith(f"{site} x4 (")


def test_launch_serve_cli(capsys):
    """``tests/test_serving.py::test_launch_serve_cli``: edge, 4 chips, 4 slots,
    offload — exit 0, the report's sections, equal to the reference's."""
    rc, out = run_both(capsys, SERVE, ["--site", "edge", "--chips", "4", "--slots", "4",
                                       "--policy", "offload"])
    assert rc == 0
    assert "throughput" in out and "tok/J" in out and "max KEEP slots" in out


def test_serve_cli_rejects_bad_tp_as_the_reference(capsys):
    """5 chips do not divide GPT-2's 12 heads: both exit 2 through
    ``ap.error`` with the same message."""
    err = []
    for name in SERVE:
        with pytest.raises(SystemExit) as e:
            importlib.import_module(name).main(["--chips", "5"])
        assert e.value.code == 2
        err.append(capsys.readouterr().err)
    assert err[0] == err[1] and "error:" in err[0]
