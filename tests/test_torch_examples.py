"""The port's twins of the nine examples (``examples/port/``) against the
reference's (``examples/``), on the CPU.

* No twin imports ``jax`` or ``repro`` (a source scan, then all nine imported
  in a fresh process that must not load either).
* The seven host twins (chip_smoke.py's ``HOST_TWINS``: arguments and CSV rows)
  run in this process beside the reference's example at
  the same small arguments: stdout equal line for line and the CSV byte for
  byte.  ``quickstart`` calls ``solve_fusion(..., time_limit_s=5)``, whose
  candidate enumeration and exact-cover DP stop at a wall-clock deadline
  (``core/fusion.py``); on ResNet-18's training graph they take ≈ 0.07 s and
  ≈ 0.003 s of their 5 s and 2.5 s, so the deadline does not bind and
  nothing is left out of the equality.
* ``checkpointing_ga``: its front and families are ``repro.core``'s, its toy
  step gives loss 32768 and grad norm 512, and the gradients under each
  policy are plain autograd's bit for bit.
* ``train_lm``: the configs are the reference's field for field; five
  ``--tiny`` steps from the reference's initial weights (both in fp32) follow
  the reference ``Trainer.fit`` within 1e-4 a step; a second call resumes.
"""

import argparse
import ast
import csv
import dataclasses
import importlib.util
import math
import os
import subprocess
import sys
import tempfile
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro_torch.core as core
from repro.configs.base import ShapeConfig as RefShapeConfig
from repro.core.remat_policy import family_of as ref_family_of
from repro.launch import train as ref_train
from repro.models import transformer as ref_transformer
from repro_torch.convert import from_reference
from repro_torch.core.remat_policy import checkpointed, resolve_remat
from repro_torch.launch import train as port_train

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
PORT = os.path.join(ROOT, "examples", "port")
NAMES = ("checkpointing_ga", "dse_resnet", "fusion_search", "memory_wall", "parallel_training",
         "quickstart", "resilience", "serve_lm", "train_lm")
FP32 = dict(param_dtype="float32", compute_dtype="float32")


def load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def twin(name):
    return load(os.path.join(PORT, f"{name}.py"), f"port_example_{name}")


def reference(name):
    return load(os.path.join(ROOT, "examples", f"{name}.py"), f"reference_example_{name}")


def _imported_roots(path):
    tree = ast.parse(open(path).read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


# -- imports --------------------------------------------------------------------------


def test_nine_twins_with_the_reference_names():
    ref_names = sorted(f for f in os.listdir(os.path.join(ROOT, "examples")) if f.endswith(".py"))
    assert sorted(f for f in os.listdir(PORT) if f.endswith(".py")) == ref_names
    assert [f"{n}.py" for n in NAMES] == ref_names


@pytest.mark.parametrize("name", NAMES)
def test_twin_imports_neither_jax_nor_repro(name):
    roots = _imported_roots(os.path.join(PORT, f"{name}.py"))
    assert "repro_torch" in roots
    assert not roots & {"jax", "jaxlib", "repro", "flax", "optax"}
    mod = twin(name)
    assert callable(mod.main)


def test_twins_import_in_a_process_without_jax():
    code = ("import importlib.util, os, sys\n"
            f"port = {PORT!r}\n"
            f"for name in {NAMES!r}:\n"
            "    path = os.path.join(port, name + '.py')\n"
            "    spec = importlib.util.spec_from_file_location(name, path)\n"
            "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))\n"
            "print('ok' if not bad else bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


class _Parsed(Exception):
    pass


def parser_of(mod):
    """The argument parser ``mod.main`` builds, caught at its ``parse_args``."""
    def catch(self, args=None, namespace=None):
        raise _Parsed(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", catch)
        with pytest.raises(_Parsed) as e:
            mod.main()
    return e.value.args[0]


def test_no_default_output_is_a_committed_artifact():
    committed = {os.path.join("artifacts", f) for f in os.listdir(os.path.join(ROOT, "artifacts"))}
    outs = {}
    for name in NAMES:
        p = parser_of(twin(name))
        out = p.get_default("out")
        if out is not None:
            outs[name] = out
            assert out.startswith("artifacts/port/") and out not in committed, (name, out)
            ref_out = parser_of(reference(name)).get_default("out")
            assert os.path.basename(out) == os.path.basename(ref_out) and out != ref_out
    assert len(outs) == 6
    p = parser_of(twin("train_lm"))
    assert p.get_default("ckpt_dir") == os.path.join(tempfile.gettempdir(), "lm100m_torch_ckpt")
    assert p.get_default("ckpt_dir") != parser_of(reference("train_lm")).get_default("ckpt_dir")
    for name in ("train_lm", "checkpointing_ga"):
        assert parser_of(twin(name)).get_default("device") == "cuda"


# -- the seven host twins -------------------------------------------------------------


def host_twins():
    """chip_smoke.py's ``HOST_TWINS``, the one table of the host twins'
    small arguments and CSV rows (read from the source: the script exits at
    import without a GPU)."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and ast.unparse(node.targets[0]) == "HOST_TWINS":
            return {name: (args, rows) for name, args, rows in ast.literal_eval(node.value)}
    raise AssertionError("chip_smoke.py has no HOST_TWINS")


HOST = host_twins()


def cold_engines():
    """Both sides start from cold engines and rewrite caches, as a fresh
    process does: ``fusion_search`` prints its cache counters."""
    for m in (core, ref_core):
        m.clear_engines()
        m.parallel._REWRITES.clear()


def run_host_pair(name, args, tmp_path, monkeypatch, capsys):
    """(exit code, stdout, CSV bytes) of the reference's example and of its
    twin at the same arguments, each writing the same ``--out`` path in turn
    (the path is printed)."""
    out = str(tmp_path / f"{name}.csv")
    argv = args + (["--out", out] if name != "quickstart" else [])
    results = []
    for side in ("reference", "twin"):
        cold_engines()
        if side == "reference":
            mod = reference(name)
            monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
            rc = mod.main()
        else:
            rc = twin(name).main(argv)
        text = capsys.readouterr().out
        data = None
        if os.path.exists(out):
            with open(out, "rb") as f:
                data = f.read()
            os.remove(out)
        results.append((rc, text, data))
    return results


@pytest.mark.parametrize("name", list(HOST))
def test_host_twin_equals_reference(name, tmp_path, monkeypatch, capsys):
    args, rows = HOST[name]
    (rc, text, data), (rc_t, text_t, data_t) = run_host_pair(name, args, tmp_path,
                                                            monkeypatch, capsys)
    assert rc_t == rc
    assert text_t.splitlines() == text.splitlines()
    assert len(text.splitlines()) > 10
    assert data_t == data
    assert (data is None) == (name == "quickstart")
    if data is not None:
        assert len(data.splitlines()) > 2
        # the rows chip_smoke.py expects of the twin on the card's host
        assert len(list(csv.reader(data.decode().splitlines()))) - 1 == rows


def test_serve_lm_twin_writes_pareto_csv(tmp_path):
    out = tmp_path / "serve_pareto.csv"
    twin("serve_lm").main(["--chips", "1", "4", "--slots", "4", "64", "--out", str(out)])
    with open(out) as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 24             # 2 sites x 2 chips x 2 slots x 3 policies
    assert {r["site"] for r in rows} == {"edge", "datacenter"}
    assert {r["policy"] for r in rows} == {"KEEP", "RECOMPUTE", "OFFLOAD"}
    for r in rows:
        assert float(r["rps"]) > 0


def test_serve_lm_twin_prints_front(tmp_path, capsys):
    twin("serve_lm").main(["--chips", "1", "4", "--slots", "4", "64",
                           "--out", str(tmp_path / "s.csv")])
    text = capsys.readouterr().out
    assert "front" in text and "best tokens/J" in text and "24 rows -> " in text


# -- checkpointing_ga -----------------------------------------------------------------


def reference_search_lines():
    """What the example prints of the search, from ``repro.core`` directly:
    the reference's example stops later, at ``jax.ad_checkpoint`` (queue C)."""
    g = ref_core.gpt2_graph(batch=1, seq=128, d_model=256, n_layers=2, n_heads=4, vocab=2048)
    res = ref_core.ga_checkpointing(ref_core.build_training_graph(g, "adam"), ref_core.edge_tpu(),
                                    pop_size=16, generations=8, seed=0)
    base = res.baseline
    lines = [f"baseline: {base.act_bytes / 1e6:.2f} MB activations, latency {base.latency:.4g}",
             f"Pareto front ({len(res.pareto)} points):"]
    lines += [f"  {s.act_bytes / 1e6:6.2f} MB  lat ×{s.latency / base.latency:.3f}  "
              f"E ×{s.energy / base.energy:.3f}" for s in res.pareto]
    ok = [s for s in res.pareto if s.latency <= 1.1 * base.latency]
    chosen = min(ok or res.pareto, key=lambda s: s.act_bytes)
    fams = sorted({f for f in map(ref_family_of, chosen.keep) if f})
    return lines + ["", f"chosen keep-set -> activation families: {fams}"], chosen


def test_checkpointing_ga_twin_on_cpu(capsys):
    cold_engines()
    want, _ = reference_search_lines()
    capsys.readouterr()
    cold_engines()
    loss, gnorm = twin("checkpointing_ga").main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[:len(want)] == want
    assert len(want) > 5
    assert (loss, gnorm) == (32768.0, 512.0)
    assert lines[len(want)] == ("real PyTorch step under the MONET-chosen policy: "
                                "loss=32768.0, grad norm=512.0")
    assert "ModelConfig.remat = 'save:<families>'" in lines[-1]


@pytest.mark.parametrize("policy", ["chosen", "save:mlp_hidden,attn_out", "dots", "full"])
def test_checkpointing_ga_gradients_equal_plain_autograd(policy):
    mod = twin("checkpointing_ga")
    if policy == "chosen":
        _, chosen = reference_search_lines()
        pol = core.keepset_to_policy(chosen.keep)
    else:
        pol = resolve_remat(policy)[1]
    loss, grads = mod.value_and_grad(checkpointed(mod.block, pol), "cpu")
    loss_p, grads_p = mod.value_and_grad(mod.block, "cpu")
    assert torch.equal(loss, loss_p) and float(loss) == 32768.0
    for k in ("w1", "w2"):
        assert torch.equal(grads[k], grads_p[k]), k
    assert torch.equal(grads["w2"], torch.full((64, 64), 8.0))
    assert torch.equal(grads["w1"], torch.zeros(64, 64))


def test_device_twins_raise_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device would run")
    with pytest.raises(RuntimeError, match="CUDA device"):
        twin("checkpointing_ga").main([])
    with pytest.raises(RuntimeError, match="CUDA device"):
        twin("train_lm").main(["--tiny", "--steps", "1", "--ckpt-dir", str(tmp_path)])


# -- train_lm -------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["LM_100M", "LM_TINY"])
def test_train_lm_configs_equal_reference(name):
    mine, ref = getattr(twin("train_lm"), name), getattr(reference("train_lm"), name)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.param_count() == ref.param_count()
    assert mine.layer_specs() == [tuple(s) for s in ref.layer_specs()]
    if name == "LM_100M":
        assert mine.param_count() == 103_395_840 and not mine.use_flash


def test_train_lm_twin_matches_reference_fit(tmp_path, monkeypatch, capsys):
    """``--tiny --steps 5 --device cpu`` from the reference's initial weights,
    both sides in fp32: each step's loss within 1e-4 of the reference
    ``Trainer.fit``'s; then a second call with the same ``--ckpt-dir``
    resumes at step 5."""
    ref_cfg = replace(reference("train_lm").LM_TINY, **FP32)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        ref_transformer.init_params(ref_cfg, jax.random.PRNGKey(0)))
    # fresh arrays: the reference's jitted step donates its inputs
    monkeypatch.setattr(ref_train, "init_params",
                        lambda cfg, rng: jax.tree.map(jnp.asarray, tree))
    ref_logs = ref_train.Trainer(ref_cfg, RefShapeConfig("train", seq_len=512, global_batch=4,
                                                         kind="train"), lr=3e-4).fit(5)

    mod = twin("train_lm")
    monkeypatch.setattr(mod, "LM_TINY", replace(mod.LM_TINY, **FP32))
    monkeypatch.setattr(port_train, "init_params",
                        lambda cfg, seed, device: from_reference(tree, device))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    ckpt = str(tmp_path / "ckpt")
    capsys.readouterr()
    logs = mod.main(["--tiny", "--steps", "5", "--device", "cpu", "--ckpt-dir", ckpt])
    out = capsys.readouterr().out.splitlines()
    assert [l["step"] for l in logs] == list(range(5))
    for mine, ref in zip(logs, ref_logs, strict=True):
        assert math.isfinite(mine["loss"])
        assert abs(mine["loss"] - ref["loss"]) <= 1e-4, (mine["step"], mine["loss"], ref["loss"])
    assert out[0] == f"model: lm-tiny, {ref_cfg.param_count() / 1e6:.1f}M params"
    assert out[-1] == f"final loss {logs[-1]['loss']:.4f} after 5 steps; checkpoints in {ckpt}"
    assert len(out) == 7
    with open(tmp_path / "lm100m_torch_log.jsonl") as f:
        assert len(f.readlines()) == 5

    again = mod.main(["--tiny", "--steps", "7", "--device", "cpu", "--ckpt-dir", ckpt])
    assert [l["step"] for l in again] == [5, 6]
    assert all(math.isfinite(l["loss"]) for l in again)
    assert sorted(os.listdir(ckpt)) == ["step_00000005", "step_00000007"]
