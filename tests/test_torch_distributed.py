"""The port on a mesh: four ``gloo`` ranks on the CPU, (data, model) = (2, 2)
and (pod, data, model) = (2, 2, 1), against the unsharded port and the
reference.

The ranks run in subprocesses (``tests/torch_mesh_worker.py``): a process
group is global to a process and the suite runs under xdist, so no group is
started here.  They meet through a ``FileStore`` under ``tmp_path``, run under
a timeout of their own, and rank 0 returns one JSON line (and an npz of
gradients).  One module-scoped run; each test asserts on a part of it.

Tolerances (``docs/torch_port.md``): fp32, 2e-5 for values, 5e-5 for
gradients; a sharded step sums in another order than the unsharded one.
"""

import json
import os
import re
import subprocess
import sys
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.configs as ref_configs
from repro.data.pipeline import make_batch as ref_make_batch
from repro.models import transformer as ref_transformer
from repro.optim import optimizers as ref_optim
from repro.training import loss as ref_loss
from repro.training.train_step import make_train_step as ref_make_train_step
from repro_torch.convert import tree_flatten_with_path

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_mesh_worker as worker  # noqa: E402

WORLD = 4
TIMEOUT = 400
VAL_TOL, GRAD_TOL = 2e-5, 5e-5
#: after three AdamW steps at lr 1e-3 (parameters, first moments)
STEP_TOL = 1e-4
# the CLI's smoke config computes in bf16 and the shards sum in another order:
# its printed losses (about 5.5) agree to a few 1e-4 (1e-4 seen)
CLI_TOL = 2e-3


def ref_config(name):
    cfg = worker.configs()[name]
    base = ref_configs.smoke_config(cfg.name.removesuffix("-smoke"))
    keys = ("n_heads", "n_kv_heads", "param_dtype", "compute_dtype", "use_flash", "remat")
    ssm = {"ssm": replace(base.ssm, chunk=cfg.ssm.chunk)} if cfg.ssm else {}
    return replace(base, **{k: getattr(cfg, k) for k in keys}, **ssm)


def ref_params(name):
    p = ref_transformer.init_params(ref_config(name), jax.random.PRNGKey(0))
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), p)


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """The four ranks' run: (rank 0's JSON, its arrays, the workdir)."""
    wd = str(tmp_path_factory.mktemp("mesh"))
    for name in worker.configs():
        flat = tree_flatten_with_path(jax.tree.map(np.asarray, ref_params(name)))
        np.savez(os.path.join(wd, f"{name}.npz"), **flat)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen([sys.executable, worker.__file__, str(r), str(WORLD), wd],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env) for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT))
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), outs[0][1][-3000:]
    res = json.loads(outs[0][0].strip().splitlines()[-1])
    return res, dict(np.load(os.path.join(wd, "result.npz"))), wd


MESHES = ("dm", "pdm")


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", list(worker.configs()))
def test_sharded_steps_equal_unsharded(mesh_run, name, mesh):
    """Three sharded train steps (flash, rmsnorm, ssd_chunk, fused_adam
    through their DTensor routes) ≡ the same steps on no mesh: loss, every
    gradient, parameters and moments after the third update."""
    err = mesh_run[0]["errs"][f"{name}/{mesh}"]
    assert err["loss"] <= VAL_TOL and err["grads"] <= GRAD_TOL, err
    assert err["params"] <= STEP_TOL and err["m"] <= STEP_TOL, err


@pytest.fixture(scope="module")
def reference_steps():
    """Three reference steps for each config: losses, gradients (of the loss,
    before clipping) and parameters after each update."""
    out = {}
    shape = ref_configs.ShapeConfig("t", seq_len=worker.SHAPE.seq_len,
                                    global_batch=worker.SHAPE.global_batch, kind="train")
    for name in worker.configs():
        cfg = ref_config(name)
        p = ref_params(name)
        opt = ref_optim.adamw(ref_optim.warmup_cosine(worker.LR))
        state = opt.init(p)
        step = jax.jit(ref_make_train_step(cfg, opt))
        grad = jax.jit(jax.grad(lambda p, b: ref_loss.lm_loss(p, cfg, b["inputs"],
                                                               b["labels"])[0]))
        losses, grads = [], []
        for s in range(worker.STEPS):
            batch = ref_make_batch(cfg, shape, s)
            grads.append(tree_flatten_with_path(jax.tree.map(np.asarray, grad(p, batch))))
            p, state, m = step(p, state, batch, jnp.int32(s))
            losses.append(float(m["loss"]))
        out[name] = (losses, grads)
    return out


@pytest.mark.parametrize("mesh", ("none", *MESHES))
@pytest.mark.parametrize("name", list(worker.configs()))
def test_steps_equal_reference(mesh_run, reference_steps, name, mesh):
    """The port's steps, sharded and not, against the reference's: losses to
    2e-5, every gradient to 5e-5 at each of the three steps."""
    arrays = mesh_run[1]
    losses, grads = reference_steps[name]
    np.testing.assert_allclose(arrays[f"{name}/{mesh}/loss"], losses, atol=VAL_TOL)
    for s, ref in enumerate(grads):
        for key, want in ref.items():
            np.testing.assert_allclose(arrays[f"{name}/{mesh}/grad{s}/{key}"], want,
                                       atol=GRAD_TOL, err_msg=f"step {s} {key}")


@pytest.mark.parametrize("case", ["remat save:mlp_hidden,qkv/dm", "remat full/dm",
                                  "embed+sp/dm", "embed+sp/pdm"])
def test_variants_on_mesh(mesh_run, case):
    """Trap S (SAC on DTensors: keep-set and full recompute, besides the
    configs' ``dots``), and the vocab-sharded embedding with sequence-sharded
    activations: one step on the mesh ≡ on no mesh."""
    err = mesh_run[0]["errs"][case]
    assert err["loss"] <= VAL_TOL and err["grads"] <= GRAD_TOL, err


def test_embed_lookup_sharded_equals_gather(mesh_run):
    """``embed_lookup``'s masked gather over the vocab's 'model' shards ≡
    ``table[tokens]``, values and the table's gradient."""
    e = mesh_run[0]["checks"]["embed"]
    assert e["value"] <= VAL_TOL and e["grad"] <= GRAD_TOL, e


@pytest.mark.parametrize("name", ["gemma3", "mamba2"])
def test_decode_on_sharded_cache(mesh_run, name):
    """Twelve greedy decode steps with the cache's kv_seq over 'model' (each
    rank writes only the slots it holds) ≡ unsharded decode."""
    assert mesh_run[0]["errs"][f"decode {name}/dm"] <= VAL_TOL


def test_zero_layout(mesh_run):
    """Trap Z: on (pod, data, model) AdamW's moments of an embed-sharded leaf
    hold half of what its parameter does ('zero' over pod and data)."""
    c = mesh_run[0]["checks"]
    m, p = c["zero_m_shape"], c["zero_p_shape"]
    key = "scan/0/mlp/wi"
    assert m[key][1] * 2 == p[key][1] and m[key][2:] == p[key][2:], (m[key], p[key])


@pytest.mark.parametrize("what", ["files_equal", "onto_other_mesh", "onto_no_mesh"])
def test_checkpoint_across_meshes(mesh_run, what):
    """Trap C: a checkpoint written on (2, 2) (gathered on the main thread,
    written by rank 0) has an unsharded run's files and restores bit for bit
    onto (2, 2, 1) and onto no mesh."""
    assert mesh_run[0]["checks"]["ckpt"][what]


def test_trainer_on_mesh(mesh_run):
    """``Trainer(mesh=...)``: four steps with a node failure at step 3, restored
    from the step-2 checkpoint onto the mesh ``best_mesh_for(4)`` rebuilds
    ((data, model) = (4, 1)) and step 2 replayed; every step's loss equals the
    run's on no mesh."""
    t = mesh_run[0]["checks"]["trainer"]
    assert t["failures"] == 1 and t["steps"] == [0, 1, 2, 2, 3], t
    assert t["mesh_after"] == [["data", "model"], [4, 1]] and t["params_placed"], t
    assert t["loss_err"] <= VAL_TOL, t


@pytest.mark.parametrize("trap,tol", [("R", GRAD_TOL), ("G", VAL_TOL), ("Z", STEP_TOL)])
def test_planted_faults_are_seen(mesh_run, trap, tol):
    """R: dscale (and every replicated operand's gradient) left unreduced;
    G: q heads grouped onto the local kv heads as if whole (H = 6, Kv = 3);
    Z: the ZeRO update never written back to p.  Each reads above the
    tolerance its check holds."""
    err = mesh_run[0]["faults"][trap]
    read = {"R": err["grads"], "G": err["loss"], "Z": err["params"]}[trap]
    assert read > tol, err


def _cli_losses(line: str) -> list:
    m = re.match(r"steps=(\d+) loss (\S+) -> (\S+) .*failures=(\d+)$", line)
    assert m, line
    return [int(m[1]), float(m[2]), float(m[3]), int(m[4])]


def test_cli_trains_on_a_mesh(mesh_run):
    """``launch.train.main(['--mesh', '2,2', ...])`` on the four ranks: it
    joins the group it finds (and leaves it standing), trains the smoke
    gemma3 two steps on the (2, 2) mesh and prints, on rank 0, the losses of
    the same command without ``--mesh`` (bf16, printed to four decimals)."""
    c = mesh_run[0]["checks"]["cli"]
    assert c["group_alive"], c
    got, want = _cli_losses(c["mesh"]), _cli_losses(c["none"])
    assert got[0] == want[0] == 2 and got[3] == want[3] == 0, c
    assert got[1:3] == pytest.approx(want[1:3], abs=CLI_TOL), c
