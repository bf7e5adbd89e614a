"""The training side of the port against the JAX package: optimizer,
schedule, clipping, whole train steps from shared weights, the trainer and
the checkpoint store (both directions)."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro_torch.configs as configs
from repro.ckpt import store as ref_store
from repro.data.pipeline import make_batch as ref_make_batch
from repro.models import transformer as ref_transformer
from repro.optim import optimizers as ref_optim
from repro.training.train_step import make_train_step as ref_make_train_step
from repro_torch.ckpt import store
from repro_torch.convert import (from_reference, to_reference, tree_flatten_with_path,
                                 tree_map)
from repro_torch.data.pipeline import make_batch
from repro_torch.launch.train import NodeFailure, Trainer
from repro_torch.optim import optimizers as optim
from repro_torch.training.train_step import make_eval_step, make_train_step

SHAPE = configs.ShapeConfig("t", seq_len=64, global_batch=4, kind="train")
FP32 = dict(param_dtype="float32", compute_dtype="float32")


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def to_torch(jtree):
    return from_reference(jax.tree.map(np.asarray, jtree), "cpu")


def assert_trees_close(mine, ref, atol):
    a = tree_flatten_with_path(mine)
    b = tree_flatten_with_path(jax.tree.map(np.asarray, ref))
    assert list(a) == list(b)
    for k in a:
        np.testing.assert_allclose(f32(a[k]), f32(b[k]), atol=atol, err_msg=k)


@pytest.fixture(scope="module")
def cfg():
    return configs.smoke_config("gemma3-1b")


# -- optimizer ------------------------------------------------------------------------


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_adamw_three_steps_match_reference(state_dtype, param_dtype):
    """fp32 math, decay on the old p, b2 = 0.95, schedule and bias corrections
    in fp32.  1e-6: the two libraries fuse the multiply-adds differently.
    With bf16 params or states both sides round to the same grid, so the
    bound is one bf16 ulp where a value sits on a rounding boundary."""
    rng = np.random.default_rng(0)
    jp = {"a": {"w": jnp.asarray(rng.standard_normal((16, 8)), param_dtype)},
          "b": jnp.asarray(rng.standard_normal((8,)), jnp.float32)}
    grads = [jax.tree.map(lambda p: jnp.asarray(
        rng.standard_normal(p.shape) * 0.1, p.dtype), jp) for _ in range(3)]
    lr = 1e-2
    ref_opt = ref_optim.adamw(ref_optim.warmup_cosine(lr, warmup=2, total=10),
                              weight_decay=0.01, state_dtype=state_dtype)
    opt = optim.adamw(optim.warmup_cosine(lr, warmup=2, total=10), weight_decay=0.01,
                      state_dtype=state_dtype)
    tp = to_torch(jp)
    js, ts = ref_opt.init(jp), opt.init(tp)
    assert ts["m"]["a"]["w"].dtype == getattr(torch, state_dtype)
    assert ts["count"].dtype == torch.int32
    for step, g in enumerate(grads):
        jp, js = ref_opt.update(g, js, jp, step)
        tp, ts = opt.update(to_torch(g), ts, tp, step)
    exact = state_dtype == "float32" and param_dtype == "float32"
    tol = 1e-6 if exact else 8e-3
    assert_trees_close(tp, jp, tol)
    assert_trees_close({"m": ts["m"], "v": ts["v"]}, {"m": js["m"], "v": js["v"]}, tol)
    assert int(ts["count"]) == int(js["count"]) == 3
    assert tp["a"]["w"].dtype == getattr(torch, param_dtype)


def test_adamw_updates_in_place():
    p = {"w": torch.ones(4)}
    opt = optim.adamw(lr=0.1, b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.0)
    st = opt.init(p)
    newp, newst = opt.update({"w": torch.full((4,), 0.5)}, st, p, 0)
    assert newp["w"] is p["w"] and newst["m"]["w"] is st["m"]["w"]
    m, v = 0.1 * 0.5, 0.01 * 0.25
    step = (m / 0.1) / (np.sqrt(v / 0.01) + 1e-8)
    np.testing.assert_allclose(f32(p["w"]), 1.0 - 0.1 * step, rtol=1e-6)


@pytest.mark.parametrize("arch", ["gemma3-1b", "mamba2-1.3b"])
def test_adamw_update_is_one_multi_tensor_call(arch, monkeypatch):
    """``adamw().update`` makes one ``ops.fused_adam_multi`` call a step over
    every leaf of the tree, and gives, bit for bit, what ``fused_adam_plain``
    gives leaf by leaf."""
    from repro_torch.kernels import fused_adam as fad
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import init_params
    params = init_params(configs.smoke_config(arch), 0, "cpu")
    rng = np.random.default_rng(3)
    grads = tree_map(lambda p: torch.from_numpy(
        rng.standard_normal(tuple(p.shape)).astype(np.float32)).to(p.dtype), params)
    opt = optim.adamw(lr=1e-3, weight_decay=0.01)
    state = opt.init(params)
    want = {k: [t.clone() for t in leaf] for k, leaf in zip(
        tree_flatten_with_path(params), zip(*(tree_flatten_with_path(t).values() for t in (
            params, grads, state["m"], state["v"])), strict=True), strict=True)}
    calls = []
    multi = ops.fused_adam_multi
    monkeypatch.setattr(ops, "fused_adam_multi", lambda *a: calls.append(len(a[0])) or multi(*a))
    newp, newst = opt.update(grads, state, params, 0)
    assert calls == [len(want)]
    count = torch.tensor(1, dtype=torch.int32)
    for key, (p, g, m, v) in want.items():
        fad.fused_adam_plain(p, g, m, v, count, 1e-3, weight_decay=0.01)
        for a, b in ((newp, p), (newst["m"], m), (newst["v"], v)):
            assert torch.equal(tree_flatten_with_path(a)[key], b), key


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_by_global_norm(dtype):
    rng = np.random.default_rng(1)
    jg = {"a": jnp.asarray(rng.standard_normal((8, 4)) * 3, dtype),
          "b": jnp.asarray(rng.standard_normal((5,)) * 4, jnp.float32)}
    tg = to_torch(jg)
    want, want_norm = ref_optim.clip_by_global_norm(jg, 1.0)
    got, got_norm = optim.clip_by_global_norm(tg, 1.0)
    np.testing.assert_allclose(float(got_norm), float(want_norm), rtol=1e-6)
    assert got["a"].dtype == getattr(torch, dtype)        # cast back to the grad's dtype
    assert_trees_close(got, want, 1e-6 if dtype == "float32" else 4e-3)
    np.testing.assert_allclose(float(optim.global_norm(got)), 1.0, rtol=1e-2)
    # below the threshold nothing changes
    small = {"a": torch.full((4,), 0.1)}
    out, norm = optim.clip_by_global_norm(small, 1.0)
    np.testing.assert_allclose(f32(out["a"]), 0.1, rtol=1e-7)
    np.testing.assert_allclose(float(norm), 0.2, rtol=1e-6)


def test_warmup_cosine_schedule():
    ref_lr = ref_optim.warmup_cosine(3e-4, warmup=10, total=100)
    lr = optim.warmup_cosine(3e-4, warmup=10, total=100)
    for step in (0, 1, 9, 10, 11, 50, 99, 100, 500):
        np.testing.assert_allclose(float(lr(step)), float(ref_lr(step)), rtol=2e-6)
    assert lr(0).dtype == torch.float32
    assert float(lr(0)) < float(lr(9)) and float(lr(99)) < 0.2 * 3e-4


# -- the slice as a whole ---------------------------------------------------------------


def test_five_train_steps_match_reference():
    """From the same weights and the same batches, five whole steps (forward
    through the flash path, backward, clipping, AdamW) in both packages, fp32,
    S = 128.  Loss per step and final parameters to 1e-4: five steps of 5e-5
    gradient differences through a normalising optimizer."""
    kw = dict(n_layers=8, use_flash=True, **FP32)
    cfg = replace(configs.smoke_config("gemma3-1b"), **kw)
    ref_cfg = replace(ref_configs.smoke_config("gemma3-1b"), **kw)
    shape = configs.ShapeConfig("t", seq_len=128, global_batch=2, kind="train")
    jp = ref_transformer.init_params(ref_cfg, jax.random.PRNGKey(0))
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    tp = to_torch(jp)
    lr = 1e-3
    ref_opt = ref_optim.adamw(ref_optim.warmup_cosine(lr))
    opt = optim.adamw(optim.warmup_cosine(lr))
    js, ts = ref_opt.init(jp), opt.init(tp)
    ref_step = jax.jit(ref_make_train_step(ref_cfg, ref_opt))
    step_fn = make_train_step(cfg, opt)
    for step in range(5):
        jb = ref_make_batch(ref_cfg, shape, step)
        tb = make_batch(cfg, shape, step, device="cpu")
        jp, js, jm = ref_step(jp, js, jb, jnp.int32(step))
        tp, ts, tm = step_fn(tp, ts, tb, step)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), atol=1e-4)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=1e-4)
        assert int(tm["lr_step"]) == step
    assert_trees_close(tp, jp, 1e-4)
    assert_trees_close(ts["m"], js["m"], 1e-4)


def test_grad_accum_equivalence(cfg):
    """Two microbatches accumulated in fp32 == one batch (bf16 weights, as
    configured; 3e-2 as in the reference's test)."""
    from repro_torch.models.transformer import init_params
    batch = make_batch(cfg, SHAPE, 0, device="cpu")
    opt = optim.adamw(lr=1e-2)
    outs = {}
    for ga in (1, 2):
        params = init_params(cfg, 0, "cpu")
        p2, _, m = make_train_step(cfg, opt, grad_accum=ga)(params, opt.init(params),
                                                             batch, 0)
        outs[ga] = (p2, float(m["loss"]))
    assert abs(outs[1][1] - outs[2][1]) < 1e-2
    for a, b in zip(tree_flatten_with_path(outs[1][0]).values(),
                    tree_flatten_with_path(outs[2][0]).values(), strict=True):
        np.testing.assert_allclose(f32(a), f32(b), atol=3e-2)


def test_grad_accum_matches_reference_fp32():
    cfg = replace(configs.smoke_config("gemma3-1b"), **FP32)
    ref_cfg = replace(ref_configs.smoke_config("gemma3-1b"), **FP32)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      ref_transformer.init_params(ref_cfg, jax.random.PRNGKey(1)))
    tp = to_torch(jp)
    # a large eps keeps Adam's first step from amplifying the sign of
    # near-zero gradients, so the parameters can be held to 1e-5
    ref_opt, opt = ref_optim.adamw(lr=1e-3, eps=1e-2), optim.adamw(lr=1e-3, eps=1e-2)
    jp2, _, jm = jax.jit(ref_make_train_step(ref_cfg, ref_opt, grad_accum=2))(
        jp, ref_opt.init(jp), ref_make_batch(ref_cfg, SHAPE, 0), jnp.int32(0))
    tp2, _, tm = make_train_step(cfg, opt, grad_accum=2)(
        tp, opt.init(tp), make_batch(cfg, SHAPE, 0, device="cpu"), 0)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), atol=2e-5)
    assert_trees_close(tp2, jp2, 1e-5)


def test_eval_step(cfg):
    from repro_torch.models.transformer import init_params
    params = init_params(cfg, 0, "cpu")
    m = make_eval_step(cfg)(params, make_batch(cfg, SHAPE, 0, device="cpu"))
    assert float(m["tokens"]) == 256.0 and np.isfinite(float(m["loss"]))
    assert not m["loss"].requires_grad


# -- trainer ----------------------------------------------------------------------------


def test_loss_decreases(cfg):
    tr = Trainer(cfg, SHAPE, lr=1e-2, device="cpu")
    logs = tr.fit(30)
    first = np.mean([l["loss"] for l in logs[:5]])
    last = np.mean([l["loss"] for l in logs[-5:]])
    assert last < first - 1e-3


def test_checkpoint_resume_exact(cfg, tmp_path):
    ck = str(tmp_path / "ck")
    tr1 = Trainer(cfg, SHAPE, lr=1e-3, ckpt_dir=ck, ckpt_every=5, device="cpu")
    tr1.fit(10)
    tr1.ckpt.close()

    # fresh trainer resumes from the step-10 checkpoint and continues to 12
    tr2 = Trainer(cfg, SHAPE, lr=1e-3, ckpt_dir=ck, ckpt_every=100, device="cpu")
    logs2 = tr2.fit(12)
    tr2.ckpt.close()
    assert logs2[0]["step"] == 10

    # one-shot trainer that runs 12 steps without interruption
    tr3 = Trainer(cfg, SHAPE, lr=1e-3, device="cpu")
    logs3 = tr3.fit(12)
    assert abs(logs3[-1]["loss"] - logs2[-1]["loss"]) < 1e-4
    for a, b in zip(tree_flatten_with_path(tr2._last_state[0]).values(),
                    tree_flatten_with_path(tr3._last_state[0]).values(), strict=True):
        assert torch.equal(a, b)


def test_failure_injection_recovers(cfg, tmp_path):
    ck = str(tmp_path / "ck")
    tr = Trainer(cfg, SHAPE, lr=1e-3, ckpt_dir=ck, ckpt_every=4, device="cpu")
    logs = tr.fit(10, inject_failure_at=6)
    tr.ckpt.close()
    assert tr.failures == 1
    assert logs[-1]["step"] == 9
    # steps 4..6 re-run after restore from the step-4 checkpoint
    steps = [l["step"] for l in logs]
    assert steps.count(5) >= 1


def test_node_failure_without_checkpoint_raises(cfg):
    tr = Trainer(cfg, SHAPE, device="cpu")
    with pytest.raises(NodeFailure):
        tr.fit(3, inject_failure_at=1)
    assert tr.failures == 1


def test_other_exceptions_propagate(cfg, tmp_path):
    """Only NodeFailure is recovered from.  A step that fails for any other
    reason (here: a kernel that cannot launch) must surface, not be retried
    from the checkpoint for ever."""
    tr = Trainer(cfg, SHAPE, ckpt_dir=str(tmp_path / "ck"), ckpt_every=2, device="cpu")
    calls = []
    real = tr.step_fn

    def broken(params, opt_state, batch, step):
        calls.append(step)
        if step == 3:
            raise RuntimeError("flash_fwd: CUDA launch failed with error 1")
        return real(params, opt_state, batch, step)

    tr.step_fn = broken
    with pytest.raises(RuntimeError, match="launch failed"):
        tr.fit(6)
    tr.ckpt.close()
    assert calls == [0, 1, 2, 3] and tr.failures == 0


def test_straggler_watchdog(cfg):
    tr = Trainer(cfg, SHAPE, lr=1e-3, straggler_factor=0.0, device="cpu")
    tr.fit(8)
    assert tr.stragglers > 0            # every step flagged at factor 0


def test_jsonl_log(cfg, tmp_path):
    import json
    log = tmp_path / "log.jsonl"
    Trainer(cfg, SHAPE, device="cpu").fit(3, log_path=str(log))
    rows = [json.loads(l) for l in log.read_text().splitlines()]
    assert [r["step"] for r in rows] == [0, 1, 2]
    assert {"loss", "nll", "grad_norm", "time_s", "tokens"} <= set(rows[0])


def test_launch_main_cpu(tmp_path, capsys):
    from repro_torch.launch.train import main
    main(["--arch", "gemma3-1b", "--smoke", "--device", "cpu", "--steps", "3",
          "--seq", "128", "--batch", "2", "--ckpt-dir", str(tmp_path / "ck")])
    assert "steps=3 loss" in capsys.readouterr().out
    assert store.latest_step(str(tmp_path / "ck")) == 3


# -- checkpoint store ---------------------------------------------------------------------


def _state_trees():
    rng = np.random.default_rng(2)
    jtree = {"params": {"w": jnp.asarray(rng.standard_normal((6, 4)), jnp.bfloat16),
                        "scale": jnp.asarray(rng.standard_normal((4,)), jnp.float32)},
             "opt": {"count": jnp.asarray(7, jnp.int32),
                     "m": {"w": jnp.asarray(rng.standard_normal((6, 4)), jnp.float32)}}}
    return jtree, to_torch(jtree)


def test_checkpoint_written_by_reference_loads_in_port(tmp_path):
    jtree, ttree = _state_trees()
    ref_store.save_checkpoint(str(tmp_path), 5, jtree, extra={"arch": "x"})
    tmpl = tree_map(torch.zeros_like, ttree)
    out, manifest = store.load_checkpoint(str(tmp_path), tmpl, device="cpu")
    assert manifest["step"] == 5 and manifest["extra"] == {"arch": "x"}
    for (k, a), b in zip(tree_flatten_with_path(out).items(),
                         tree_flatten_with_path(ttree).values(), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b), k


def test_checkpoint_written_by_port_loads_in_reference(tmp_path):
    jtree, ttree = _state_trees()
    store.save_checkpoint(str(tmp_path), 9, ttree)
    out, manifest = ref_store.load_checkpoint(str(tmp_path), jtree)
    assert manifest["step"] == 9
    for a, b in zip(jax.tree.leaves(out), jax.tree.leaves(jtree), strict=True):
        assert a.dtype == b.dtype
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    # and the files are the same, leaf for leaf
    ref_store.save_checkpoint(str(tmp_path / "ref"), 9, jtree)
    mine = np.load(tmp_path / "step_00000009" / "arrays.npz")
    ref = np.load(tmp_path / "ref" / "step_00000009" / "arrays.npz")
    assert sorted(mine.files) == sorted(ref.files)
    for k in mine.files:
        assert mine[k].dtype == ref[k].dtype and mine[k].tobytes() == ref[k].tobytes(), k


def test_ckpt_atomic_prune_and_shape_check(tmp_path):
    import os
    tree = {"x": torch.zeros(2)}
    for s in (1, 2, 3, 4):
        store.save_checkpoint(str(tmp_path), s, tree)
    assert store.latest_step(str(tmp_path)) == 4
    store.prune_checkpoints(str(tmp_path), keep=2)
    assert store.available_steps(str(tmp_path)) == [3, 4]
    os.makedirs(tmp_path / ".tmp_9", exist_ok=True)      # a stray tmp dir is never listed
    assert store.latest_step(str(tmp_path)) == 4
    with pytest.raises(ValueError):
        store.load_checkpoint(str(tmp_path), {"x": torch.zeros(5)}, device="cpu")
    with pytest.raises(KeyError):
        store.load_checkpoint(str(tmp_path), {"y": torch.zeros(2)}, device="cpu")
    with pytest.raises(FileNotFoundError):
        store.load_checkpoint(str(tmp_path / "none"), tree, device="cpu")


def test_async_checkpointer_snapshots_before_in_place_update(tmp_path):
    ck = store.AsyncCheckpointer(str(tmp_path))
    w = torch.full((8,), 1.0)
    ck.save(1, {"w": w})
    w.fill_(2.0)                       # what the in-place optimizer does next
    ck.save(2, {"w": w})
    ck.close()
    one, _ = store.load_checkpoint(str(tmp_path), {"w": w}, step=1, device="cpu")
    two, m = store.load_checkpoint(str(tmp_path), {"w": w}, device="cpu")
    assert float(one["w"][0]) == 1.0 and float(two["w"][0]) == 2.0 and m["step"] == 2
    assert to_reference(two)["w"].dtype == np.float32
