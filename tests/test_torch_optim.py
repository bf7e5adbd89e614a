"""The port's ``sgd_momentum``, ``adafactor`` and ``galore_adamw`` against
the reference's ``optim/optimizers.py``, on the CPU.

Mirrors ``tests/test_train_loop.py``'s optimizer tests, then holds five
updates over the smoke gemma3 tree leaf by leaf (fp32 to 2e-5; bf16 params
with fp32 states to 2e-2, one bf16 rounding of the parameters), the state
trees (structure, shapes, dtypes, checkpoints both ways) and three whole
``Trainer.fit`` steps (1e-4, as ``test_torch_train.py``'s five steps).
GaLore's projection is drawn from ``jax.random`` on the reference's side,
which no torch generator reproduces: its parity takes the reference's state,
carried across with ``convert.from_reference``.
"""

import re
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro_torch.configs as configs
from repro.ckpt import store as ref_store
from repro.launch import train as ref_train
from repro.models import transformer as ref_transformer
from repro.optim import optimizers as ref_optim
from repro_torch.ckpt import store
from repro_torch.convert import from_reference, tree_flatten_with_path, tree_leaves, tree_map
from repro_torch.launch import train
from repro_torch.optim import optimizers as optim

NAMES = ["sgd_momentum", "adafactor", "galore_adamw"]
#: rank 4 projects the 2-D leaves with min(shape) > 16 of the smoke model:
#: the embedding table and the remainder layers' matrices
KW = {"adamw": {}, "sgd_momentum": {}, "adafactor": {}, "galore_adamw": {"rank": 4}}
ROOT = Path(__file__).resolve().parents[1]


def f32(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def to_torch(jtree):
    return from_reference(jax.tree.map(np.asarray, jtree), "cpu")


def assert_trees_close(mine, ref, atol, rel=False):
    a = tree_flatten_with_path(mine)
    b = tree_flatten_with_path(jax.tree.map(np.asarray, ref))
    assert list(a) == list(b)
    for k in a:
        scale = max(float(np.abs(f32(b[k])).max()), 1e-30) if rel else 1.0
        np.testing.assert_allclose(f32(a[k]) / scale, f32(b[k]) / scale, atol=atol, err_msg=k)


def smoke_params(dtype):
    """The smoke gemma3 tree (a scanned period of 6, a remainder of 2) from
    the reference's init, every leaf in ``dtype``."""
    cfg = replace(ref_configs.smoke_config("gemma3-1b"), n_layers=8)
    return jax.tree.map(lambda a: a.astype(dtype),
                        ref_transformer.init_params(cfg, jax.random.PRNGKey(0)))


# -- test_train_loop.py's optimizer tests ---------------------------------------------


def test_sgd_momentum_two_steps():
    p = {"w": torch.zeros(2)}
    g = {"w": torch.ones(2)}
    opt = optim.sgd_momentum(lr=1.0, momentum=0.5)
    st = opt.init(p)
    assert set(st) == {"v"} and st["v"]["w"].dtype == torch.float32
    p1, st = opt.update(g, st, p, 0)
    p2, st = opt.update(g, st, p1, 1)
    np.testing.assert_allclose(f32(p2["w"]), [-2.5, -2.5])
    assert p2["w"] is p["w"]                         # in place


def test_adafactor_memory_factored():
    p = {"w": torch.ones(32, 16), "stack": torch.ones(3, 32, 16), "b": torch.ones(5)}
    opt = optim.adafactor(lr=1e-2)
    st = opt.init(p)
    assert st["f"]["w"]["r"].shape == (32,) and st["f"]["w"]["c"].shape == (16,)
    # a stacked leaf factors over its last two axes
    assert st["f"]["stack"]["r"].shape == (3, 32) and st["f"]["stack"]["c"].shape == (3, 16)
    assert set(st["f"]["b"]) == {"v"} and st["count"].dtype == torch.int32
    g = tree_map(torch.ones_like, p)
    before = p["w"].clone()
    newp, st = opt.update(g, st, p, 0)
    assert float((newp["w"] - before).abs().max()) > 0 and int(st["count"]) == 1


def test_galore_low_rank_states():
    p = {"w": torch.ones(512, 256)}
    opt = optim.galore_adamw(lr=1e-3, rank=16)
    st = opt.init(p)
    assert st["s"]["w"]["m"].shape == (16, 256)      # compressed moments
    assert st["s"]["w"]["P"].shape == (512, 16)
    g = {"w": torch.ones(512, 256)}
    before = p["w"].clone()
    newp, st2 = opt.update(g, st, p, 0)
    assert float((newp["w"] - before).abs().max()) > 0
    P = st["s"]["w"]["P"].numpy()
    np.testing.assert_allclose(P.T @ P, np.eye(16), atol=1e-5)


# -- against the reference --------------------------------------------------------------


@pytest.mark.parametrize("name", ["adamw", *NAMES])
def test_state_tree_matches_reference(name):
    """``make_optimizer`` builds every optimizer of the reference with the
    same state tree: keys, shapes and dtypes of every leaf."""
    jp = smoke_params(jnp.bfloat16)
    want = tree_flatten_with_path(jax.tree.map(np.asarray, ref_optim.make_optimizer(
        name, 1e-3, **KW[name]).init(jp)))
    got = tree_flatten_with_path(optim.make_optimizer(name, 1e-3, **KW[name]).init(to_torch(jp)))
    assert list(got) == list(want)
    for k in got:
        assert tuple(got[k].shape) == want[k].shape, k
        assert str(got[k].dtype)[6:] == str(want[k].dtype), k
    if name == "galore_adamw":
        projected = sorted(k for k in got if k.endswith("/P"))
        assert projected and "s/embed/table/P" in projected
        assert not any(k.startswith("s/scan/") for k in projected)   # 3-D: never


def test_unknown_optimizer_raises_on_both_sides():
    with pytest.raises(KeyError):
        ref_optim.make_optimizer("lion")
    with pytest.raises(KeyError):
        optim.make_optimizer("lion")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", NAMES)
def test_five_updates_match_reference(name, dtype):
    """Five updates from the same state with the same gradients (in the
    params' dtype, as a step passes them): parameters and states leaf by
    leaf.  fp32: 2e-5 (states relative to the leaf's largest entry);
    bf16 params: 2e-2, fp32 states to 2e-5 of their largest entry."""
    jp = smoke_params(jnp.dtype(dtype))
    rng = np.random.default_rng(0)
    grads = [jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape) * 0.1, a.dtype),
                          jp) for _ in range(5)]
    ref_opt = ref_optim.make_optimizer(name, 1e-2, **KW[name])
    opt = optim.make_optimizer(name, 1e-2, **KW[name])
    js = ref_opt.init(jp)
    tp, ts = to_torch(jp), to_torch(js)          # galore: the reference's P
    for step, g in enumerate(grads):
        jp, js = ref_opt.update(g, js, jp, step)
        tp, ts = opt.update(to_torch(g), ts, tp, step)
    assert_trees_close(tp, jp, 2e-5 if dtype == "float32" else 2e-2)
    assert_trees_close(ts, js, 2e-5, rel=True)
    assert all(t.dtype == getattr(torch, dtype) for t in tree_leaves(tp))


def test_galore_projection_of_the_port():
    """The port draws its own ``P`` (torch generator seeded ``seed + i``, i
    the leaf's index in sorted-key order, then a QR): orthonormal to 1e-5,
    the same on every call, different for each leaf, and on exactly the
    leaves the reference projects."""
    tp = to_torch(smoke_params(jnp.float32))
    opt = optim.galore_adamw(lr=1e-3, rank=4)
    a, b = opt.init(tp), opt.init(tp)
    Ps = {k: v for k, v in tree_flatten_with_path(a).items() if k.endswith("/P")}
    assert len(Ps) > 2
    for k, P in Ps.items():
        np.testing.assert_allclose(f32(P.T @ P), np.eye(4), atol=1e-5, err_msg=k)
        assert torch.equal(P, tree_flatten_with_path(b)[k])
    first = list(Ps.values())
    assert not torch.equal(first[0][:4], first[1][:4])
    want = tree_flatten_with_path(jax.tree.map(np.asarray, ref_optim.galore_adamw(
        lr=1e-3, rank=4).init(smoke_params(jnp.float32))))
    assert sorted(Ps) == sorted(k for k in want if k.endswith("/P"))


@pytest.mark.parametrize("name", NAMES)
def test_state_checkpoints_load_both_ways(name, tmp_path):
    """A state tree written by one package's ``ckpt/store`` loads in the
    other's, bit for bit (after two updates, so nothing is zero)."""
    jp = smoke_params(jnp.bfloat16)
    ref_opt = ref_optim.make_optimizer(name, 1e-2, **KW[name])
    js = ref_opt.init(jp)
    for step in range(2):
        g = jax.tree.map(lambda a: jnp.full(a.shape, 0.1 * (step + 1), a.dtype), jp)
        jp, js = ref_opt.update(g, js, jp, step)
    jtree = {"params": jp, "opt": js}
    ttree = to_torch(jtree)
    ref_store.save_checkpoint(str(tmp_path / "ref"), 2, jtree)
    got, _ = store.load_checkpoint(str(tmp_path / "ref"), tree_map(torch.zeros_like, ttree),
                                   device="cpu")
    for (k, a), b in zip(tree_flatten_with_path(got).items(),
                         tree_flatten_with_path(ttree).values(), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    store.save_checkpoint(str(tmp_path / "port"), 2, ttree)
    back, _ = ref_store.load_checkpoint(str(tmp_path / "port"), jtree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jtree), strict=True):
        assert a.dtype == b.dtype and np.asarray(a).tobytes() == np.asarray(b).tobytes()


@pytest.mark.parametrize("name", NAMES)
def test_trainer_fit_matches_reference(name):
    """``Trainer.fit`` of 3 steps with a constant lr (the reference's Trainer
    passes a schedule only to AdamW), fp32, from the reference Trainer's
    initial params and optimizer state: losses, grad norms and final
    parameters to 1e-4.  GaLore at lr 1e-3, its reference test's: it is
    Adam on the leaves it does not project, whose ``m̂/(√v̂+eps)`` turns an
    fp32 summation difference of a near-zero gradient into up to a whole
    ``lr`` step (ROADMAP queue C, PR 11)."""
    fp32 = dict(n_layers=8, **{"param_dtype": "float32", "compute_dtype": "float32"})
    cfg = replace(configs.smoke_config("gemma3-1b"), **fp32)
    ref_cfg = replace(ref_configs.smoke_config("gemma3-1b"), **fp32)
    shape = configs.ShapeConfig("t", seq_len=64, global_batch=2, kind="train")
    ref_shape = ref_configs.ShapeConfig("t", seq_len=64, global_batch=2, kind="train")
    lr = 1e-3 if name == "galore_adamw" else 1e-2
    ref_tr = ref_train.Trainer(ref_cfg, ref_shape, optimizer=name, lr=lr)
    jparams, jstate = ref_tr.init_state()
    jparams = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    jstate = ref_tr.opt.init(jparams)
    ref_tr.init_state = lambda: (jparams, jstate)
    tr = train.Trainer(cfg, shape, optimizer=name, lr=lr, device="cpu")
    start = to_torch(jparams), to_torch(jstate)      # the reference's step donates them
    tr.init_state = lambda: start
    want, got = ref_tr.fit(3), tr.fit(3)
    for w, g in zip(want, got, strict=True):
        np.testing.assert_allclose(g["loss"], w["loss"], atol=1e-4)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=1e-4)
    assert_trees_close(tr._last_state[0], ref_tr._last_state[0], 1e-4)


def test_cli_trains_with_adafactor(capsys):
    train.main(["--arch", "gemma3-1b", "--smoke", "--device", "cpu", "--steps", "3",
                "--seq", "64", "--batch", "2", "--optimizer", "adafactor"])
    out = capsys.readouterr().out
    first, last = (float(v) for v in re.search(r"loss (\S+) -> (\S+)", out).groups())
    assert np.isfinite([first, last]).all() and "steps=3" in out


def test_nothing_turns_on_tf32():
    """GaLore's ``P.T @ g`` and every fp32 parity on the card are IEEE fp32
    products (trap T2): neither the port nor ``chip_smoke.py`` enables
    TF32."""
    files = [*sorted((ROOT / "src" / "repro_torch").rglob("*.py")), ROOT / "chip_smoke.py"]
    pattern = re.compile(r"allow_tf32|set_float32_matmul_precision|fp32_precision")
    assert [f.name for f in files if pattern.search(f.read_text())] == []
