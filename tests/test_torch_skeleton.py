"""The port's skeleton: import isolation, configs equal to the reference's,
tree conversion, bit-identical batches, device policy."""

import ast
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro_torch
import repro_torch.configs as configs
from repro.data.pipeline import make_batch as ref_make_batch
from repro_torch.convert import (from_reference, to_reference, tree_flatten_with_path,
                                 tree_leaves)
from repro_torch.data.pipeline import SyntheticDataset, make_batch

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")


def test_import_isolation():
    """Importing the port and every one of its modules (the distribution and
    dry-run modules, the copied analytic core with its tracer, its search
    layer, its parallel / resilience / serving / DSE / fault-injection modules
    and the two MONET command lines among them) loads neither jax nor
    anything of the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'repro' or m.startswith('repro.') or m == 'jaxlib']\n"
        "assert len(names) >= 70, names\n"
        "need = {'repro_torch.distributed.sharding', 'repro_torch.launch.mesh', "
        "'repro_torch.launch.cell', 'repro_torch.launch.dryrun', "
        "'repro_torch.launch.ac_search', 'repro_torch.launch.serve', 'repro_torch.verify'} "
        "| {'repro_torch.core.' + m "
        "for m in ('graph', 'accelerators', 'cost_model', 'training_transform', 'memory', "
        "'engine', 'verify', 'scheduling', 'trace', 'nsga2', 'builders', 'zoo', 'fusion', "
        "'fusion_search', 'checkpointing', 'batch', 'parallel', 'resilience', 'serving', "
        "'dse', 'faultinject')}\n"
        "assert need <= set(names), need - set(names)\n"
        "assert not bad, bad\n"
        "print('ok', len(names))\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def _imported_roots(path):
    tree = ast.parse(open(path).read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_source_imports_jax_or_repro():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, fs in os.walk(os.path.join(SRC, "repro_torch")):
        files += [os.path.join(d, f) for f in fs if f.endswith(".py")]
    assert len(files) > 30
    for f in files:
        assert not _imported_roots(f) & {"jax", "jaxlib", "repro", "flax", "optax"}, f


def test_port_never_calls_library_attention():
    for d, _, fs in os.walk(os.path.join(SRC, "repro_torch")):
        for f in fs:
            if f.endswith((".py", ".cu", ".cuh")):
                text = open(os.path.join(d, f)).read()
                assert "scaled_dot_product_attention" not in text, f
                assert "torch.compile" not in text, f


@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_config_equals_reference(arch):
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS
    for get, ref_get in ((configs.get_config, ref_configs.get_config),
                         (configs.smoke_config, ref_configs.smoke_config)):
        mine, ref = get(arch), ref_get(arch)
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine.scan_period() == ref.scan_period()
        assert mine.layer_specs() == [tuple(s) for s in ref.layer_specs()]
        assert mine.param_count() == ref.param_count()
        assert mine.head_dim_ == ref.head_dim_


def test_shapes_and_cells_equal_reference():
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref_configs.SHAPES.items()}
    assert configs.all_cells() == ref_configs.all_cells()
    assert configs.get_config("gemma3-1b").__class__.__module__ == "repro_torch.configs.base"


def test_convert_roundtrip_bit_exact():
    rng = np.random.default_rng(0)
    tree = {
        "params": {"w": jnp.asarray(rng.standard_normal((5, 7)), jnp.bfloat16),
                   "scale": jnp.asarray(rng.standard_normal((7,)), jnp.float32)},
        "opt": {"count": jnp.asarray(3, jnp.int32),
                "m": {"w": jnp.asarray(rng.standard_normal((5, 7)), jnp.float32)}},
    }
    np_tree = jax.tree.map(np.asarray, tree)
    t = from_reference(np_tree, "cpu")
    assert t["params"]["w"].dtype == torch.bfloat16
    assert t["params"]["scale"].dtype == torch.float32
    assert t["opt"]["count"].dtype == torch.int32 and t["opt"]["count"].dim() == 0
    # values survive, not only bits: bf16 -> fp32 is exact on both sides
    np.testing.assert_array_equal(t["params"]["w"].float().numpy(),
                                  np_tree["params"]["w"].astype(np.float32))
    back = to_reference(t)
    for (ka, a), (kb, b) in zip(tree_flatten_with_path(np_tree).items(),
                                tree_flatten_with_path(back).items(), strict=True):
        assert ka == kb and a.dtype == b.dtype and a.shape == b.shape, ka
        assert a.tobytes() == b.tobytes(), ka
    # the reference can take the result back as jax arrays
    again = jax.tree.map(jnp.asarray, back)
    assert again["params"]["w"].dtype == jnp.bfloat16


def test_tree_order_is_the_references():
    tree = {"b": {"y": 1, "x": 2}, "a": 3, "c": {"0": 4, "10": 5, "2": 6}}
    assert tree_leaves(tree) == jax.tree.leaves(tree)


@pytest.mark.parametrize("arch,step,seed", [("gemma3-1b", 0, 0), ("gemma3-1b", 7, 3),
                                            ("musicgen-medium", 2, 1),
                                            ("internvl2-26b", 0, 0)])
def test_make_batch_bit_identical(arch, step, seed):
    cfg, ref_cfg = configs.smoke_config(arch), ref_configs.smoke_config(arch)
    shape = configs.ShapeConfig("t", seq_len=64, global_batch=4, kind="train")
    mine = make_batch(cfg, shape, step, seed, device="cpu")
    ref = ref_make_batch(ref_cfg, shape, step, seed)
    for key in ("inputs", "labels"):
        r = np.asarray(ref[key])
        m = to_reference({"x": mine[key]})["x"]
        assert m.dtype == r.dtype and m.shape == r.shape, key
        assert m.tobytes() == r.tobytes(), key
    if cfg.input_mode == "embeddings":
        assert mine["inputs"].dtype == torch.bfloat16


def test_dataset_resumes_exactly():
    cfg = configs.smoke_config("gemma3-1b")
    shape = configs.ShapeConfig("t", seq_len=32, global_batch=2, kind="train")
    ds = SyntheticDataset(cfg, shape, seed=5, device="cpu")
    batches = [next(ds) for _ in range(4)]
    ds2 = SyntheticDataset.from_state(cfg, shape, {"step": 2, "seed": 5}, device="cpu")
    assert torch.equal(next(ds2)["inputs"], batches[2]["inputs"])
    assert ds.state() == {"step": 4, "seed": 5}


def test_entry_points_default_to_cuda_and_raise_without_it():
    """No silent CPU fallback: the default device is the GPU."""
    if torch.cuda.is_available():
        assert repro_torch.resolve_device().type == "cuda"
        return
    from repro_torch.launch.train import Trainer
    from repro_torch.models.transformer import init_params
    cfg = configs.smoke_config("gemma3-1b")
    shape = configs.ShapeConfig("t", seq_len=32, global_batch=2, kind="train")
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_batch(cfg, shape, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cfg, shape)
    assert repro_torch.resolve_device("cpu").type == "cpu"
