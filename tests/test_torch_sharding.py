"""The port's sharding resolvers against the reference's, in-process: the
logical-axis trees of every arch, cache, optimizer and input, their specs
resolved on (16, 16), (2, 16, 16) and (2, 2, 2) (the reference's meshes built
without devices through ``jax.sharding.AbstractMesh``), the reference's own
cases of ``tests/test_sharding.py``, DTensor placements against JAX's block
layout, the elastic mesh's factorisation, and the kernels' ``meta`` routes.
No process group is started here."""

import json
import os
import subprocess
import sys
import textwrap
from collections import namedtuple

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JaxAbstractMesh
from jax.sharding import PartitionSpec as JP
from torch.distributed.tensor._utils import _compute_local_shape_and_global_offset

import repro.configs as ref_configs
import repro.distributed.sharding as ref_sh
import repro.launch.mesh as ref_mesh
from repro.data import pipeline as ref_pipeline
from repro.models import transformer as ref_transformer
from repro.optim import optimizers as ref_optim
import repro_torch.configs as configs
from repro_torch.data import pipeline
from repro_torch.distributed import sharding as sh
from repro_torch.kernels import ops
from repro_torch.launch import mesh as port_mesh
from repro_torch.models import transformer
from repro_torch.optim import optimizers as optim

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
OPTIMIZERS = ("adamw", "sgd_momentum", "adafactor", "galore_adamw")
#: what the port's resolvers read of a mesh, without ranks or devices
Mesh = namedtuple("Mesh", "shape mesh_dim_names")


def meshes(name):
    shape, axes = MESHES[name]
    return Mesh(shape, axes), JaxAbstractMesh(shape, axes)


def ref_axes_flat(tree) -> dict:
    """{path: axes tuple} of a reference tree of ``Ax`` leaves."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, ref_sh.Ax))[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path): tuple(a.axes)
            for path, a in leaves}


def port_axes_flat(tree, prefix="") -> dict:
    if isinstance(tree, sh.Ax):
        return {prefix[:-1]: tuple(tree.axes)}
    out = {}
    for k in sorted(tree):
        out.update(port_axes_flat(tree[k], f"{prefix}{k}/"))
    return out


def axes_trees(arch):
    """(port, reference) trees for the arch: params, caches (the reference's
    with and without its unused shard_kv_seq), the four optimizers' state, each shape's inputs."""
    cfg, rcfg = configs.get_config(arch), ref_configs.get_config(arch)
    p_ax, rp_ax = transformer.param_axes(cfg), ref_transformer.param_axes(rcfg)
    out = {"params": (p_ax, rp_ax)}
    for kv in (False, True):
        out[f"cache kv={kv}"] = (transformer.cache_axes(cfg, 4, 64),
                                 ref_transformer.cache_axes(rcfg, 4, 64, kv))
    for name in OPTIMIZERS:
        port = optim.make_optimizer(name).state_axes(
            sh.map_axes(lambda a: a, p_ax))
        ref = ref_optim.make_optimizer(name).state_axes(rp_ax)
        out[f"state {name}"] = (port, ref)
    for shape in configs.SHAPES:
        out[f"inputs {shape}"] = (pipeline.input_axes(cfg, configs.get_shape(shape)),
                                  ref_pipeline.input_axes(rcfg, ref_configs.get_shape(shape)))
    return out


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_axes_trees_equal_reference(arch):
    """param_axes, cache_axes (against the reference's with and without
    shard_kv_seq), the four
    optimizers' state_axes and input_axes: leaf for leaf the reference's."""
    for what, (port, ref) in axes_trees(arch).items():
        assert port_axes_flat(port) == ref_axes_flat(ref), what


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_resolved_specs_equal_reference(arch, mesh_name):
    """Every leaf's ``pspec`` and shape-pruned ``prune_pspec`` on the mesh:
    entry for entry the reference's (bare names and tuples alike), also
    under long_500k's rules override."""
    pm, jm = meshes(mesh_name)
    cfg, rcfg = configs.get_config(arch), ref_configs.get_config(arch)
    shapes = {**{f"params/{k}": tuple(v.shape) for k, v in
                 _flat_specs(transformer.param_specs(cfg)).items()}}
    trees = axes_trees(arch)
    axes = {f"params/{k}": v for k, v in port_axes_flat(trees["params"][0]).items()}
    for k, v in port_axes_flat(trees["cache kv=True"][0]).items():
        axes[f"cache/{k}"] = v
    for k, s in _flat_specs(transformer.cache_specs(cfg, 4, 64, True)).items():
        shapes[f"cache/{k}"] = tuple(s.shape)
    for over in ({}, {"batch": (), "kv_seq": ("pod", "data", "model")}):
        with sh.rules_override(**over), ref_sh.rules_override(**over):
            for key, a in axes.items():
                got, want = sh.pspec(a, pm), ref_sh.pspec(a, jm)
                assert same_spec(got, want), (key, over)
                got = sh.prune_pspec(shapes[key], got, pm)
                want = ref_sh.prune_pspec(shapes[key], want, jm)
                assert same_spec(got, want), (key, over)
    del rcfg


def same_spec(port, ref) -> bool:
    """Entry for entry, as JAX compares specs (JAX 0.9 takes a one-name
    tuple and the bare name as one entry; the port keeps the reference's
    tuple)."""
    return len(tuple(port)) == len(tuple(ref)) and JP(*port) == ref


def _flat_specs(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix[:-1]: tree}
    out = {}
    for k in sorted(tree):
        out.update(_flat_specs(tree[k], f"{prefix}{k}/"))
    return out


# -- the reference's own cases (tests/test_sharding.py) ---------------------------------

M11 = Mesh((1, 1), ("data", "model"))
J11 = JaxAbstractMesh((1, 1), ("data", "model"))


@pytest.mark.parametrize("axes", [("batch", "seq", "embed_act"), ("embed", "ffn"),
                                  ("batch", "embed"), ("kv_seq", "heads", None)])
def test_pspec_cases(axes):
    """Resolution and de-duplication (a physical axis used once a spec)."""
    got, want = sh.pspec(axes, M11), ref_sh.pspec(axes, J11)
    assert same_spec(got, want)
    flat = [a for p in got if p is not None for a in (p if isinstance(p, tuple) else (p,))]
    assert len(flat) == len(set(flat))


def test_pspec_structure():
    assert sh.pspec(("batch", "seq", "embed_act"), M11) == sh.P(("data",), None, None)
    assert sh.pspec(("embed", "ffn"), M11) == sh.P("data", "model")


def test_rules_override_ctx():
    with sh.rules_override(batch=(), kv_seq=("data",)):
        assert sh.pspec(("batch",), M11) == sh.P(None)
        assert sh.pspec(("kv_seq",), M11) == sh.P("data")
    assert sh.pspec(("batch",), M11) == sh.P(("data",))


@pytest.mark.parametrize("fn", [lambda: sh.pspec(("nonsense",), M11),
                                lambda: sh.rules_override(nonsense=()).__enter__(),
                                lambda: sh.resolve_axes("nonsense", M11)])
def test_unknown_axis_raises(fn):
    with pytest.raises(KeyError):
        fn()


def test_zero_state_axes():
    assert sh.zero_state_axes(sh.ax("embed", "ffn")).axes == \
        ref_sh.zero_state_axes(ref_sh.ax("embed", "ffn")).axes == ("zero", "ffn")


@pytest.mark.parametrize("shape", [(1, 8), (3, 8), (16, 2)])
def test_prune_pspec_cases(shape):
    pm, jm = meshes("2x2x2")
    spec = sh.P(("pod", "data"), "model")
    assert same_spec(sh.prune_pspec(shape, spec, pm),
                     ref_sh.prune_pspec(shape, JP(("pod", "data"), "model"), jm))
    assert sh.prune_pspec((1, 8), sh.P("data", "model"), M11) == sh.P("data", "model")


def test_shardings_for_prunes_indivisible():
    """kv_heads = 1 cannot shard over 'model' = 16: replicated there."""
    pm, _ = meshes("16x16")
    tree = {"w": torch.empty((3, 8), device="meta"), "k": torch.empty((64, 1), device="meta")}
    axes = {"w": sh.ax("embed", "ffn"), "k": sh.ax("embed", "kv_heads")}
    pl = sh.shardings_for(tree, axes, pm)
    R, S = torch.distributed.tensor.Replicate, torch.distributed.tensor.Shard
    assert pl["w"] == (R(), R()) and pl["k"] == (S(0), R())


def test_shard_without_mesh_and_rank_mismatch():
    x = torch.ones(2, 3)
    assert sh.shard(x, "batch", "embed") is x
    with sh.use_mesh(M11), pytest.raises(ValueError, match="rank"):
        sh.shard(x, "batch")


def test_mesh_devices_summary():
    for name in MESHES:
        pm, jm = meshes(name)
        want = {"axis_names": list(jm.axis_names), "shape": list(MESHES[name][0]),
                "n_devices": int(np.prod(MESHES[name][0]))}
        assert sh.mesh_devices_summary(pm) == want


# -- placements against JAX's layout ----------------------------------------------------

LAYOUT_CASES = [((2, 2, 2), ("pod", "data", "model"), (8, 4, 6), (("pod", "data"), None, "model")),
                ((2, 2, 2), ("pod", "data", "model"), (4, 8), ("data", ("pod", "model"))),
                ((2, 4), ("data", "model"), (8, 12), ("model", "data")),
                ((2, 4), ("data", "model"), (8, 8, 3), (("data", "model"), None, None)),
                ((2, 2, 2), ("pod", "data", "model"), (16,), (("pod", "data", "model"),))]

JAX_LAYOUT = textwrap.dedent("""
    import os, json, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    out = []
    for mshape, axes, shape, spec in json.loads(sys.argv[1]):
        spec = [tuple(s) if isinstance(s, list) else s for s in spec]
        n = int(np.prod(mshape))
        mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(mshape), tuple(axes))
        idx = NamedSharding(mesh, P(*spec)).devices_indices_map(tuple(shape))
        out.append({str(d.id): [[s.start or 0, s.stop if s.stop is not None else dim]
                                for s, dim in zip(ix, shape)] for d, ix in idx.items()})
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def jax_layouts():
    """JAX's block of every device for each case, from 8 host devices in a
    subprocess (this process has one)."""
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", JAX_LAYOUT, json.dumps(LAYOUT_CASES)],
                         capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("case", range(len(LAYOUT_CASES)))
def test_placements_match_jax_layout(jax_layouts, case):
    """``placements`` of a spec gives every rank the block JAX gives the
    device at the same mesh coordinate (a dim over two axes: the first named
    is the major split)."""
    mshape, axes, shape, spec = LAYOUT_CASES[case]
    spec = sh.P(*spec)
    pl = sh.placements(spec, Mesh(mshape, axes))
    for rank in range(int(np.prod(mshape))):
        coord = [int(c) for c in np.unravel_index(rank, mshape)]
        local, off = _compute_local_shape_and_global_offset(shape, mshape, coord, pl)
        got = [[o, o + n] for o, n in zip(off, local)]
        assert got == jax_layouts[case][str(rank)], (rank, pl)


def test_placements_refuse_axes_out_of_mesh_order():
    with pytest.raises(ValueError, match="order"):
        sh.placements(sh.P(("model", "data")), Mesh((2, 2), ("data", "model")))


# -- the elastic mesh ------------------------------------------------------------------


def test_best_mesh_for_matches_reference(monkeypatch):
    """The factorisation of n surviving ranks for n = 1 … 512, model_parallel
    1, 2, 16, single- and multi-pod: the reference's (shape, axes)."""
    monkeypatch.setattr(ref_mesh, "make_mesh", lambda shape, axes: (shape, axes))
    monkeypatch.setattr(port_mesh, "make_mesh", lambda shape, axes, device_type: (shape, axes))
    for n in range(1, 513):
        for mp in (1, 2, 16):
            for multi in (False, True):
                assert port_mesh.best_mesh_for(n, mp, multi) == \
                    ref_mesh.best_mesh_for(n, mp, multi), (n, mp, multi)


def test_production_mesh_needs_the_fake_group():
    with pytest.raises(RuntimeError, match="fake"):
        port_mesh.make_production_mesh(multi_pod=True)


# -- the kernels on meta: the plain versions, computing nothing -------------------------


def test_kernel_wrappers_on_meta():
    m = dict(device="meta")
    q = torch.empty(2, 128, 4, 16, **m)
    k = torch.empty(2, 128, 2, 16, **m)
    o, lse = ops.flash_fwd(q, k, k)
    assert o.shape == q.shape and o.is_meta and lse.shape == (2, 4, 128)
    assert lse.dtype == torch.float32
    assert ops.flash_dq(q, k, k, q, lse, lse).shape == q.shape
    dk, dv = ops.flash_dkv(q, k, k, q, lse, lse)
    assert dk.shape == dv.shape == k.shape
    qr = q.clone().requires_grad_(True)
    out = ops.flash_attention(qr, k, k)
    (g,) = torch.autograd.grad(out.sum(), [qr])
    assert g.is_meta and g.shape == q.shape
    x = torch.empty(3, 5, 64, dtype=torch.bfloat16, **m).requires_grad_(True)
    s = torch.empty(64, **m).requires_grad_(True)
    y = ops.rmsnorm(x, s)
    dx, ds = torch.autograd.grad(y.float().sum(), [x, s])
    assert y.shape == x.shape and y.dtype == x.dtype and dx.is_meta and ds.shape == (64,)
    xs = torch.empty(1, 2, 8, 4, 16, **m)
    dts = torch.empty(1, 2, 8, 4, **m)
    bs = torch.empty(1, 2, 8, 1, 32, **m)
    y, st, cum = ops.ssd_chunk_heads(xs, dts, bs, bs, torch.empty(4, **m))
    assert y.shape == xs.shape and st.shape == (1, 2, 4, 32, 16) and cum.shape == dts.shape
    p = torch.empty(4, 4, **m)
    ops.fused_adam_multi([p], [p], [p], [p], torch.empty((), dtype=torch.int32, **m), 1e-3)


@pytest.mark.parametrize("kernel", ["flash", "ssd_chunk"])
def test_kernel_wrappers_on_meta_count_the_plain_flops(kernel):
    """On ``meta`` a wrapper runs its plain version, so a FLOP counter sees
    its products, forward and backward: the count on ``meta`` equals the
    count on the CPU (the dry-run's FLOPs include attention and SSD)."""
    from torch.utils.flop_counter import FlopCounterMode

    def count(device):
        g = torch.Generator().manual_seed(0)
        if kernel == "flash":
            shapes = [(2, 128, 4, 16), (2, 128, 2, 16), (2, 128, 2, 16)]
        else:
            shapes = [(1, 2, 8, 4, 16), (1, 2, 8, 4), (1, 2, 8, 1, 32), (1, 2, 8, 1, 32), (4,)]
        ts = [torch.randn(s, generator=g).to(device).requires_grad_(True) for s in shapes]
        with FlopCounterMode(display=False) as fc:
            out = (ops.flash_attention(*ts) if kernel == "flash"
                   else ops.ssd_chunk_heads(*ts)[0])
            torch.autograd.grad(out.sum(), ts[:1])
        return fc.get_total_flops()

    assert count("meta") == count("cpu") > 0


def test_abstract_params_and_input_specs_are_meta():
    cfg = configs.get_config("gemma3-1b")
    ap = transformer.abstract_params(cfg)
    leaves = _flat_specs(ap)
    specs = _flat_specs(transformer.param_specs(cfg))
    assert all(v.is_meta and tuple(v.shape) == specs[k].shape for k, v in leaves.items())
    for shape in configs.SHAPES:
        rs = ref_pipeline.input_specs(ref_configs.get_config("gemma3-1b"),
                                      ref_configs.get_shape(shape))
        ps = pipeline.input_specs(cfg, configs.get_shape(shape))
        assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                for k, v in ps.items()} == {k: (tuple(v.shape), str(v.dtype))
                                            for k, v in rs.items()}
