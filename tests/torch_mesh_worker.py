"""The port's multi-rank and fake-process-group checks, run in subprocesses
by ``tests/test_torch_distributed.py`` and ``tests/test_torch_dryrun.py``
(a process group is global to a process, and the tests run under xdist, so
no test process starts one).

    python tests/torch_mesh_worker.py RANK WORLD WORKDIR
    python tests/torch_mesh_worker.py dryrun smoke|full

Every rank joins a ``gloo`` group through a ``FileStore`` in WORKDIR (no
port to pick), reads the reference weights the test wrote there
(``<name>.npz``), trains on the meshes (2, 2) ('data', 'model') and
(2, 2, 1) ('pod', 'data', 'model') and on no mesh, and rank 0 writes what
the test holds to WORKDIR/result.npz and one JSON line to stdout.  Imports
the port only.
"""

from __future__ import annotations

import json
import os
import sys
import time
from dataclasses import replace
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor.experimental import implicit_replication

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.ckpt import store  # noqa: E402
from repro_torch.configs import ShapeConfig, smoke_config  # noqa: E402
from repro_torch.convert import (from_reference, tree_flatten_with_path,  # noqa: E402
                                 tree_leaves, tree_map)
from repro_torch.data.pipeline import input_axes, make_batch  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.transformer import (cache_axes, decode_step,  # noqa: E402
                                            init_cache, param_axes)
from repro_torch.optim import optimizers as optim  # noqa: E402
from repro_torch.training import train_step as ts  # noqa: E402

SHAPE = ShapeConfig("t", seq_len=128, global_batch=4, kind="train")
STEPS = 3
LR = 1e-3
FP32 = dict(param_dtype="float32", compute_dtype="float32", use_flash=True)
MESHES = {"dm": ((2, 2), ("data", "model")), "pdm": ((2, 2, 1), ("pod", "data", "model"))}


def configs() -> dict:
    """name → the port's config; the test builds the reference's alike."""
    gemma = replace(smoke_config("gemma3-1b"), **FP32)
    mamba = smoke_config("mamba2-1.3b")
    return {
        "gemma3": replace(gemma, remat="dots"),
        # chunk 32: at 128 the reference's SSD gradients are NaN (it
        # exponentiates before it masks; docs/torch_port.md)
        "mamba2": replace(mamba, ssm=replace(mamba.ssm, chunk=32), **FP32),
        "olmoe": replace(smoke_config("olmoe-1b-7b"), **FP32),
        "h6kv3": replace(gemma, n_heads=6, n_kv_heads=3),
    }


def unflatten(flat) -> dict:
    """{'a/b': array} → nested dicts (with the parameter tree's ``rem``,
    empty when the layers divide into periods)."""
    out: dict = {"rem": {}}
    for key in flat.files:
        *path, leaf = key.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = flat[key]
    return out


def whole_tree(tree) -> dict:
    return {k: sh.whole(v).detach().clone() for k, v in tree_flatten_with_path(tree).items()}


def place_tree(tree, axes, mesh):
    pl = sh.shardings_for(tree, axes, mesh)
    return tree_map(lambda t, p: sh.distribute(t, mesh, p), tree, pl)


def run_steps(cfg, params, mesh, steps=STEPS, opt=None) -> dict:
    """``steps`` AdamW steps from ``params`` (whole tensors); records each
    step's loss, grad norm and (unclipped, whole) gradients, and the final
    parameters and moments, all whole."""
    opt = opt or optim.adamw(optim.warmup_cosine(LR))
    params = tree_map(lambda t: t.clone(), params)
    state = opt.init(params)
    if mesh is not None:
        p_ax = param_axes(cfg)
        params = place_tree(params, p_ax, mesh)
        state = place_tree(state, opt.state_axes(p_ax), mesh)
    grads_seen = []
    clip = ts.clip_by_global_norm

    def recording(grads, max_norm):
        grads_seen.append(whole_tree(grads))
        return clip(grads, max_norm)

    step_fn = ts.make_train_step(cfg, opt)
    out = {"loss": [], "grad_norm": [], "grads": grads_seen}
    with mock.patch.object(ts, "clip_by_global_norm", recording), sh.use_mesh(mesh):
        for step in range(steps):
            batch = make_batch(cfg, SHAPE, step, device="cpu")
            if mesh is not None:
                batch = place_tree(batch, input_axes(cfg, SHAPE), mesh)
            params, state, m = step_fn(params, state, batch, step)
            out["loss"].append(float(m["loss"]))
            out["grad_norm"].append(float(m["grad_norm"]))
    out["params"] = whole_tree(params)
    out["m"] = whole_tree(state["m"])
    if mesh is not None:
        out["m_local_shape"] = {k: tuple(v.to_local().shape)
                                for k, v in tree_flatten_with_path(state["m"]).items()}
        out["p_local_shape"] = {k: tuple(v.to_local().shape)
                                for k, v in tree_flatten_with_path(params).items()}
    return out


def max_err(a: dict, b: dict) -> float:
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in a)


def run_errs(got, want) -> dict:
    """Largest difference of each recorded quantity, sharded against not."""
    return {"loss": max(abs(x - y) for x, y in zip(got["loss"], want["loss"], strict=True)),
            "grads": max(max_err(g, w) for g, w in zip(got["grads"], want["grads"],
                                                        strict=True)),
            "params": max_err(got["params"], want["params"]),
            "m": max_err(got["m"], want["m"])}


def main() -> None:
    rank, world, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(workdir, "store"), world),
                            rank=rank, world_size=world)
    t0 = time.time()
    res: dict = {"errs": {}, "faults": {}, "checks": {}}
    arrays: dict = {}
    try:
        cfgs = configs()
        params = {n: from_reference(unflatten(np.load(os.path.join(workdir, f"{n}.npz"))),
                                    "cpu") for n in cfgs}
        meshes = {n: make_mesh(shape, axes, "cpu") for n, (shape, axes) in MESHES.items()}

        # -- train steps: no mesh, and each mesh, for every config
        for name, cfg in cfgs.items():
            base = run_steps(cfg, params[name], None)
            for k in ("loss", "grad_norm"):
                arrays[f"{name}/none/{k}"] = np.asarray(base[k])
            for s, g in enumerate(base["grads"]):
                for k, v in g.items():
                    arrays[f"{name}/none/grad{s}/{k}"] = v.numpy()
            for k, v in base["params"].items():
                arrays[f"{name}/none/params/{k}"] = v.numpy()
            for mname, mesh in meshes.items():
                got = run_steps(cfg, params[name], mesh)
                res["errs"][f"{name}/{mname}"] = run_errs(got, base)
                for s, g in enumerate(got["grads"]):
                    for k, v in g.items():
                        arrays[f"{name}/{mname}/grad{s}/{k}"] = v.numpy()
                arrays[f"{name}/{mname}/loss"] = np.asarray(got["loss"])
                if mname == "pdm":
                    res["checks"]["zero_m_shape"] = got["m_local_shape"]
                    res["checks"]["zero_p_shape"] = got["p_local_shape"]

        # -- trap S: other remat policies on the mesh against no mesh
        gemma = cfgs["gemma3"]
        for policy in ("save:mlp_hidden,qkv", "full"):
            c = replace(gemma, remat=policy)
            res["errs"][f"remat {policy}/dm"] = run_errs(
                run_steps(c, params["gemma3"], meshes["dm"], steps=1),
                run_steps(c, params["gemma3"], None, steps=1))

        # -- sharded embedding and sequence-sharded activations
        c = replace(gemma, sharded_embed=True, seq_sharded_acts=True)
        for mname in ("dm", "pdm"):
            res["errs"][f"embed+sp/{mname}"] = run_errs(
                run_steps(c, params["gemma3"], meshes[mname], steps=1),
                run_steps(c, params["gemma3"], None, steps=1))
        res["checks"]["embed"] = embed_check(meshes["dm"])

        # -- decode on a kv_seq-sharded cache
        for name in ("gemma3", "mamba2"):
            res["errs"][f"decode {name}/dm"] = decode_check(cfgs[name], params[name],
                                                            meshes["dm"])

        # -- checkpoints across meshes
        res["checks"]["ckpt"] = ckpt_check(cfgs["gemma3"], params["gemma3"], meshes,
                                           os.path.join(workdir, "ckpt"))

        # -- the trainer's mesh path: checkpoints, a node failure, the elastic mesh
        res["checks"]["trainer"] = trainer_check(cfgs["gemma3"], meshes["dm"],
                                                 os.path.join(workdir, "trainer"))

        # -- the CLI's --mesh path, beside the same run on no mesh
        res["checks"]["cli"] = cli_check()

        # -- planted faults, one a trap; each must read above tolerance
        res["faults"] = planted_faults(cfgs, params, meshes)
        res["seconds"] = time.time() - t0
        if rank == 0:
            np.savez(os.path.join(workdir, "result.npz"), **arrays)
            print(json.dumps(res), flush=True)
    finally:
        dist.destroy_process_group()


def embed_check(mesh) -> dict:
    """``embed_lookup`` vocab-sharded ≡ the plain gather, values and the
    table's gradient."""
    gen = torch.Generator().manual_seed(0)
    table = torch.randn((64, 16), generator=gen)
    toks = torch.randint(0, 64, (4, 8), generator=gen, dtype=torch.int32)
    plain_t = table.clone().requires_grad_(True)
    plain = layers.embed_lookup(plain_t, toks)
    plain.square().sum().backward()
    pl = sh.placements(sh.P("model", "data"), mesh)
    dt = sh.distribute(table, mesh, pl).requires_grad_(True)
    with sh.use_mesh(mesh), implicit_replication():
        dtok = sh.distribute(toks, mesh, sh.placements(sh.P(("data",)), mesh))
        got = layers.embed_lookup(dt, dtok, enabled=True)
        got = sh.shard(got, "batch", "seq", "embed_act")
        sh.whole(got).square().sum().backward()
    return {"value": float((sh.whole(got).detach() - plain).abs().max()),
            "grad": float((sh.whole(dt.grad) - plain_t.grad).abs().max())}


def decode_check(cfg, params, mesh, steps=12) -> float:
    """Greedy decode on the mesh (the cache's kv_seq over 'model') against
    no mesh: the largest logit difference over ``steps`` tokens."""
    B, T = 4, 16
    toks = torch.from_numpy(np.arange(B * steps, dtype=np.int32).reshape(B, steps) % cfg.vocab)
    cache = init_cache(cfg, B, T, device="cpu")
    with torch.inference_mode():
        want = [decode_step(params, cache, cfg, toks[:, i:i + 1], i)[0] for i in range(steps)]
    dparams = place_tree(params, param_axes(cfg), mesh)
    dcache = place_tree(init_cache(cfg, B, T, device="cpu"), cache_axes(cfg, B, T), mesh)
    err = 0.0
    with sh.use_mesh(mesh), implicit_replication(), torch.no_grad():
        for i in range(steps):
            tok = sh.distribute(toks[:, i:i + 1], mesh, sh.placements(sh.P(("data",)), mesh))
            logits = sh.whole(decode_step(dparams, dcache, cfg, tok, i)[0])
            err = max(err, float((logits - want[i]).abs().max()))
    return err


def ckpt_check(cfg, params, meshes, path) -> dict:
    """A state written on one mesh restores bit for bit onto the other and
    onto no mesh; the files equal an unsharded save's."""
    opt = optim.adamw(optim.warmup_cosine(LR))
    tree = {"params": params, "opt": opt.init(params)}
    p_ax = param_axes(cfg)
    axes = {"params": p_ax, "opt": opt.state_axes(p_ax)}
    placed = place_tree(tree, axes, meshes["dm"])
    store.save_checkpoint(os.path.join(path, "mesh"), 1, placed)
    store.save_checkpoint(os.path.join(path, "plain"), 1, tree)
    dist.barrier()
    out = {}
    a = np.load(os.path.join(path, "mesh", "step_00000001", "arrays.npz"))
    b = np.load(os.path.join(path, "plain", "step_00000001", "arrays.npz"))
    out["files_equal"] = sorted(a.files) == sorted(b.files) and all(
        np.array_equal(a[k], b[k]) for k in a.files)
    other = place_tree(tree, axes, meshes["pdm"])
    back, _ = store.load_checkpoint(os.path.join(path, "mesh"), other, device="cpu")
    out["onto_other_mesh"] = all(
        isinstance(x, torch.distributed.tensor.DTensor) and x.placements == y.placements
        and torch.equal(sh.whole(x), sh.whole(y)) for x, y in zip(tree_leaves(back),
                                                                   tree_leaves(other),
                                                                   strict=True))
    plain, _ = store.load_checkpoint(os.path.join(path, "mesh"), tree, device="cpu")
    out["onto_no_mesh"] = all(torch.equal(x, y) for x, y in zip(tree_leaves(plain),
                                                                tree_leaves(tree), strict=True))
    return out


def trainer_check(cfg, mesh, path) -> dict:
    """``Trainer.fit`` on the mesh, 4 steps with a checkpoint every 2 and a
    node failure injected at step 3 (restored from step 2 onto the mesh
    ``best_mesh_for(4)`` builds), against the same run on no mesh."""
    from repro_torch.launch import train

    init = train.init_params
    fp32 = lambda *a: tree_map(lambda t: t.float(), init(*a))   # noqa: E731  (as the reference tests do)
    kw = dict(batch_override=SHAPE.global_batch, seq_override=SHAPE.seq_len)
    with mock.patch.object(train, "init_params", fp32):
        plain = train.Trainer(cfg, SHAPE, device="cpu").fit(4, **kw)
        tr = train.Trainer(cfg, SHAPE, device="cpu", mesh=mesh, ckpt_dir=path, ckpt_every=2)
        logs = tr.fit(4, inject_failure_at=3, **kw)
    tr.ckpt.close()
    want = {log["step"]: log["loss"] for log in plain}
    return {"loss_err": max(abs(log["loss"] - want[log["step"]]) for log in logs),
            "failures": tr.failures, "steps": [log["step"] for log in logs],
            "mesh_after": [list(tr.mesh.mesh_dim_names), list(tr.mesh.shape)],
            "params_placed": all(isinstance(t, torch.distributed.tensor.DTensor)
                                 for t in tree_leaves(tr._last_state[0]))}


def cli_check() -> dict:
    """``launch.train.main`` with ``--mesh 2,2`` (it joins this process's
    group and leaves it standing) and without: the line each prints."""
    import contextlib
    import io

    from repro_torch.launch import train

    argv = ["--arch", "gemma3-1b", "--smoke", "--device", "cpu", "--steps", "2",
            "--batch", "4", "--seq", "128"]
    out = {}
    for name, extra in (("mesh", ["--mesh", "2,2"]), ("none", [])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            train.main(argv + extra)
        out[name] = buf.getvalue().strip()
    out["group_alive"] = dist.is_initialized()
    return out


def planted_faults(cfgs, params, meshes) -> dict:
    """R: the rmsnorm ``scale``'s gradient left unreduced (each rank's
    partial sum taken as the whole); G: the local q heads grouped onto the
    local kv heads as if whole; Z: the ZeRO update left on the state's
    placement (p never gets it).  Each one step; the largest difference
    from the same step on no mesh."""
    out = {}
    gemma, h6 = cfgs["gemma3"], cfgs["h6kv3"]
    with mock.patch.object(sh, "grad_placements", lambda pls: tuple(pls)):
        out["R"] = run_errs(run_steps(gemma, params["gemma3"], meshes["dm"], steps=1),
                            run_steps(gemma, params["gemma3"], None, steps=1))
    with mock.patch.object(ops, "kv_heads_for", lambda h0, h_loc, group: slice(None)):
        out["G"] = run_errs(run_steps(h6, params["h6kv3"], meshes["dm"], steps=1),
                            run_steps(h6, params["h6kv3"], None, steps=1))
    const = optim.adamw(LR)           # no warm-up: an update of ~LR to miss
    with mock.patch.object(optim, "zero_write_back", lambda p, pz: None):
        z = run_steps(gemma, params["gemma3"], meshes["pdm"], steps=1, opt=const)
    out["Z"] = run_errs(z, run_steps(gemma, params["gemma3"], None, steps=1, opt=const))
    return out


DRY_CELLS = (("gemma3-1b", "train_4k"), ("mamba2-1.3b", "decode_32k"),
             ("jamba-1.5-large-398b", "long_500k"))
#: smoke cells on (data, model) = (2, 4) whose heads or groups do not divide
#: 'model' while the fused dim they are split from does, as the production
#: meshes' 40 MLA heads, 8 kv heads and mamba2's 2 B/C groups on 'model' = 16
UNEVEN_CELLS = (("minicpm3-4b", "train_4k", {"n_heads": 6, "n_kv_heads": 6}),
                ("mamba2-1.3b", "train_4k", {}),
                ("nemotron-4-340b", "decode_32k", {"n_heads": 12, "n_kv_heads": 6}))


def dryrun(size: str) -> None:
    """The three cells of the reference's mini dry-run on a fake (2, 2, 2)
    ('pod', 'data', 'model') group of 8 ranks (this process rank 0), at the
    smoke configs or at full size; at the smoke size also ``UNEVEN_CELLS`` on
    (2, 4) and, on the same group, the kernel wrappers' refusals of placements they cannot take and the collective
    recorder on one known redistribution.  One JSON line."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.configs import get_config
    from repro_torch.launch.cell import CollectiveRecorder, lower_cell, meta_dtensor
    from repro_torch.launch.dryrun import start_fake_group

    start_fake_group(8)
    out: dict = {"cells": {}, "uneven": {}, "refusals": {}}

    def lower(key, arch, shape, mesh, cfg):
        res, comm = lower_cell(arch, shape, mesh, {"_cfg": replace(cfg, use_flash=True)})
        out[key][f"{arch}:{shape}"] = {**res.to_json(), "comm_counts": sum(
            (comm or {}).values())}

    try:
        mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
        for arch, shape in DRY_CELLS:
            lower("cells", arch, shape, mesh,
                  smoke_config(arch) if size == "smoke" else get_config(arch))
        if size != "smoke":
            return
        mesh24 = make_mesh((2, 4), ("data", "model"), "cpu")
        for arch, shape, over in UNEVEN_CELLS:
            lower("uneven", arch, shape, mesh24, replace(smoke_config(arch), **over))

        def dt(shape, pl, dtype=torch.float32):
            return meta_dtensor(torch.empty(shape, dtype=dtype, device="meta"), mesh, pl)

        R, S = Replicate(), Shard
        q = dt((4, 128, 4, 16), (S(0), R, S(1)))            # seq sharded: refused
        k = dt((4, 128, 2, 16), (S(0), R, R))
        x = dt((4, 8, 64), (R, R, S(2)))                     # the normalised dim
        w = dt((64,), (R, R, R))
        p = dt((8, 8), (S(0), R, R))
        g = dt((8, 8), (Partial(), R, R))
        cases = {"flash": lambda: ops.flash_attention(q, k, k),
                 "rmsnorm": lambda: ops.rmsnorm(x, w),
                 "ssd_chunk": lambda: ops.ssd_chunk_heads(
                     dt((4, 2, 8, 4, 16), (R, S(2), R)), dt((4, 2, 8, 4), (R, R, R)),
                     dt((4, 2, 8, 1, 16), (R, R, R)), dt((4, 2, 8, 1, 16), (R, R, R)),
                     dt((4,), (R, R, R))),
                 "fused_adam": lambda: ops.fused_adam_multi([p], [g], [p], [p],
                                                            dt((), (R, R, R)), 1e-3)}
        for name, call in cases.items():
            try:
                call()
                out["refusals"][name] = ""
            except ValueError as e:
                out["refusals"][name] = str(e)
        # one all-gather of a (64, 32) fp32 tensor sharded over 'data' (2 ranks)
        rec = CollectiveRecorder()
        with rec:
            dt((64, 32), (R, S(0), R)).full_tensor()
        out["recorder"] = {"bytes": rec.bytes, "n": rec.n}
    finally:
        print(json.dumps(out), flush=True)
        dist.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1] == "dryrun":
        dryrun(sys.argv[2])
    else:
        main()
