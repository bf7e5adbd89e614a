#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py                 # every phase; needs one CUDA device
    python3 chip_smoke.py --phases env,build,kernels
    python3 chip_smoke.py --profile       # adds one profiled training step

Phases, each printing one JSON line:
  env      versions, device name, power limit
  build    compiles the CUDA kernels from src/repro_torch/kernels/csrc
  kernels  each kernel against its plain PyTorch version on the card: fp32 at
           small shapes, bf16 at the training shapes; times each kernel, its
           plain version and the library call, and computes its bound
  train    Trainer.fit on full-width, full-depth gemma3-1b at S=4096 through
           the flash kernels; checks losses, launch counts and the checkpoint
  parity   kernel path == dense path (loss and grads) on a small fp32 model
Then the ``{"kernels": [...]}`` line, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``.  Any failure raises: the exit code is
non-zero and the last line is not printed.  There is no CPU fallback.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import replace

import numpy as np
import torch
import torch.nn.functional as F

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False")

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.ckpt.store import latest_step, load_checkpoint  # noqa: E402
from repro_torch.configs import get_config, get_shape, smoke_config  # noqa: E402
from repro_torch.convert import tree_flatten_with_path, tree_map  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch.train import Trainer  # noqa: E402
from repro_torch.models.transformer import init_params  # noqa: E402
from repro_torch.training.loss import lm_loss  # noqa: E402

DEV = "cuda"
PEAK_FLOPS = 989e12      # H100 SXM, dense bf16 tensor cores (data sheet)
PEAK_BYTES = 3.35e12     # H100 SXM, HBM3 (data sheet)
TRAIN_STEPS = 6
TRAIN_BATCH = 4
SEQ = 4096

KERNELS = {
    "flash_fwd": {"route": "cuda",
                  "source": "src/repro_torch/kernels/csrc/flash_fwd.cu",
                  "replaces": "src/repro/kernels/flash_attention.py:100"},
    "flash_dq": {"route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/flash_dq.cu",
                 "replaces": "src/repro/kernels/flash_attention.py:209"},
    "flash_dkv": {"route": "cuda",
                  "source": "src/repro_torch/kernels/csrc/flash_dkv.cu",
                  "replaces": "src/repro/kernels/flash_attention.py:227"},
}


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


# ---------------------------------------------------------------------------
# env, build
# ---------------------------------------------------------------------------


def phase_env() -> None:
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    nvcc = subprocess.run([build.find_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    emit("env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, triton=triton_version, nvcc=nvcc,
         device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count(), nvidia_smi=smi())


def phase_build() -> None:
    build.load_library(build.SOURCES[0])      # builds and loads all of them
    info = build.BUILD_INFO
    emit("build", seconds=round(info["seconds"], 2), built=info["built"],
         libraries={n: os.path.relpath(p, ROOT) for n, p in info["paths"].items()},
         ptxas=info.get("ptxas"))


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def make_inputs(seed, B, S, T, H, Kv, hd, dtype):
    rng = np.random.default_rng(seed)

    def t(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                                ).to(DEV).to(dtype)
    return t((B, S, H, hd)), t((B, T, Kv, hd)), t((B, T, Kv, hd)), t((B, S, H, hd))


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def close(a, b, tol) -> bool:
    """|a − b| <= tol + tol·|b| elementwise, as tests/test_kernels.py asks."""
    return bool(torch.allclose(a.float(), b.float(), atol=tol, rtol=tol))


def check_case(case, dtype, tol_fwd, tol_grad, seed) -> dict:
    """All three kernels against their plain versions on the same inputs.
    The backward kernels and their plain versions both get the plain
    forward's ``lse`` and ``delta``, so each comparison stands alone."""
    B, S, T, H, Kv, hd, causal, window = case
    q, k, v, do = make_inputs(seed, B, S, T, H, Kv, hd, dtype)
    o, lse = fa.flash_fwd_cuda(q, k, v, causal, window)
    o_p, lse_p = fa.flash_fwd_plain(q, k, v, causal, window)
    delta = ops.attention_delta(o_p, do)
    dq = fa.flash_dq_cuda(q, k, v, do, lse_p, delta, causal, window)
    dq_p = fa.flash_dq_plain(q, k, v, do, lse_p, delta, causal, window)
    dk, dv = fa.flash_dkv_cuda(q, k, v, do, lse_p, delta, causal, window)
    dk_p, dv_p = fa.flash_dkv_plain(q, k, v, do, lse_p, delta, causal, window)
    torch.cuda.synchronize()
    pairs = {"flash_fwd": [(o, o_p, tol_fwd), (lse, lse_p, tol_fwd)],
             "flash_dq": [(dq, dq_p, tol_grad)],
             "flash_dkv": [(dk, dk_p, tol_grad), (dv, dv_p, tol_grad)]}
    errs = {}
    for name, lst in pairs.items():
        for a, b, tol in lst:
            if not torch.isfinite(a.float()).all():
                raise AssertionError(f"{name}: non-finite output at {case} {dtype}")
            if not close(a, b, tol):
                raise AssertionError(
                    f"{name} disagrees with its plain version at {case} {dtype}: "
                    f"max abs err {max_err(a, b):.3e}, tol {tol}")
        errs[name] = max(max_err(a, b) for a, b, _ in lst)
    return errs


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` by CUDA events over ``reps`` calls after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def visible_entries(B, S, T, H, causal, window) -> int:
    """Score entries that the mask leaves, over all batches and heads."""
    qpos = np.arange(S, dtype=np.int64) + (T - S)
    hi = np.minimum(qpos, T - 1) if causal else np.full(S, T - 1)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(S, np.int64)
    return int(B * H * np.maximum(hi - lo + 1, 0).sum())


def bounds(B, S, T, H, Kv, hd, causal, window, itemsize) -> dict:
    """Least time the card could take: max(FLOPs / peak, bytes / rate).
    Products per visible score entry, 2·hd FLOPs each: forward s and p·v (2);
    dq s, dp and ds·k (3); dk/dv s, dp, pᵀ·do and dsᵀ·q (4).  Bytes: each
    input read once and each output written once."""
    n = visible_entries(B, S, T, H, causal, window)
    qb, kb = B * S * H * hd * itemsize, B * T * Kv * hd * itemsize
    rows = B * H * S * 4
    work = {"flash_fwd": (2 * 2 * hd * n, 2 * qb + 2 * kb + rows),
            "flash_dq": (3 * 2 * hd * n, 3 * qb + 2 * kb + 2 * rows),
            "flash_dkv": (4 * 2 * hd * n, 2 * qb + 4 * kb + 2 * rows)}
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        out[name] = {"bound_ms": max(t_ops, t_bytes),
                     "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                     "flops": flops, "bytes": nbytes}
    return out


def time_case(case, dtype, reps) -> dict:
    """ms of each kernel, of its plain version and of the library call
    (``F.scaled_dot_product_attention`` forward / autograd backward; a
    yardstick only — the port never calls it)."""
    B, S, T, H, Kv, hd, causal, window = case
    q, k, v, do = make_inputs(7, B, S, T, H, Kv, hd, dtype)
    o, lse = fa.flash_fwd_cuda(q, k, v, causal, window)
    delta = ops.attention_delta(o, do)
    bw = (q, k, v, do, lse, delta, causal, window)
    ms = {"flash_fwd": time_ms(lambda: fa.flash_fwd_cuda(q, k, v, causal, window), reps),
          "flash_dq": time_ms(lambda: fa.flash_dq_cuda(*bw), reps),
          "flash_dkv": time_ms(lambda: fa.flash_dkv_cuda(*bw), reps)}
    plain = {"flash_fwd": time_ms(lambda: fa.flash_fwd_plain(q, k, v, causal, window), 2),
             "flash_dq": time_ms(lambda: fa.flash_dq_plain(*bw), 2),
             "flash_dkv": time_ms(lambda: fa.flash_dkv_plain(*bw), 2)}

    # library: (B,H,S,hd) layout, K/V repeated over the GQA group beforehand
    G = H // Kv
    ql = q.transpose(1, 2).contiguous().requires_grad_(True)
    kl = k.repeat_interleave(G, dim=2).transpose(1, 2).contiguous().requires_grad_(True)
    vl = v.repeat_interleave(G, dim=2).transpose(1, 2).contiguous().requires_grad_(True)
    dol = do.transpose(1, 2).contiguous()
    if window is None:
        kw = {"is_causal": causal}
    else:
        kw = {"attn_mask": fa.attention_mask(S, T, causal, window, q.device)}
    lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(ql, kl, vl, **kw), reps)
    ol = F.scaled_dot_product_attention(ql, kl, vl, **kw)
    lib_bwd = time_ms(lambda: torch.autograd.grad(ol, (ql, kl, vl), dol,
                                                  retain_graph=True), reps)
    lib = {"flash_fwd": lib_fwd, "flash_dq": lib_bwd, "flash_dkv": lib_bwd}
    bnd = bounds(B, S, T, H, Kv, hd, causal, window, q.element_size())
    return {name: {"ms": ms[name], "plain_ms": plain[name], "library_ms": lib[name],
                   "bound_ms": bnd[name]["bound_ms"], "bound_by": bnd[name]["bound_by"]}
            for name in KERNELS}


SMALL_CASES = [
    # B, S, T, H, Kv, hd, causal, window
    (2, 128, 128, 4, 4, 64, True, None),
    (2, 128, 256, 4, 1, 64, True, None),      # T > S: q_offset = 128
    (2, 256, 256, 4, 2, 64, True, None),
    (1, 128, 128, 2, 2, 32, True, 16),        # window < every tile edge
    (1, 128, 128, 2, 2, 32, True, 64),
    (1, 128, 256, 4, 1, 32, True, 64),
    (1, 256, 256, 4, 1, 16, True, 32),        # the small model's head dim
    (1, 64, 64, 2, 2, 16, False, None),       # non-causal
    (1, 128, 128, 2, 1, 32, False, 16),       # window without causality
    (1, 128, 128, 4, 2, 128, True, None),
    (1, 128, 128, 4, 1, 256, True, 64),
]


def phase_kernels(cfg) -> dict:
    worst = dict.fromkeys(KERNELS, 0.0)
    for i, case in enumerate(SMALL_CASES):
        for name, e in check_case(case, torch.float32, 2e-5, 5e-5, seed=i).items():
            worst[name] = max(worst[name], e)
    emit("kernels_fp32", cases=len(SMALL_CASES), tol_fwd=2e-5, tol_grad=5e-5,
         max_abs_err=worst)

    # bf16 at the shapes the training run gives the kernels: a global layer
    # (window None) and a sliding-window layer
    H, Kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    out = {}
    for tag, window in (("global", None), ("window", cfg.window)):
        case = (TRAIN_BATCH, SEQ, SEQ, H, Kv, hd, True, window)
        errs = check_case(case, torch.bfloat16, 2e-2, 2e-2, seed=100)
        torch.cuda.empty_cache()
        timed = time_case(case, torch.bfloat16, reps=5)
        torch.cuda.empty_cache()
        for name in KERNELS:
            timed[name]["max_abs_err"] = errs[name]
        out[tag] = timed
        emit("kernels_bf16", layer=tag, shape=dict(zip(
            ("B", "S", "T", "H", "Kv", "hd", "causal", "window"), case, strict=True)),
            tol=2e-2, kernels=timed)
    return out


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------


def phase_train(cfg, profile: bool) -> dict:
    n_layers = cfg.n_layers
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        torch.cuda.reset_peak_memory_stats()
        tr = Trainer(cfg, get_shape("train_4k"), device=DEV, ckpt_dir=ckpt_dir,
                     ckpt_every=TRAIN_STEPS)
        for name in fa.LAUNCHES:
            fa.LAUNCHES[name] = 0
        logs = tr.fit(steps=TRAIN_STEPS, batch_override=TRAIN_BATCH)
        launches = dict(fa.LAUNCHES)
        tr.ckpt.close()
        peak = torch.cuda.max_memory_allocated()

        losses = [l["loss"] for l in logs]
        if len(logs) != TRAIN_STEPS or not all(math.isfinite(x) and x > 0 for x in losses):
            raise AssertionError(f"bad losses: {losses}")
        if losses[0] >= math.log(cfg.vocab) + 1:
            raise AssertionError(f"first loss {losses[0]} >= ln(V) + 1")
        want = n_layers * TRAIN_STEPS
        if launches["flash_fwd"] < want or launches["flash_dq"] != want \
                or launches["flash_dkv"] != want:
            raise AssertionError(f"launch counts {launches}, expected {want} per kernel")

        if latest_step(ckpt_dir) != TRAIN_STEPS:
            raise AssertionError("no checkpoint was committed at the last step")
        params, opt_state = tr._last_state
        tmpl = {"params": params, "opt": opt_state}
        loaded, manifest = load_checkpoint(ckpt_dir, tmpl, device="cpu")
        for (key, a), b in zip(tree_flatten_with_path(tmpl).items(),
                               tree_flatten_with_path(loaded).values(), strict=True):
            if a.dtype != b.dtype or not torch.equal(a.cpu(), b):
                raise AssertionError(f"checkpoint leaf {key} differs from the live state")
        del loaded

        times = [l["time_s"] for l in logs]
        steady = times[1:]
        tok = TRAIN_BATCH * SEQ
        res = {"arch": cfg.name, "layers": n_layers, "batch": TRAIN_BATCH, "seq": SEQ,
               "params": cfg.param_count(), "steps": TRAIN_STEPS, "losses": losses,
               "grad_norms": [l["grad_norm"] for l in logs], "step_s": times,
               "step_s_median_after_first": float(np.median(steady)),
               "tokens_per_s": tok / float(np.median(steady)),
               "peak_memory_bytes": peak, "launches": launches,
               "checkpoint_step": manifest["step"], "checkpoint_bitexact": True}
        emit("train", **res)

        if profile:
            profile_step(tr, params, opt_state)
        return launches
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def profile_step(tr, params, opt_state) -> None:
    """One more training step under torch.profiler: device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.pipeline import make_batch
    batch = make_batch(tr.cfg, tr.shape, TRAIN_STEPS, tr.seed, TRAIN_BATCH, device=DEV)
    torch.cuda.synchronize()
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tr.step_fn(params, opt_state, batch, TRAIN_STEPS)
        torch.cuda.synchronize()
    wall = time.time() - t0
    # kernel events only: the operator rows repeat their kernels' device time
    rows = [(e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not rows:
        raise AssertionError("the profiler recorded no device activity")
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    groups = {"flash_attention": ("fa::flash_",), "matmul": ("nvjet", "gemm", "cutlass"),
              "elementwise": ("elementwise",), "reduce": ("reduce",),
              "memcpy_memset": ("Memcpy", "Memset")}
    by_group = dict.fromkeys([*groups, "other"], 0.0)
    for ms, _, key in rows:
        group = next((g for g, pats in groups.items() if any(p in key for p in pats)), "other")
        by_group[group] += ms
    emit("profile", step_wall_ms=wall * 1e3, device_busy_ms=total,
         by_group_ms={g: round(ms, 2) for g, ms in by_group.items()},
         top=[{"ms": round(ms, 3), "calls": n, "kernel": key[:90]}
              for ms, n, key in rows[:16]])


# ---------------------------------------------------------------------------
# parity
# ---------------------------------------------------------------------------


def phase_parity() -> None:
    cfg = replace(smoke_config("gemma3-1b"), param_dtype="float32",
                  compute_dtype="float32")
    # every weight in fp32 (the specs give the matrices bf16 whatever the config says)
    params = tree_map(lambda t: t.float(), init_params(cfg, 0, DEV))
    rng = np.random.default_rng(0)
    inputs = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 128)).astype(np.int32)).to(DEV)
    labels = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 128)).astype(np.int32)).to(DEV)
    leaves = list(tree_flatten_with_path(params).values())
    for p in leaves:
        p.requires_grad_(True)
    out = {}
    for flash in (True, False):
        before = dict(fa.LAUNCHES)
        loss, _ = lm_loss(params, replace(cfg, use_flash=flash), inputs, labels)
        grads = torch.autograd.grad(loss, leaves)
        launched = sum(fa.LAUNCHES.values()) - sum(before.values())
        out[flash] = (loss.item(), grads, launched)
    if out[True][2] != 3 * cfg.n_layers or out[False][2] != 0:
        raise AssertionError(f"kernel launches: flash {out[True][2]}, dense {out[False][2]}")
    dloss = abs(out[True][0] - out[False][0])
    dgrad = max(max_err(a, b) for a, b in zip(out[True][1], out[False][1], strict=True))
    if not (dloss <= 1e-5 and dgrad <= 5e-5):
        raise AssertionError(f"kernel path != dense path: loss {dloss}, grads {dgrad}")
    emit("parity", config=cfg.name, layers=cfg.n_layers, seq=128, loss=out[True][0],
         loss_abs_diff=dloss, tol_loss=1e-5, grad_max_abs_diff=dgrad, tol_grad=5e-5)


# ---------------------------------------------------------------------------


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="env,build,kernels,train,parity")
    ap.add_argument("--profile", action="store_true",
                    help="after the train phase, profile one more step")
    args = ap.parse_args()
    phases = args.phases.split(",")
    t0 = time.time()

    cfg = replace(get_config("gemma3-1b"), use_flash=True)
    if "env" in phases:
        phase_env()
    if "build" in phases:
        phase_build()
    timed = phase_kernels(cfg) if "kernels" in phases else None
    launches = phase_train(cfg, args.profile) if "train" in phases else None
    if "parity" in phases:
        phase_parity()

    emit("done", phases=phases, seconds=round(time.time() - t0, 1))
    if timed is not None and launches is not None:
        line = []
        for name, meta in KERNELS.items():
            g, w = timed["global"][name], timed["window"][name]
            line.append({"name": name, **meta, "launches": launches[name],
                         "max_abs_err": max(g["max_abs_err"], w["max_abs_err"]), "tol": 2e-2,
                         "ms": g["ms"], "plain_ms": g["plain_ms"],
                         "bound_ms": g["bound_ms"], "bound_by": g["bound_by"],
                         "library_ms": g["library_ms"],
                         "shape": f"bf16 B={TRAIN_BATCH} S=T={SEQ} H={cfg.n_heads} "
                                  f"Kv={cfg.n_kv_heads} hd={cfg.head_dim_} causal",
                         "window_layer": {"window": cfg.window, **{
                             key: w[key] for key in ("ms", "plain_ms", "bound_ms",
                                                     "bound_by", "library_ms")}}})
        print(json.dumps({"kernels": line}), flush=True)
    print(smi(), flush=True)
    if set(phases) >= {"env", "build", "kernels", "train", "parity"}:
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
