#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py                 # every phase; needs one CUDA device
    python3 chip_smoke.py --phases env,build,kernels
    python3 chip_smoke.py --profile       # adds one profiled training step

Phases, each printing one JSON line (or a few):
  env         versions, device name, power limit
  build       compiles the CUDA kernels from src/repro_torch/kernels/csrc
  kernels     each of the six kernels against its plain PyTorch version on
              the card: fp32 at small shapes, bf16 at the training shapes;
              the flash kernels' small shapes also in bf16 (the tensor-core
              forward and dk/dv kernels), beside the library's own bf16 error,
              and a profiler check of which device kernel each dtype runs;
              times each kernel, its plain version and the library call, and
              computes its bound
  train       Trainer.fit on full-width, full-depth gemma3-1b at S=4096
              through the flash, rmsnorm and fused_adam kernels; checks
              losses, launch counts and the checkpoint
  train_ssm   the same for full-width, full-depth mamba2-1.3b through the
              ssd_chunk, rmsnorm and fused_adam kernels
  parity      kernel path == plain path (loss and grads), small fp32 gemma3
  parity_ssm  the same for a small fp32 mamba2
Then the ``{"kernels": [...]}`` line, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``.  Any failure raises: the exit code is
non-zero and the last line is not printed.  There is no CPU fallback.
"""

from __future__ import annotations

import argparse
import ctypes
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
from repro_torch.kernels import fused_adam as fad  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.kernels import ssd_chunk as sc  # noqa: E402
from repro_torch.launch.train import Trainer  # noqa: E402
from repro_torch.models.transformer import init_params  # noqa: E402
from repro_torch.training.loss import lm_loss  # noqa: E402

DEV = "cuda"
PEAK_FLOPS = 989e12      # H100 SXM, dense bf16 tensor cores (data sheet)
PEAK_FP32 = 67e12        # H100 SXM, fp32 outside the tensor cores (data sheet)
PEAK_BYTES = 3.35e12     # H100 SXM, HBM3 (data sheet)
TRAIN_STEPS = 6
TRAIN_BATCH = 4
SEQ = 4096

TC_PATH = ("mma.sync.aligned.m16n8k16 bf16 x bf16 -> fp32 (tensor cores), ldmatrix, "
           "cp.async two-stage ring")
FMA_PATH = "fp32 FMA from fp32 shared tiles (no tensor cores)"
KERNELS = {
    "flash_fwd": {"route": "cuda",
                  "source": "src/repro_torch/kernels/csrc/flash_fwd.cu",
                  "replaces": "src/repro/kernels/flash_attention.py:100",
                  "bf16_path": "flash_fwd_tc_kernel: " + TC_PATH},
    "flash_dq": {"route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/flash_dq.cu",
                 "replaces": "src/repro/kernels/flash_attention.py:209",
                 "bf16_path": "flash_dq_kernel: " + FMA_PATH},
    "flash_dkv": {"route": "cuda",
                  "source": "src/repro_torch/kernels/csrc/flash_dkv.cu",
                  "replaces": "src/repro/kernels/flash_attention.py:227",
                  "bf16_path": "flash_dkv_tc_kernel: " + TC_PATH},
    "rmsnorm": {"route": "cuda",
                "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
                "replaces": "src/repro/kernels/rmsnorm.py:28"},
    "fused_adam": {"route": "cuda",
                   "source": "src/repro_torch/kernels/csrc/fused_adam.cu",
                   "replaces": "src/repro/kernels/fused_adam.py:44"},
    "ssd_chunk": {"route": "cuda",
                  "source": "src/repro_torch/kernels/csrc/ssd_chunk.cu",
                  "replaces": "src/repro/kernels/ssd_chunk.py:62"},
}
FLASH = ("flash_fwd", "flash_dq", "flash_dkv")
#: the flash kernels whose bf16 inputs run on the tensor cores; their device
#: kernels are named fa::<name>_tc_kernel (bf16) and fa::<name>_kernel (fp32)
TENSOR_CORE = ("flash_fwd", "flash_dkv")


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
         ptxas=info["ptxas"])
    # ptxas' report of every tensor-core kernel (kept beside a cached library)
    # must be there, one per head dim, and show no spill bytes
    for name in TENSOR_CORE:
        tc = [k for k in info["ptxas"][name] if "_tc_kernel" in k["kernel"]]
        if len(tc) != len(fa.HEAD_DIMS) or not all("spill_stores" in k for k in tc):
            raise AssertionError(f"{name}: no complete ptxas report of its tensor-core "
                                 f"kernels: {tc}")
        spilled = [k for k in tc if k["spill_stores"] + k["spill_loads"]]
        if spilled:
            raise AssertionError(f"tensor-core kernels spill registers: {spilled}")


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


def expect_close(name, got, want, atol, rtol, what) -> float:
    """Raise unless got is finite and |got − want| <= atol + rtol·|want|
    elementwise (as tests/test_kernels.py asks); returns the max abs error."""
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output at {what}")
    if not torch.allclose(got, want, atol=atol, rtol=rtol):
        raise AssertionError(f"{name} disagrees with its plain version at {what}: max abs "
                             f"err {max_err(got, want):.3e}, atol {atol}, rtol {rtol}")
    return max_err(got, want)


#: bf16 checks beside the elementwise 2e-2: each row (over hd) of o, dq, dk
#: and dv within this relative 2-norm error, three bf16 ulps (2^-8), and lse,
#: which stays fp32, within BF16_LSE_ATOL.  Held to its own magnitude, a row
#: cannot hide a fault behind an absolute tolerance larger than its values.
BF16_ROW_RTOL = 3 * 2 ** -8
BF16_LSE_ATOL = 1e-4


def row_rel_err(got, want) -> float:
    """Largest relative 2-norm error of one row (the last dim): a fault
    confined to a few rows reads at its own size.  A row below 2^-8 of the
    median row's norm is held to that floor instead: such a row is a sum
    that cancels to rounding noise (dq of a query that sees one key: ds =
    p·(dp − delta) with p = 1 and dp = delta), which has no relative error
    to speak of.  A row that should be 0 must be 0."""
    g = got.float().reshape(-1, got.shape[-1])
    w = want.float().reshape(-1, want.shape[-1])
    num, den = (g - w).norm(dim=-1), w.norm(dim=-1)
    den = den.clamp_min(2 ** -8 * float(den.median()))
    return float(torch.where(num == 0, 0.0, num / den).max())


def check_case(case, dtype, tol_fwd, tol_grad, seed, library=False, faults=False) -> dict:
    """All three kernels against their plain versions on the same inputs.
    The backward kernels and their plain versions both get the plain
    forward's ``lse`` and ``delta``, so each comparison stands alone.  In
    bf16 also the row and lse checks above, returned under ``"row_rel"`` and
    ``"lse_abs"``.  With ``library``, also returns under ``"library"`` the
    errors of ``F.scaled_dot_product_attention`` (o, and dk/dv of its
    autograd backward) against the same plain versions: a yardstick of what
    the dtype costs, never called by the port.  With ``faults``, what the
    bf16 checks read on planted faults (``planted_faults``)."""
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
    errs = {name: max(expect_close(name, a, b, tol, tol, f"{case} {dtype}")
                      for a, b, tol in lst)
            for name, lst in pairs.items()}
    if dtype == torch.bfloat16:
        errs["row_rel"] = {"flash_fwd": row_rel_err(o, o_p), "flash_dq": row_rel_err(dq, dq_p),
                           "flash_dkv": max(row_rel_err(dk, dk_p), row_rel_err(dv, dv_p))}
        errs["lse_abs"] = max_err(lse, lse_p)
        if max(errs["row_rel"].values()) > BF16_ROW_RTOL or errs["lse_abs"] > BF16_LSE_ATOL:
            raise AssertionError(f"bf16 kernels disagree with their plain versions at {case}: "
                                 f"row relative errors {errs['row_rel']} (tolerance "
                                 f"{BF16_ROW_RTOL}), lse {errs['lse_abs']:.3e} "
                                 f"(tolerance {BF16_LSE_ATOL})")
    if library:
        lo, ldk, ldv = library_outputs(case, q, k, v, do)
        errs["library"] = {"flash_fwd": max_err(lo, o_p),
                           "flash_dkv": max(max_err(ldk, dk_p), max_err(ldv, dv_p))}
        errs["library_row_rel"] = {
            "flash_fwd": row_rel_err(lo, o_p),
            "flash_dkv": max(row_rel_err(ldk.to(dtype), dk_p), row_rel_err(ldv.to(dtype), dv_p))}
    if faults:
        errs["planted_faults"] = planted_faults(case, q, k, v, do, o_p, lse_p, delta, dk_p, dv_p)
    return errs


def planted_faults(case, q, k, v, do, o_p, lse_p, delta, dk_p, dv_p) -> dict:
    """What the bf16 checks read on three faults a kernel could have, each
    built in fp32 from the plain formulas at ``case`` and rounded as the
    kernel rounds its output: the forward dropping the last key tile (32
    keys, the tensor-core kernel's tile at hd 256) of the last query tile of
    batch 0; the forward not rescaling its output accumulator when the row
    max grows (the same rows); dk/dv dropping the first query tile (64 rows)
    that sees the key block in the middle of batch 0, kv head 0.  Each must
    read above its tolerance, so that the check at this shape can fail a
    wrong kernel."""
    B, S, T, H, Kv, hd, causal, window = case
    G, scale, bn = H // Kv, fa._scale(hd, None), 32
    mask = fa.attention_mask(S, T, causal, window, q.device)
    f32 = lambda t: t.float()

    # forward, rows [S - 64, S) of batch 0, every head: s (H, 64, T)
    r0, vis = S - 64, mask[S - 64:]
    qb = f32(q[0, r0:]).transpose(0, 1)
    kh = f32(k[0]).repeat_interleave(G, dim=1).transpose(0, 1)
    vh = f32(v[0]).repeat_interleave(G, dim=1).transpose(0, 1)
    s = qb @ kh.transpose(1, 2) * scale
    last = (int(vis[-1].nonzero().max()) // bn) * bn
    dropped = vis.clone()
    dropped[:, last:last + bn] = False
    sd = torch.where(dropped, s, fa.NEG_INF)
    o_drop = torch.softmax(sd, dim=-1) @ vh
    m = torch.full(s.shape[:2], fa.NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qb)
    for j in range(0, T, bn):
        sj, mj = s[..., j:j + bn], vis[:, j:j + bn]
        m_new = torch.maximum(m, torch.where(mj, sj, fa.NEG_INF).max(dim=-1).values)
        pj = torch.where(mj, torch.exp(sj - m_new[..., None]), 0.0)
        l = l * torch.exp(m - m_new) + pj.sum(dim=-1)
        acc = acc + pj @ vh[:, j:j + bn]          # the fault: acc not rescaled
        m = m_new
    o_want = o_p[0, r0:].transpose(0, 1)
    out = {"fwd_last_key_tile_dropped": {
               "o_row_rel": row_rel_err(o_drop.to(o_p.dtype), o_want),
               "lse_abs": max_err(torch.logsumexp(sd, dim=-1), lse_p[0, :, r0:])},
           "fwd_output_not_rescaled": {
               "o_row_rel": row_rel_err((acc / l[..., None]).to(o_p.dtype), o_want)}}

    # dk/dv of keys [k0, k0 + 64), kv head 0 (q heads 0 .. G-1), batch 0,
    # without query rows [i0, i0 + 64)
    k0 = (T // 2 // 64) * 64
    i0 = (int(mask[:, k0:k0 + 64].any(dim=-1).nonzero().min()) // 64) * 64
    qi, doi = f32(q[0, i0:i0 + 64, :G]), f32(do[0, i0:i0 + 64, :G])
    kk, vv = f32(k[0, k0:k0 + 64, 0]), f32(v[0, k0:k0 + 64, 0])
    st = torch.einsum("qhd,kd->hqk", qi, kk) * scale
    st = torch.where(mask[i0:i0 + 64, k0:k0 + 64], st, fa.NEG_INF)
    p = torch.exp(st - lse_p[0, :G, i0:i0 + 64, None])
    dp = torch.einsum("qhd,kd->hqk", doi, vv)
    ds = p * (dp - delta[0, :G, i0:i0 + 64, None]) * scale
    dk_want, dv_want = dk_p[0, k0:k0 + 64, 0], dv_p[0, k0:k0 + 64, 0]
    dk_bad = f32(dk_want) - torch.einsum("hqk,qhd->kd", ds, qi)
    dv_bad = f32(dv_want) - torch.einsum("hqk,qhd->kd", p, doi)
    out["dkv_first_query_tile_dropped"] = {
        "dk_row_rel": row_rel_err(dk_bad.to(dk_p.dtype), dk_want),
        "dv_row_rel": row_rel_err(dv_bad.to(dv_p.dtype), dv_want)}

    missed = {f"{fault}.{key}": x for fault, r in out.items() for key, x in r.items()
              if x <= (BF16_LSE_ATOL if key == "lse_abs" else BF16_ROW_RTOL)}
    if missed:
        raise AssertionError(f"the bf16 checks at {case} cannot see planted faults: {missed}")
    return out


def library_outputs(case, q, k, v, do):
    """o, dk, dv of ``F.scaled_dot_product_attention`` in the inputs' dtype,
    in the port's layouts, the GQA group summed (in fp32) over the repeated
    heads."""
    B, S, T, H, Kv, hd, causal, window = case
    G = H // Kv
    ql = q.transpose(1, 2).detach().requires_grad_(True)
    kl = k.repeat_interleave(G, dim=2).transpose(1, 2).detach().requires_grad_(True)
    vl = v.repeat_interleave(G, dim=2).transpose(1, 2).detach().requires_grad_(True)
    mask = (fa.attention_mask(S, T, causal, window, q.device)
            if causal or window is not None else None)
    ol = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask)
    _, dkl, dvl = torch.autograd.grad(ol, (ql, kl, vl), do.transpose(1, 2))
    group = lambda t: t.float().reshape(B, Kv, G, T, hd).sum(2).transpose(1, 2)
    return ol.detach().transpose(1, 2), group(dkl), group(dvl)


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
            for name in FLASH}


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


def tc_grid(name, case) -> dict:
    """Launch geometry of a tensor-core kernel at ``case``, from its library:
    blocks, resident blocks an SM (the occupancy calculator), threads and
    dynamic shared memory a block."""
    B, S, T, H, Kv, hd, _, _ = case
    fn = getattr(build.load_library(name), name + "_grid")
    dims = (B, S, H, hd) if name == "flash_fwd" else (B, T, Kv, hd)
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 4)()
    if fn(*dims, out) != 0:
        raise RuntimeError(f"{name}_grid failed for {case}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {"blocks": out[0], "blocks_per_sm": out[1], "threads": out[2],
            "smem_bytes": out[3], "sms": sms, "waves": out[0] / (out[1] * sms)}


def check_dispatch() -> dict:
    """One bf16 and one fp32 call of each tensor-core kernel's wrapper under
    torch.profiler: the device kernels that ran must be fa::<name>_tc_kernel
    for bf16 and the fp32 FMA kernel fa::<name>_kernel<float, …> for fp32."""
    from torch.profiler import ProfilerActivity, profile
    case = SMALL_CASES[2]
    B, S, T, H, Kv, hd, causal, window = case
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, do = make_inputs(0, B, S, T, H, Kv, hd, dtype)
        o, lse = fa.flash_fwd_cuda(q, k, v, causal, window)
        delta = ops.attention_delta(o, do)
        torch.cuda.synchronize()
        ran = {}
        for name, call in (("flash_fwd", lambda: fa.flash_fwd_cuda(q, k, v, causal, window)),
                           ("flash_dkv", lambda: fa.flash_dkv_cuda(q, k, v, do, lse, delta,
                                                                   causal, window))):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                call()
                torch.cuda.synchronize()
            ran[name] = sorted({e.key for e in prof.key_averages()
                                if e.device_type == torch.autograd.DeviceType.CUDA
                                and "fa::flash_" in e.key})
            want = (f"fa::{name}_tc_kernel<" if dtype == torch.bfloat16
                    else f"fa::{name}_kernel<float")
            if len(ran[name]) != 1 or want not in ran[name][0]:
                raise AssertionError(f"{name} {dtype}: ran {ran[name]}, expected {want}…")
        out[str(dtype).replace("torch.", "")] = ran
    return out


def phase_kernels_flash(cfg) -> dict:
    worst = dict.fromkeys(FLASH, 0.0)
    for i, case in enumerate(SMALL_CASES):
        for name, e in check_case(case, torch.float32, 2e-5, 5e-5, seed=i).items():
            worst[name] = max(worst[name], e)
    emit("kernels_fp32", cases=len(SMALL_CASES), tol_fwd=2e-5, tol_grad=5e-5,
         max_abs_err=worst)

    # the same cases in bf16 against the fp32 plain version of the same bf16
    # inputs, beside the library's bf16 error there
    per_case = []
    for i, case in enumerate(SMALL_CASES):
        errs = check_case(case, torch.bfloat16, 2e-2, 2e-2, seed=i, library=True)
        per_case.append({"case": case, "lse_abs": errs["lse_abs"],
                         **{n: {"kernel": errs[n], "library": errs["library"][n],
                                "kernel_row_rel": errs["row_rel"][n],
                                "library_row_rel": errs["library_row_rel"][n]}
                            for n in TENSOR_CORE}})
    worst = lambda key: {n: max(c[n][key] for c in per_case) for n in TENSOR_CORE}
    emit("kernels_bf16_small", cases=len(SMALL_CASES), tol=2e-2, rtol=2e-2,
         tol_row_rel=BF16_ROW_RTOL, tol_lse=BF16_LSE_ATOL,
         max_abs_err=worst("kernel"), library_max_abs_err=worst("library"),
         max_row_rel_err=worst("kernel_row_rel"), library_max_row_rel_err=worst("library_row_rel"),
         max_lse_abs_err=max(c["lse_abs"] for c in per_case), by_case=per_case)
    emit("kernels_dispatch", ran=check_dispatch())

    # bf16 at the shapes the training run gives the kernels: a global layer
    # (window None) and a sliding-window layer
    H, Kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    out = {}
    for tag, window in (("global", None), ("window", cfg.window)):
        case = (TRAIN_BATCH, SEQ, SEQ, H, Kv, hd, True, window)
        errs = check_case(case, torch.bfloat16, 2e-2, 2e-2, seed=100, faults=True)
        torch.cuda.empty_cache()
        timed = time_case(case, torch.bfloat16, reps=5)
        torch.cuda.empty_cache()
        for name in FLASH:
            timed[name]["max_abs_err"] = errs[name]
            timed[name]["max_row_rel_err"] = errs["row_rel"][name]
        timed["flash_fwd"]["lse_abs_err"] = errs["lse_abs"]
        for name in TENSOR_CORE:
            timed[name]["grid"] = tc_grid(name, case)
        out[tag] = timed
        emit("kernels_bf16", layer=tag, shape=dict(zip(
            ("B", "S", "T", "H", "Kv", "hd", "causal", "window"), case, strict=True)),
            tol=2e-2, tol_row_rel=BF16_ROW_RTOL, tol_lse=BF16_LSE_ATOL, kernels=timed,
            planted_faults=errs["planted_faults"])
    return out


def bound(flops: float, nbytes: float, peak_flops: float) -> dict:
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def generator(seed: int) -> torch.Generator:
    """Inputs of the rmsnorm, fused_adam and ssd_chunk checks are drawn on
    the card (hundreds of millions of values for the optimizer's leaves)."""
    return torch.Generator(device=DEV).manual_seed(seed)


def randn(rng, shape, dtype, scale=1.0):
    return (torch.randn(shape, generator=rng, device=DEV) * scale).to(dtype)


def backward_ms(fn, args, reps) -> float:
    """ms of the backward of ``fn`` (an autograd Function of ops: autograd
    of the kernel's plain version) with respect to all its inputs."""
    leaves = [a.detach().requires_grad_(True) for a in args]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    cots = [torch.ones_like(o) for o in outs]
    ms = time_ms(lambda: torch.autograd.grad(outs, leaves, cots, retain_graph=True), reps)
    del outs
    return ms


# -- rmsnorm --------------------------------------------------------------------


def rmsnorm_bound(rows, d, itemsize) -> dict:
    """x read and y written once, scale read once; sum of squares, mean,
    rsqrt and two products: about 4 fp32 operations an element."""
    return bound(4 * rows * d, 2 * rows * d * itemsize + 4 * d, PEAK_FP32)


def check_rmsnorm(shape, dtype, tol, seed) -> float:
    rng = generator(seed)
    x = randn(rng, shape, dtype)
    scale = randn(rng, shape[-1:], torch.float32, 0.1)
    y = rn.rmsnorm_cuda(x, scale)
    torch.cuda.synchronize()
    if y.dtype != x.dtype or y.shape != x.shape:
        raise AssertionError(f"rmsnorm: got {y.dtype} {tuple(y.shape)} for {x.dtype} {shape}")
    return expect_close("rmsnorm", y, rn.rmsnorm_plain(x, scale), tol, tol, f"{shape} {dtype}")


def time_rmsnorm(rows, d) -> dict:
    rng = generator(11)
    x = randn(rng, (rows, d), torch.bfloat16)
    scale = randn(rng, (d,), torch.float32, 0.1)
    err = check_rmsnorm((rows, d), torch.bfloat16, 2e-2, seed=12)
    # library yardstick: one PyTorch call, weight (1 + scale) in x's dtype (the
    # port never calls it)
    w = (1.0 + scale).to(x.dtype)
    return {"max_abs_err": err,
            "ms": time_ms(lambda: rn.rmsnorm_cuda(x, scale), 20),
            "plain_ms": time_ms(lambda: rn.rmsnorm_plain(x, scale), 5),
            "library_ms": time_ms(lambda: F.rms_norm(x, (d,), w, 1e-6), 20),
            "backward_plain_ms": backward_ms(ops.rmsnorm, (x, scale), 5),
            **rmsnorm_bound(rows, d, x.element_size())}


# -- fused_adam -----------------------------------------------------------------


def adam_bound(n, p_dt, g_dt, s_dt) -> dict:
    """p, m, v read and written once, g read once; about 16 fp32 operations
    an element."""
    size = lambda dt: torch.tensor([], dtype=dt).element_size()
    nbytes = n * (2 * size(p_dt) + size(g_dt) + 4 * size(s_dt))
    return bound(16 * n, nbytes, PEAK_FP32)


def adam_leaf(rng, n, p_dt, g_dt, s_dt):
    p = randn(rng, (n,), p_dt)
    g = randn(rng, (n,), g_dt)
    m = randn(rng, (n,), s_dt, 0.1)
    v = (randn(rng, (n,), torch.float32).abs() * 0.01).to(s_dt)
    return p, g, m, v


ADAM_HP = dict(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.01)


def check_adam(leaf, count, tol) -> float:
    """Kernel and plain version on copies of ``leaf`` (p, g, m, v)."""
    mine = [t.clone() for t in leaf]
    plain = [t.clone() for t in leaf]
    cnt = torch.tensor(count, dtype=torch.int32, device=DEV)
    fad.fused_adam_cuda(*mine, cnt, **ADAM_HP)
    fad.fused_adam_plain(*plain, cnt, **ADAM_HP)
    torch.cuda.synchronize()
    p, g, m, _ = leaf
    what = f"n={p.numel()} p {p.dtype} g {g.dtype} m/v {m.dtype} count {count}"
    errs = [expect_close("fused_adam", a, b, tol, tol, f"{what} ({k})")
            for k, a, b in zip("pgmv", mine, plain, strict=True) if k != "g"]
    del mine, plain
    return max(errs)


def time_adam(shape, p_dt, g_dt, s_dt) -> dict:
    n = math.prod(shape)
    p, g, m, v = leaf = adam_leaf(generator(13), n, p_dt, g_dt, s_dt)
    cnt = torch.tensor(100, dtype=torch.int32, device=DEV)
    err = check_adam(leaf, 100, 2e-2)
    torch.cuda.empty_cache()
    ms = time_ms(lambda: fad.fused_adam_cuda(p, g, m, v, cnt, **ADAM_HP), 10)
    plain_ms = time_ms(lambda: fad.fused_adam_plain(p, g, m, v, cnt, **ADAM_HP), 3)
    out = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           **adam_bound(n, p_dt, g_dt, s_dt)}
    if p_dt == g_dt == s_dt:
        # library yardstick: torch._fused_adamw_ (the port never calls it);
        # it takes one dtype for params, grads and states
        step = torch.tensor(100.0, device=DEV)
        out["library_ms"] = time_ms(lambda: torch._fused_adamw_(
            [p], [g], [m], [v], [], [step], lr=1e-3, beta1=0.9, beta2=0.95,
            weight_decay=0.01, eps=1e-8, amsgrad=False, maximize=False), 10)
    else:
        out["library_ms"] = None
        out["library_note"] = ("torch._fused_adamw_ takes one dtype for params, grads and "
                               "states; these are mixed")
    return out


# -- ssd_chunk ------------------------------------------------------------------


def ssd_bound(Bt, nc, Q, H, hp, G, N, itemsize) -> dict:
    """The causal half of C·Bᵀ and of att·(x·dt), and the states product,
    2 FLOPs a multiply-add; x, dt, B, C (per group), a read once and y,
    states, cum written once."""
    tri = Q * (Q + 1) // 2
    flops = Bt * nc * H * (tri * 2 * (N + hp) + 2 * Q * N * hp)
    nbytes = (Bt * nc * Q * (2 * H * hp * itemsize + 2 * G * N * itemsize + 2 * H * 4)
              + Bt * nc * H * N * hp * 4 + H * 4)
    return bound(flops, nbytes, PEAK_FLOPS)


def ssd_inputs(seed, Bt, nc, Q, H, hp, G, N, dtype, dt_scale=0.1):
    """The model's layout: b and c are the two group halves of one (…, 2G, N)
    tensor, as the model slices them out of ``bc`` (strided views)."""
    rng = generator(seed)
    x = randn(rng, (Bt, nc, Q, H, hp), dtype)
    dt = randn(rng, (Bt, nc, Q, H), torch.float32).abs() * dt_scale
    bc = randn(rng, (Bt, nc, Q, 2 * G, N), dtype)
    b, c = bc.split(G, dim=3)
    a = -randn(rng, (H,), torch.float32).abs() - 0.1
    return x, dt, b, c, a


def check_ssd(args, tol, what) -> float:
    got = sc.ssd_chunk_cuda(*args)
    want = sc.ssd_chunk_plain(*args)
    torch.cuda.synchronize()
    errs = []
    for k, a, b, atol, rtol in zip(("y", "states", "cum"), got, want,
                                   (10 * tol, 10 * tol, tol), (tol, tol, tol), strict=True):
        errs.append(expect_close("ssd_chunk", a, b, atol, rtol, f"{what} ({k})"))
    return max(errs)


SSD_CASES = [
    # Q, hp, N: the reference's test shapes (BH=3 heads, one per group, nc=2) ...
    (64, 32, 16), (128, 64, 128), (32, 16, 32),
]


def check_ssd_fp32() -> float:
    worst = 0.0
    for i, (Q, hp, N) in enumerate(SSD_CASES):
        rng = generator(i)
        BH, nc = 3, 2
        x = randn(rng, (BH, nc, Q, hp), torch.float32)
        dt = randn(rng, (BH, nc, Q), torch.float32).abs() * 0.1
        b = randn(rng, (BH, nc, Q, N), torch.float32)
        c = randn(rng, (BH, nc, Q, N), torch.float32)
        a = -randn(rng, (BH,), torch.float32).abs() - 0.1
        got = ops.ssd_chunk(x, dt, b, c, a)            # the reference's layout
        want = ref.ssd_chunk_ref(x, dt, b, c, a)
        torch.cuda.synchronize()
        for k, u, w, atol in zip(("y", "states", "cum"), got, want, (2e-4, 2e-4, 1e-5),
                                 strict=True):
            worst = max(worst, expect_close("ssd_chunk", u, w, atol, 2e-5,
                                            f"Q={Q} hp={hp} N={N} fp32 ({k})"))
    # ... and the model's layout: 8 heads on 2 groups, a ragged last row tile
    # (Q = 96) with dt as large as the model's at init, and mamba2's Q, hp, N
    for Q, hp, N, dt_scale in ((96, 16, 32, 0.7), (256, 64, 128, 0.1)):
        args = ssd_inputs(7, 2, 2, Q, 8, hp, 2, N, torch.float32, dt_scale)
        worst = max(worst, check_ssd(args, 2e-5, f"model layout Q={Q} hp={hp} N={N} fp32"))
    return worst


def time_ssd(Bt, nc, Q, H, hp, G, N) -> dict:
    args = ssd_inputs(15, Bt, nc, Q, H, hp, G, N, torch.bfloat16)
    err = check_ssd(args, 2e-2, f"B={Bt} nc={nc} Q={Q} H={H} hp={hp} N={N} bf16")
    torch.cuda.empty_cache()
    return {"max_abs_err": err,
            "ms": time_ms(lambda: sc.ssd_chunk_cuda(*args), 5),
            "plain_ms": time_ms(lambda: sc.ssd_chunk_plain(*args), 2),
            "backward_plain_ms": backward_ms(ops.ssd_chunk_heads, args, 2),
            "library_ms": None,
            "library_note": "no PyTorch call computes the SSD chunk",
            "tol": 0.2, "rtol": 2e-2,        # y: ten times the absolute tolerance
            **ssd_bound(Bt, nc, Q, H, hp, G, N, 2)}


def phase_kernels_more(gemma, mamba) -> dict:
    """rmsnorm, fused_adam and ssd_chunk: fp32 at small shapes, then bf16 at
    the shapes the training runs give them, timed."""
    worst = {"rmsnorm": 0.0, "fused_adam": 0.0}
    for i, shape in enumerate([(4, 128), (2, 33, 256), (1, 7, 5, 64), (37, 1152),
                               (5, 2048), (3, 4096), (2, 8200)]):
        worst["rmsnorm"] = max(worst["rmsnorm"],
                               check_rmsnorm(shape, torch.float32, 2e-5, seed=i))
    f32 = torch.float32
    for i, (n, count) in enumerate([(2 ** 10, 1), (3 * 2 ** 9, 100), (2 ** 16, 1),
                                    (1_000_003, 100)]):
        leaf = adam_leaf(generator(i), n, f32, f32, f32)
        worst["fused_adam"] = max(worst["fused_adam"], check_adam(leaf, count, 1e-6))
    mixed = 0.0
    for i, dts in enumerate([(torch.bfloat16, torch.bfloat16, torch.float32),
                             (torch.bfloat16, torch.float32, torch.float32),
                             (torch.float32, torch.float32, torch.bfloat16),
                             (torch.bfloat16, torch.bfloat16, torch.bfloat16)]):
        mixed = max(mixed, check_adam(adam_leaf(generator(10 + i), 100_003, *dts), 100, 2e-2))
    worst["ssd_chunk"] = check_ssd_fp32()
    emit("kernels_fp32_more", tol={"rmsnorm": 2e-5, "fused_adam": 1e-6,
                                   "fused_adam_mixed_dtypes": 2e-2,
                                   "ssd_chunk": "y, states: atol 2e-4 rtol 2e-5; cum 1e-5"},
         max_abs_err={**worst, "fused_adam_mixed_dtypes": mixed})

    rows = TRAIN_BATCH * SEQ
    norms = {d: time_rmsnorm(rows, d) for d in (gemma.d_model, mamba.d_model, mamba.d_inner)}
    torch.cuda.empty_cache()
    L = mamba.n_layers
    adam = {"mamba2 scan wz (bf16 p/g, fp32 m/v)": time_adam(
                (L, mamba.d_model, mamba.d_inner), torch.bfloat16, torch.bfloat16,
                torch.float32),
            "gemma3 embed table (bf16 p/g, fp32 m/v)": time_adam(
                (gemma.vocab, gemma.d_model), torch.bfloat16, torch.bfloat16, torch.float32),
            "mamba2 scan wz, all fp32": time_adam(
                (L, mamba.d_model, mamba.d_inner), torch.float32, torch.float32,
                torch.float32)}
    torch.cuda.empty_cache()
    s = mamba.ssm
    ssd_shape = (TRAIN_BATCH, SEQ // s.chunk, s.chunk, mamba.ssm_heads, s.headdim,
                 s.n_groups, s.d_state)
    ssd = time_ssd(*ssd_shape)
    torch.cuda.empty_cache()
    emit("kernels_bf16_more", tol=2e-2, rmsnorm={f"rows={rows} d={d}": v for d, v in norms.items()},
         fused_adam=adam,
         ssd_chunk={"shape": dict(zip(("B", "nc", "Q", "H", "hp", "G", "N"), ssd_shape,
                                      strict=True)), **ssd})
    return {"rmsnorm": {**norms[mamba.d_model], "shape": f"bf16 rows={rows} d={mamba.d_model}",
                        "other_shapes": {f"d={d}": norms[d] for d in norms if d != mamba.d_model}},
            "fused_adam": {**adam["mamba2 scan wz (bf16 p/g, fp32 m/v)"],
                           "shape": f"mamba2 scan wz leaf {(L, mamba.d_model, mamba.d_inner)}, "
                                    "bf16 p/g, fp32 m/v",
                           "other_shapes": {k: v for k, v in adam.items()
                                            if not k.startswith("mamba2 scan wz (bf16")}},
            "ssd_chunk": {**ssd, "shape": "bf16 B={} nc={} Q={} H={} hp={} G={} N={}".format(
                *ssd_shape)}}


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------


def expected_launches(cfg, leaves: int) -> dict:
    """Kernel launches of one training step, derived from the model code.
    Each layer runs its forward once, and once more in the backward when its
    period is recomputed (``cfg.remat != "none"``: every scanned layer; the
    remainder layers are not recomputed).  A layer's forward launches one
    rmsnorm for ln1, one for ln2 when it has an MLP and one for a mamba
    mixer's gated norm, one flash_fwd for an attention mixer and one
    ssd_chunk for a mamba mixer; its backward one flash_dq and one flash_dkv
    for attention (rmsnorm and ssd_chunk have no backward kernel).  Then the
    final norm, and fused_adam once per parameter leaf."""
    period = cfg.scan_period()
    recomputed = (cfg.n_layers // period) * period if cfg.remat != "none" else 0
    out = dict.fromkeys(KERNELS, 0)
    for i, spec in enumerate(cfg.layer_specs()):
        runs = 2 if i < recomputed else 1
        attn = int(spec.mixer in ("attn", "local"))
        mamba = int(spec.mixer == "mamba")
        out["flash_fwd"] += runs * attn
        out["flash_dq"] += attn
        out["flash_dkv"] += attn
        out["ssd_chunk"] += runs * mamba
        out["rmsnorm"] += runs * (1 + int(cfg.mlp != "none") + mamba)
    out["rmsnorm"] += 1
    out["fused_adam"] = leaves
    return out


def reset_launches() -> None:
    for name in ops.LAUNCHES:
        ops.LAUNCHES[name] = 0


def phase_train(cfg, phase: str, profile: bool) -> dict:
    n_layers = cfg.n_layers
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        torch.cuda.reset_peak_memory_stats()
        tr = Trainer(cfg, get_shape("train_4k"), device=DEV, ckpt_dir=ckpt_dir,
                     ckpt_every=TRAIN_STEPS)
        reset_launches()
        logs = tr.fit(steps=TRAIN_STEPS, batch_override=TRAIN_BATCH)
        launches = dict(ops.LAUNCHES)
        tr.ckpt.close()
        peak = torch.cuda.max_memory_allocated()

        losses = [l["loss"] for l in logs]
        gnorms = [l["grad_norm"] for l in logs]
        if len(logs) != TRAIN_STEPS or not all(math.isfinite(x) and x > 0 for x in losses):
            raise AssertionError(f"bad losses: {losses}")
        if not all(math.isfinite(x) and x > 0 for x in gnorms):
            raise AssertionError(f"bad grad norms: {gnorms}")
        if losses[0] >= math.log(cfg.vocab) + 1:
            raise AssertionError(f"first loss {losses[0]} >= ln(V) + 1")
        params, opt_state = tr._last_state
        per_step = expected_launches(cfg, len(tree_flatten_with_path(params)))
        want = {name: n * TRAIN_STEPS for name, n in per_step.items()}
        if launches != want:
            raise AssertionError(f"launch counts {launches}, expected {want}")

        if latest_step(ckpt_dir) != TRAIN_STEPS:
            raise AssertionError("no checkpoint was committed at the last step")
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
               "grad_norms": gnorms, "step_s": times,
               "step_s_median_after_first": float(np.median(steady)),
               "tokens_per_s": tok / float(np.median(steady)),
               "peak_memory_bytes": peak, "launches": launches,
               "launches_per_step": per_step,
               "checkpoint_step": manifest["step"], "checkpoint_bitexact": True}
        emit(phase, **res)

        if profile:
            profile_step(tr, params, opt_state, phase)
        return launches
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def profile_step(tr, params, opt_state, phase: str) -> None:
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
    groups = {"flash_fwd": ("fa::flash_fwd",), "flash_dq": ("fa::flash_dq",),
              "flash_dkv": ("fa::flash_dkv",), "ssd_chunk": ("ssd::ssd_chunk",),
              "rmsnorm": ("rn::rmsnorm",), "fused_adam": ("adam::adam",),
              "matmul": ("nvjet", "gemm", "cutlass"),
              "elementwise": ("elementwise",), "reduce": ("reduce",),
              "memcpy_memset": ("Memcpy", "Memset")}
    by_group = dict.fromkeys([*groups, "other"], 0.0)
    for ms, _, key in rows:
        group = next((g for g, pats in groups.items() if any(p in key for p in pats)), "other")
        by_group[group] += ms
    emit("profile", of=phase, step_wall_ms=wall * 1e3, device_busy_ms=total,
         by_group_ms={g: round(ms, 2) for g, ms in by_group.items()},
         top=[{"ms": round(ms, 3), "calls": n, "kernel": key[:90]}
              for ms, n, key in rows[:16]])


# ---------------------------------------------------------------------------
# parity
# ---------------------------------------------------------------------------


def parity(cfg, phase: str, seq: int) -> None:
    """Kernel path (``use_flash=True``) vs plain path on the card, fp32: loss
    to 1e-5, every gradient leaf to 5e-5, and the kernels the kernel path
    launched counted (forward and backward of ``lm_loss``, no remat)."""
    # every weight in fp32 (the specs give the matrices bf16 whatever the config says)
    params = tree_map(lambda t: t.float(), init_params(cfg, 0, DEV))
    rng = np.random.default_rng(0)
    inputs = torch.from_numpy(rng.integers(0, cfg.vocab, (2, seq)).astype(np.int32)).to(DEV)
    labels = torch.from_numpy(rng.integers(0, cfg.vocab, (2, seq)).astype(np.int32)).to(DEV)
    leaves = list(tree_flatten_with_path(params).values())
    for p in leaves:
        p.requires_grad_(True)
    out = {}
    for flash in (True, False):
        reset_launches()
        loss, _ = lm_loss(params, replace(cfg, use_flash=flash), inputs, labels)
        grads = torch.autograd.grad(loss, leaves)
        out[flash] = (loss.item(), grads, dict(ops.LAUNCHES))
    want = {k: v for k, v in expected_launches(cfg, 0).items() if k != "fused_adam"}
    got = {k: v for k, v in out[True][2].items() if k != "fused_adam"}
    if got != want or any(out[False][2].values()):
        raise AssertionError(f"kernel launches: kernel path {got} (expected {want}), "
                             f"plain path {out[False][2]}")
    dloss = abs(out[True][0] - out[False][0])
    dgrad = max(max_err(a, b) for a, b in zip(out[True][1], out[False][1], strict=True))
    if not (dloss <= 1e-5 and dgrad <= 5e-5):
        raise AssertionError(f"kernel path != plain path: loss {dloss}, grads {dgrad}")
    emit(phase, config=cfg.name, layers=cfg.n_layers, seq=seq, loss=out[True][0],
         loss_abs_diff=dloss, tol_loss=1e-5, grad_max_abs_diff=dgrad, tol_grad=5e-5,
         launches=got)


def phase_parity() -> None:
    parity(replace(smoke_config("gemma3-1b"), param_dtype="float32",
                   compute_dtype="float32"), "parity", 128)


def phase_parity_ssm() -> None:
    """A small mamba2 inside the kernels' contract: head dim 16, state 16,
    chunk 64 (two chunks of S = 128), d_model 64, d_inner 128."""
    base = smoke_config("mamba2-1.3b")
    cfg = replace(base, param_dtype="float32", compute_dtype="float32",
                  ssm=replace(base.ssm, headdim=16, chunk=64))
    parity(cfg, "parity_ssm", 128)


# ---------------------------------------------------------------------------

PHASES = ("env", "build", "kernels", "train", "train_ssm", "parity", "parity_ssm")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--profile", action="store_true",
                    help="after each train phase, profile one more step")
    args = ap.parse_args()
    phases = args.phases.split(",")
    t0 = time.time()

    gemma = replace(get_config("gemma3-1b"), use_flash=True)
    mamba = replace(get_config("mamba2-1.3b"), use_flash=True)
    if "env" in phases:
        phase_env()
    if "build" in phases:
        phase_build()
    timed = None
    if "kernels" in phases:
        timed = phase_kernels_flash(gemma)
        torch.cuda.empty_cache()
        timed["more"] = phase_kernels_more(gemma, mamba)
        torch.cuda.empty_cache()
    launches = {}
    if "train" in phases:
        launches["train"] = phase_train(gemma, "train", args.profile)
        torch.cuda.empty_cache()
    if "train_ssm" in phases:
        launches["train_ssm"] = phase_train(mamba, "train_ssm", args.profile)
        torch.cuda.empty_cache()
    if "parity" in phases:
        phase_parity()
    if "parity_ssm" in phases:
        phase_parity_ssm()

    emit("done", phases=phases, seconds=round(time.time() - t0, 1))
    if timed is not None and set(launches) == {"train", "train_ssm"}:
        line = []
        for name, meta in KERNELS.items():
            by_path = {path: counts[name] for path, counts in launches.items()}
            # a kernel's own path: gemma3-1b for the flash kernels, mamba2-1.3b
            # for the three this slice added (they run on both)
            own = "train" if name in FLASH else "train_ssm"
            entry = {"name": name, **meta, "launches": by_path[own],
                     "launches_by_path": by_path}
            if name in FLASH:
                g, w = timed["global"][name], timed["window"][name]
                entry.update({"max_abs_err": max(g["max_abs_err"], w["max_abs_err"]),
                              "tol": 2e-2, "rtol": 2e-2,
                              "max_row_rel_err": max(g["max_row_rel_err"],
                                                     w["max_row_rel_err"]),
                              "tol_row_rel": BF16_ROW_RTOL,
                              "ms": g["ms"], "plain_ms": g["plain_ms"],
                              "bound_ms": g["bound_ms"], "bound_by": g["bound_by"],
                              "library_ms": g["library_ms"], "grid": g.get("grid"),
                              "shape": f"bf16 B={TRAIN_BATCH} S=T={SEQ} H={gemma.n_heads} "
                                       f"Kv={gemma.n_kv_heads} hd={gemma.head_dim_} causal",
                              "window_layer": {"window": gemma.window, **{
                                  key: w[key] for key in ("ms", "plain_ms", "bound_ms",
                                                          "bound_by", "library_ms")}}})
                if name != "flash_fwd":
                    # the library's backward computes dq, dk and dv in one call
                    entry["library_note"] = ("whole autograd backward of "
                                             "F.scaled_dot_product_attention (dq, dk, dv): "
                                             "compare with flash_dq + flash_dkv")
                    entry["dq_plus_dkv_ms"] = {
                        layer: timed[layer]["flash_dq"]["ms"] + timed[layer]["flash_dkv"]["ms"]
                        for layer in ("global", "window")}
            else:
                t = timed["more"][name]
                entry.update({"max_abs_err": t["max_abs_err"], "tol": t.get("tol", 2e-2),
                              "rtol": t.get("rtol", 2e-2), "ms": t["ms"],
                              "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                              "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                              "shape": t["shape"]})
                for key in ("library_note", "backward_plain_ms", "other_shapes"):
                    if key in t:
                        entry[key] = t[key]
            line.append(entry)
        print(json.dumps({"kernels": line}), flush=True)
    print(smi(), flush=True)
    if set(phases) >= set(PHASES):
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
