#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py                 # every phase; needs one CUDA device
    python3 chip_smoke.py --phases env,build,kernels
    python3 chip_smoke.py --profile       # adds one profiled training step and
                                          # eight profiled decode steps a model

Phases, each printing one JSON line (or a few):
  env         versions, device name, power limit
  build       compiles the CUDA kernels from src/repro_torch/kernels/csrc
  kernels     each of the six kernels and the rmsnorm backward against its
              plain PyTorch version on the card: fp32 at small shapes, bf16
              at the training shapes (flash at gemma3's global and window
              layers and at olmoe's hd 128, H = Kv = 16; the norm also at
              MLA's widths, at train_mla's rows and at a decode step's 8;
              AdamW also on olmoe's expert stack); the flash and SSD
              kernels' small shapes
              also in bf16 (their tensor-core kernels), flash beside the
              library's own bf16 error, planted faults that the bf16 checks
              must see, and a profiler check of which device kernel each
              dtype runs (rmsnorm: its launches, and no operator of the plain
              backward beneath its autograd node);
              fused_adam as one multi-tensor call over whole trees (bit for
              bit in fp32, launches by dtype group); times each kernel (the
              norms over inputs rotated past the L2), its plain version and
              the library call, and computes its bound
  train       Trainer.fit on full-width, full-depth gemma3-1b at S=4096
              through the flash, rmsnorm (forward and backward) and
              fused_adam kernels; checks losses, launch counts and the
              checkpoint (with --profile: that the norm's backward ran its
              kernels and no operator of the plain backward)
  train_ssm   the same for full-width, full-depth mamba2-1.3b through the
              ssd_chunk, rmsnorm and fused_adam kernels
  train_mla   the same for minicpm3-4b (MLA) at full width and 4 layers,
              batch 2 x 4096, 4 steps
  train_moe   the same for olmoe-1b-7b (Mixture-of-Experts) at full width and
              8 of 16 layers, batch 4 x 4096, 6 steps; also the aux loss at
              step 0
              (every train phase runs its config's remat="dots": the matrix
              products' outputs kept, the rest of each period recomputed)
  remat       gemma3-1b as in train, 3 steps under each remat policy (none,
              full, dots, dots_no_batch, and save:mlp_hidden,qkv from MONET's
              keep-set): step time, tokens/s, peak memory, launches; losses
              and grad norms equal bit for bit, peaks rising full < keep-set
              < dots < none, and a planted fault (nothing kept, named dots)
              that must break that order
  ac_search   MONET's activation-checkpointing search (knapsack at half the
              activation bytes, NSGA-II) on the training graph of its GPT-2
              builder at gemma3-1b's widths, twice (the same keep-sets); each
              keep-set's save: policy and full train gemma3-1b as in remat:
              modelled cycles and bytes beside step time, tokens/s and peak
              memory, losses and grad norms equal to full's bit for bit, and
              a planted fault (the GA's keep-set mapped to no family) whose
              peak must differ from the GA policy's
  train_opt   gemma3-1b as in train, 4 steps with each of sgd_momentum,
              adafactor and galore_adamw: losses, launches, the state tree
              as opt.init gives it, a checkpoint read back bit for bit, the
              time of one opt.update beside AdamW's, peak memory
  serve       make_serve_step on full-width, full-depth gemma3-1b,
              mamba2-1.3b, minicpm3-4b and olmoe-1b-7b: 8 sequences, a
              512-token prompt fed token by token, then 256 greedy tokens (768
              calls, cache of 1024); rmsnorm launches per call, decode == the
              teacher-forced forward (flash, ssd_chunk and rmsnorm kernels; for
              olmoe with capacity_factor E/K, so that the forward drops no
              token) a row at a time, and four planted faults that check must
              see
  parity      kernel path == plain path (loss and grads), small fp32 gemma3
  parity_ssm  the same for a small fp32 mamba2
  parity_serve  small fp32 gemma3 (window 8), mamba2 and minicpm3: decode on
              the kernel path == decode on the plain path == the forward;
              minicpm3's kernel path == plain path for loss and grads
  parity_moe  small fp32 olmoe (capacity as configured: tokens are dropped):
              kernel path == plain path for loss, aux and grads; decode on the
              kernel path == decode on the plain path == the drop-free forward
  parity_opt  small fp32 gemma3: 3 updates of sgd_momentum, adafactor and
              galore_adamw on the card == on the CPU, each leaf to 1e-6 of
              its largest entry
  train_mesh  the trainer's mesh path (DTensors, every kernel through its
              local_map route) on a one-rank NCCL group and a (1, 1)
              ('data', 'model') mesh: gemma3-1b as in train, each step's
              loss and grad norm equal to train's bit for bit, launches as
              derived, checkpoint bit for bit, step time, tokens/s, peak
              memory and aten operators a step beside train's; mamba2-1.3b
              at full width and 4 layers (ssd_chunk's mesh route); a planted
              fault (the mesh route's norm through its plain version) that
              the launch check must catch
  dryrun      python -m repro_torch.launch.dryrun for gemma3-1b train_4k and
              mamba2-1.3b decode_32k on (16, 16) and (2, 16, 16): a fake
              process group of 512 ranks and meta local shards; FLOPs a
              device and global, collectives by kind, bytes, seconds
  trace       repro_torch.core.trace over one real training step as train
              runs it: gemma3-1b at full width and depth (4 x 4096, bf16,
              use_flash, remat="dots", AdamW through fused_adam), then
              mamba2-1.3b and olmoe-1b-7b at full width and 4 layers; kernel
              nodes per entry point == the step's LAUNCHES delta, gemm-class
              FLOPs == FlopCounterMode over the same step on meta (plus what
              SAC's recompute hides from it) within 1 %, gemma3-1b's graph on
              the card == its graph on meta, a small gemma3's on the card ==
              on the CPU; the graph validated and scheduled with the port's
              core on tpu_v5e_like(); nodes, tensors, FLOPs by class, cycles,
              peak memory, trace and schedule seconds beside the measured
              step time; a planted fault (the norm's hook switched off) that
              the count check must catch
  resilience  MONET's resilience model on the card's own times: gemma3-1b as
              in train, 3 steps (the step time), a synchronous save_checkpoint
              of params and AdamW state to $TMPDIR (write seconds, bytes on
              disk) and a fresh Trainer's restore_or_init (read seconds; every
              leaf bit for bit, and a planted fault, one leaf one ulp off,
              that the check must catch); the port's core then picks the
              checkpoint interval for 1 and 256 cards under
              datacenter_fault_model() (each k held against an exhaustive
              enumeration of Daly's efficiency), beside MONET's own prediction
              (evaluate_goodput on gemma3-1b's training graph), its six 4-chip
              strategies and degrade(dp4, 1 chip) -> dp3 with no findings and
              no fresh signing
  monet_cli   python -m repro_torch.verify (the acceptance matrix),
              python -m repro_torch.core.faultinject --seed 0 (21/21 caught) and
              python -m repro_torch.launch.serve on both sites, side by side:
              exit codes and host seconds; MONET's KV bytes a token at
              gemma3-1b's widths beside the port's real cache (init_cache,
              8 x 1024, as serve allocates it)
  examples    the twins of the nine examples (examples/port/), in process:
              train_lm's LM-100M at full size as its docstring runs it
              (--steps 120, then --steps 300 on the same --ckpt-dir, resuming
              at step 100 once step 120's commit is removed): step time,
              tokens/s, peak memory, checkpoints (seconds, bytes), losses,
              launches a step (fused_adam only), the replayed steps 101-120
              equal to the first call's; the same with use_flash, 8 steps:
              losses and grad norms within 1e-3 and 1e-2 relative of the
              plain run's, and again with the flash output zeroed (a planted
              fault that must read above them), flash and rmsnorm launches,
              each kernel at LM-100M's shapes against its plain version with
              planted faults (fused_adam over LM-100M's parameter tree, bit
              for bit), timed beside its bound, plain version and library
              call; checkpointing_ga on the CPU and the
              card (the same front, loss 32768 and grad norm 512); the seven
              host twins side by side (exit 0, CSV rows, host seconds)
Then the ``{"kernels": [...]}`` line, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``.  Any failure raises: the exit code is
non-zero and the last line is not printed.  There is no CPU fallback.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import ctypes
import importlib.util
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False")

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.ckpt import store as ckpt_store  # noqa: E402
from repro_torch.ckpt.store import latest_step, load_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.configs import get_config, get_shape, smoke_config  # noqa: E402
from repro_torch.convert import tree_flatten_with_path, tree_map  # noqa: E402
from repro_torch.core import (ParallelStrategy, datacenter_cluster,  # noqa: E402
                              datacenter_fault_model, degrade, evaluate_goodput,
                              evaluate_parallel, kv_bytes_per_token,
                              optimal_checkpoint_interval, remat_policy, schedule,
                              stored_activation_bytes, strategy_space, tpu_v5e_like)
from repro_torch.core import resilience  # noqa: E402
from repro_torch.core.engine import get_engine, sign_count  # noqa: E402
from repro_torch.core.fusion_search import fusion_partition  # noqa: E402
from repro_torch.core.trace import flop_count, recording  # noqa: E402
from repro_torch.core.remat_policy import resolve_remat  # noqa: E402
from repro_torch.data.pipeline import make_batch, make_tokens  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import fused_adam as fad  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.kernels import ssd_chunk as sc  # noqa: E402
from repro_torch.launch import ac_search  # noqa: E402
from repro_torch.launch import train as train_module  # noqa: E402
from repro_torch.launch.train import Trainer  # noqa: E402
from repro_torch.models import attention, moe, ssm, transformer  # noqa: E402
from repro_torch.models.transformer import (abstract_params, init_cache, init_params,  # noqa: E402
                                            logits_fn)
from repro_torch.optim.optimizers import make_optimizer  # noqa: E402
from repro_torch.training.loss import lm_loss  # noqa: E402
from repro_torch.distributed.sharding import whole  # noqa: E402
from repro_torch.training.train_step import make_serve_step  # noqa: E402

DEV = "cuda"
PEAK_FLOPS = 989e12      # H100 SXM, dense bf16 tensor cores (data sheet)
PEAK_FP32 = 67e12        # H100 SXM, fp32 outside the tensor cores (data sheet)
PEAK_BYTES = 3.35e12     # H100 SXM, HBM3 (data sheet)
TRAIN_STEPS = 6
TRAIN_BATCH = 4
SEQ = 4096
#: train_mla: minicpm3-4b at full width, depth cut to 4 of 62 layers (62 need
#: ≈ 12 B/param × 4.3 B ≈ 51 GB of weights and AdamW state before activations)
MLA_LAYERS, MLA_BATCH, MLA_STEPS = 4, 2, 4
#: train_moe: olmoe-1b-7b at full width, depth cut to 8 of 16 layers (16 need
#: ≈ 12 B/param × 6.9 B ≈ 83 GB of weights, gradients and AdamW state)
MOE_LAYERS, MOE_BATCH, MOE_STEPS = 8, 4, 6
#: train_moe: the first MoE layer's aux loss at step 0 (router at its "small"
#: init: gates near uniform, so E · Σ me·ce ≈ E · (1/E) · 1 = 1).  The logged
#: aux loss sums the layers' terms (as the reference's), and deeper layers' terms
#: grow at init as the random residual stream correlates the tokens' routing
#: (1.0 → 1.7–2.4 over 8 layers in a CPU rehearsal at full width)
MOE_AUX_RANGE = (0.9, 1.5)
#: serve: sequences, prompt tokens, greedy tokens, cache slots, warm-up calls
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW, SERVE_MAX_SEQ, SERVE_WARMUP = 8, 512, 256, 1024, 16

TC_PATH = ("mma.sync.aligned.m16n8k16 bf16 x bf16 -> fp32 (tensor cores), ldmatrix, "
           "cp.async two-stage ring")
KERNELS = {
    "flash_fwd": {"route": "cuda",
                  "source": "src/repro_torch/kernels/csrc/flash_fwd.cu",
                  "replaces": "src/repro/kernels/flash_attention.py:100",
                  "bf16_path": "flash_fwd_tc_kernel: " + TC_PATH},
    "flash_dq": {"route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/flash_dq.cu",
                 "replaces": "src/repro/kernels/flash_attention.py:209",
                 "bf16_path": "flash_dq_tc_kernel: " + TC_PATH},
    "flash_dkv": {"route": "cuda",
                  "source": "src/repro_torch/kernels/csrc/flash_dkv.cu",
                  "replaces": "src/repro/kernels/flash_attention.py:227",
                  "bf16_path": "flash_dkv_tc_kernel: " + TC_PATH},
    "rmsnorm": {"route": "cuda",
                "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
                "replaces": "src/repro/kernels/rmsnorm.py:28"},
    "rmsnorm_bwd": {"route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
                    "replaces": "autograd of the plain version; the TPU kernel "
                                "src/repro/kernels/rmsnorm.py:28 has no backward"},
    "fused_adam": {"route": "cuda",
                   "source": "src/repro_torch/kernels/csrc/fused_adam.cu",
                   "replaces": "src/repro/kernels/fused_adam.py:44"},
    "ssd_chunk": {"route": "cuda",
                  "source": "src/repro_torch/kernels/csrc/ssd_chunk.cu",
                  "replaces": "src/repro/kernels/ssd_chunk.py:62",
                  "bf16_path": "ssd_chunk_tc_kernel: " + TC_PATH},
}
FLASH = ("flash_fwd", "flash_dq", "flash_dkv")
#: the kernels whose bf16 inputs run on the tensor cores: (device kernel of
#: bf16, device kernel of fp32, instantiations in the library) — one per head
#: dim for flash, one per (hp, N) for the SSD chunk
TENSOR_CORE = {
    **{name: (f"fa::{name}_tc_kernel<", f"fa::{name}_kernel<", len(fa.HEAD_DIMS))
       for name in FLASH},
    "ssd_chunk": ("ssd::ssd_chunk_tc_kernel<", "ssd::ssd_chunk_kernel<",
                  len(sc.HEAD_DIMS) * len(sc.STATE_DIMS)),
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


def norm_widths(gemma, mamba, mla, moe_cfg, lm100m) -> tuple[int, ...]:
    """The widths the training and serve paths normalise through
    ``ops.rmsnorm``: the block norms, mamba's gated norm, MLA's ``q_ln``
    and ``kv_ln``, and LM-100M's (``examples`` with ``use_flash``)."""
    return tuple(sorted({gemma.d_model, mamba.d_model, mamba.d_inner, mla.d_model,
                         mla.mla.q_lora_rank, mla.mla.kv_lora_rank, moe_cfg.d_model,
                         lm100m.d_model}))


def memory_bound_kernels(widths) -> dict[str, dict[str, int]]:
    """ptxas names (mangled-name prefixes) of the memory-bound kernels the
    training and serve paths launch, by source, each with its count of
    instantiations: the bf16 rmsnorm forward and backward at ``widths``
    (``rn::rmsnorm_kernel<T, TPR, MAXV>``, ``rn::rmsnorm_bwd_kernel<...>``,
    named by their launch geometry, which the width alone decides; widths
    that share one are named once), the backward's fixed-order sum, and
    every ``adam::adam_kernel<P, G, S>`` (the paths' two among the eight)."""
    rows = TRAIN_BATCH * SEQ
    norm = {"_ZN2rn25rmsnorm_bwd_reduce_kernel": 1}
    for d in widths:
        for bwd, name in ((False, "14rmsnorm_kernel"), (True, "18rmsnorm_bwd_kernel")):
            g = rn.grid(d, rows, True, bwd, 0)
            norm[f"_ZN2rn{name}I13__nv_bfloat16Li{g['threads_per_row']}"
                 f"ELi{g['max_vectors_per_thread']}E"] = 1
    return {"rmsnorm": norm, "fused_adam": {"_ZN4adam11adam_kernelI": 8}}


def expect_no_spills(what, kernels, count) -> None:
    """ptxas' report (kept beside a cached library) of ``count`` kernels
    must be there and show no spill bytes."""
    if len(kernels) != count or not all("spill_stores" in k for k in kernels):
        raise AssertionError(f"{what}: no complete ptxas report ({count} kernels): {kernels}")
    spilled = [k for k in kernels if k["spill_stores"] + k["spill_loads"]]
    if spilled:
        raise AssertionError(f"{what} spill registers: {spilled}")


def phase_build(widths) -> None:
    build.load_library(build.SOURCES[0])      # builds and loads all of them
    info = build.BUILD_INFO
    emit("build", seconds=round(info["seconds"], 2), built=info["built"],
         libraries={n: os.path.relpath(p, ROOT) for n, p in info["paths"].items()},
         ptxas=info["ptxas"])
    # every tensor-core kernel, one per instantiation, spills nothing; nor
    # do the memory-bound kernels of the training paths
    for name, (_, _, count) in TENSOR_CORE.items():
        expect_no_spills(f"{name}'s tensor-core kernels",
                         [k for k in info["ptxas"][name] if "_tc_kernel" in k["kernel"]], count)
    for name, prefixes in memory_bound_kernels(widths).items():
        for prefix, count in prefixes.items():
            expect_no_spills(prefix, [k for k in info["ptxas"][name]
                                      if k["kernel"].startswith(prefix)], count)


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
    errors of ``F.scaled_dot_product_attention`` (o, and dq and dk/dv of its
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
        lo, ldq, ldk, ldv = library_outputs(case, q, k, v, do)
        errs["library"] = {"flash_fwd": max_err(lo, o_p), "flash_dq": max_err(ldq, dq_p),
                           "flash_dkv": max(max_err(ldk, dk_p), max_err(ldv, dv_p))}
        errs["library_row_rel"] = {
            "flash_fwd": row_rel_err(lo, o_p), "flash_dq": row_rel_err(ldq, dq_p),
            "flash_dkv": max(row_rel_err(ldk.to(dtype), dk_p), row_rel_err(ldv.to(dtype), dv_p))}
    if faults:
        errs["planted_faults"] = planted_faults(case, q, k, v, do, o_p, lse_p, delta, dq_p,
                                                dk_p, dv_p)
    return errs


def planted_faults(case, q, k, v, do, o_p, lse_p, delta, dq_p, dk_p, dv_p) -> dict:
    """What the bf16 checks read on four faults a kernel could have, each
    built in fp32 from the plain formulas at ``case`` and rounded as the
    kernel rounds its output: the forward dropping the last key tile (the
    tensor-core kernel's tile: 32 keys at hd 256, 64 below) of the last query
    tile of batch 0; the forward not rescaling its output accumulator when the row
    max grows (the same rows); dq dropping the last key tile (64 keys, its
    tensor-core kernel's tile) of the same rows; dk/dv dropping the first
    query tile (64 rows) that sees the key block in the middle of batch 0, kv
    head 0.  Each must read above its tolerance, so that the check at this
    shape can fail a wrong kernel."""
    B, S, T, H, Kv, hd, causal, window = case
    G, scale, bn = H // Kv, fa._scale(hd, None), 32 if hd >= 256 else 64
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

    # dq of the same rows without the last visible 64-key tile
    j0 = (int(vis[-1].nonzero().max()) // 64) * 64
    sj = torch.where(vis[:, j0:j0 + 64], s[..., j0:j0 + 64], fa.NEG_INF)
    pj = torch.exp(sj - lse_p[0, :, r0:, None])
    dpj = f32(do[0, r0:]).transpose(0, 1) @ vh[:, j0:j0 + 64].transpose(1, 2)
    dsj = pj * (dpj - delta[0, :, r0:, None]) * scale
    dq_want = dq_p[0, r0:].transpose(0, 1)
    dq_bad = f32(dq_want) - dsj @ kh[:, j0:j0 + 64]
    out["dq_last_key_tile_dropped"] = {
        "dq_row_rel": row_rel_err(dq_bad.to(dq_p.dtype), dq_want)}

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
    """o, dq, dk, dv of ``F.scaled_dot_product_attention`` in the inputs'
    dtype, in the port's layouts, dk and dv summed (in fp32) over the GQA
    group of repeated heads."""
    B, S, T, H, Kv, hd, causal, window = case
    G = H // Kv
    ql = q.transpose(1, 2).detach().requires_grad_(True)
    kl = k.repeat_interleave(G, dim=2).transpose(1, 2).detach().requires_grad_(True)
    vl = v.repeat_interleave(G, dim=2).transpose(1, 2).detach().requires_grad_(True)
    mask = (fa.attention_mask(S, T, causal, window, q.device)
            if causal or window is not None else None)
    ol = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask)
    dql, dkl, dvl = torch.autograd.grad(ol, (ql, kl, vl), do.transpose(1, 2))
    group = lambda t: t.float().reshape(B, Kv, G, T, hd).sum(2).transpose(1, 2)
    return ol.detach().transpose(1, 2), dql.transpose(1, 2), group(dkl), group(dvl)


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


def tc_grid(name, dims) -> dict:
    """Launch geometry of a tensor-core kernel, from its library's
    ``<name>_grid`` entry point: blocks, resident blocks an SM (the occupancy
    calculator), threads and dynamic shared memory a block.  ``dims``: a flash
    case, or the SSD chunk's (Bt, nc, Q, H, hp, G, N)."""
    if name == "ssd_chunk":
        Bt, nc, _, H, hp, _, N = dims
        args = (Bt, nc, H, hp, N)
    else:
        B, S, T, H, Kv, hd, _, _ = dims
        args = (B, T, Kv, hd) if name == "flash_dkv" else (B, S, H, hd)
    fn = getattr(build.load_library(name), name + "_grid")
    fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 4)()
    if fn(*args, out) != 0:
        raise RuntimeError(f"{name}_grid failed for {dims}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {"blocks": out[0], "blocks_per_sm": out[1], "threads": out[2],
            "smem_bytes": out[3], "sms": sms, "waves": out[0] / (out[1] * sms)}


def check_dispatch() -> dict:
    """One bf16 and one fp32 call of each tensor-core kernel's wrapper under
    torch.profiler: the one device kernel that ran must be the tensor-core
    kernel for bf16 and the fp32 FMA kernel for fp32 (``TENSOR_CORE``)."""
    from torch.profiler import ProfilerActivity, profile
    case = SMALL_CASES[2]
    B, S, T, H, Kv, hd, causal, window = case
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, do = make_inputs(0, B, S, T, H, Kv, hd, dtype)
        o, lse = fa.flash_fwd_cuda(q, k, v, causal, window)
        delta = ops.attention_delta(o, do)
        bw = (q, k, v, do, lse, delta, causal, window)
        ssd_args = ssd_inputs(0, 1, 2, 64, 2, 16, 1, 16, dtype)
        torch.cuda.synchronize()
        ran = {}
        for name, call in (("flash_fwd", lambda: fa.flash_fwd_cuda(q, k, v, causal, window)),
                           ("flash_dq", lambda: fa.flash_dq_cuda(*bw)),
                           ("flash_dkv", lambda: fa.flash_dkv_cuda(*bw)),
                           ("ssd_chunk", lambda: sc.ssd_chunk_cuda(*ssd_args))):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                call()
                torch.cuda.synchronize()
            ran[name] = sorted({e.key for e in prof.key_averages()
                                if e.device_type == torch.autograd.DeviceType.CUDA
                                and ("fa::flash_" in e.key or "ssd::" in e.key)})
            tc, fma, _ = TENSOR_CORE[name]
            want = tc if dtype == torch.bfloat16 else fma
            if len(ran[name]) != 1 or want not in ran[name][0]:
                raise AssertionError(f"{name} {dtype}: ran {ran[name]}, expected {want}…")
        out[str(dtype).replace("torch.", "")] = ran
    return out


def phase_kernels_flash(cfg, moe_cfg) -> dict:
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
                            for n in FLASH}})
    worst = lambda key: {n: max(c[n][key] for c in per_case) for n in FLASH}
    emit("kernels_bf16_small", cases=len(SMALL_CASES), tol=2e-2, rtol=2e-2,
         tol_row_rel=BF16_ROW_RTOL, tol_lse=BF16_LSE_ATOL,
         max_abs_err=worst("kernel"), library_max_abs_err=worst("library"),
         max_row_rel_err=worst("kernel_row_rel"), library_max_row_rel_err=worst("library_row_rel"),
         max_lse_abs_err=max(c["lse_abs"] for c in per_case), by_case=per_case)
    emit("kernels_dispatch", ran=check_dispatch())

    # bf16 at the shapes the training runs give the kernels: gemma3's global
    # layer (window None) and sliding-window layer, and olmoe's layer (hd 128,
    # H = Kv = 16: no GQA group)
    out = {}
    layers = (("global", cfg, None), ("window", cfg, cfg.window), ("olmoe", moe_cfg, None))
    for tag, c, window in layers:
        case = (TRAIN_BATCH, SEQ, SEQ, c.n_heads, c.n_kv_heads, c.head_dim_, True, window)
        errs = check_case(case, torch.bfloat16, 2e-2, 2e-2, seed=100, faults=True)
        torch.cuda.empty_cache()
        timed = time_case(case, torch.bfloat16, reps=5)
        torch.cuda.empty_cache()
        for name in FLASH:
            timed[name]["max_abs_err"] = errs[name]
            timed[name]["max_row_rel_err"] = errs["row_rel"][name]
        timed["flash_fwd"]["lse_abs_err"] = errs["lse_abs"]
        for name in FLASH:
            timed[name]["grid"] = tc_grid(name, case)
        out[tag] = timed
        emit("kernels_bf16", layer=tag, arch=c.name, shape=dict(zip(
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
    """ms of the autograd backward of ``fn`` with respect to all its inputs
    (for the SSD chunk: autograd of the kernel's plain version)."""
    leaves = [a.detach().requires_grad_(True) for a in args]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    cots = [torch.ones_like(o) for o in outs]
    ms = time_ms(lambda: torch.autograd.grad(outs, leaves, cots, retain_graph=True), reps)
    del outs
    return ms


# -- rmsnorm --------------------------------------------------------------------


#: bf16 at the training shapes: dscale (fp32 sums over 16384 rows on both
#: sides, in other orders) within this share of its largest entry
DSCALE_RTOL = 1e-4
L2_BYTES = 50 * 2 ** 20  # H100's L2


def rmsnorm_bound(rows, d, itemsize) -> dict:
    """x read and y written once, scale read once; sum of squares, mean,
    rsqrt and two products: about 4 fp32 operations an element."""
    return bound(4 * rows * d, 2 * rows * d * itemsize + 4 * d, PEAK_FP32)


def rmsnorm_bwd_bound(rows, d, itemsize) -> dict:
    """x and dy read and dx written once, scale read and dscale written
    once; two sums (3 operations), dx (4) and dscale's term and sum (3): about
    10 fp32 operations an element."""
    return bound(10 * rows * d, 3 * rows * d * itemsize + 8 * d, PEAK_FP32)


def rel_to_max(got, want) -> float:
    """max |got − want| over max |want|."""
    return max_err(got, want) / float(want.float().abs().max())


def norm_inputs(rng, shape, dtype):
    return (randn(rng, shape, dtype), randn(rng, shape[-1:], torch.float32, 0.1),
            randn(rng, shape, dtype))


def check_rmsnorm(shape, dtype, tol, seed) -> float:
    x, scale, _ = norm_inputs(generator(seed), shape, dtype)
    y = rn.rmsnorm_cuda(x, scale)
    torch.cuda.synchronize()
    if y.dtype != x.dtype or y.shape != x.shape:
        raise AssertionError(f"rmsnorm: got {y.dtype} {tuple(y.shape)} for {x.dtype} {shape}")
    return expect_close("rmsnorm", y, rn.rmsnorm_plain(x, scale), tol, tol, f"{shape} {dtype}")


def check_rmsnorm_bwd_fp32(shape, seed) -> dict:
    """The backward kernel against autograd of the plain forward, fp32: dx
    within 5e-5 (abs and rel), dscale within 5e-5 of its largest entry."""
    x, scale, dy = norm_inputs(generator(seed), shape, torch.float32)
    dx, ds = rn.rmsnorm_bwd_cuda(x, scale, dy)
    xa, sa = x.clone().requires_grad_(True), scale.clone().requires_grad_(True)
    want_dx, want_ds = torch.autograd.grad(rn.rmsnorm_plain(xa, sa), (xa, sa), dy)
    torch.cuda.synchronize()
    err = {"dx": expect_close("rmsnorm_bwd", dx, want_dx, 5e-5, 5e-5, f"{shape} fp32 (dx)"),
           "dscale_rel": rel_to_max(ds, want_ds)}
    if not (torch.isfinite(ds).all() and err["dscale_rel"] <= 5e-5):
        raise AssertionError(f"rmsnorm_bwd disagrees with autograd of the plain version at "
                             f"{shape} fp32: dscale {err['dscale_rel']:.3e} of its largest entry "
                             "(tolerance 5e-5)")
    return err


def rotating_sets(make, nbytes: int) -> list:
    """Enough input sets from ``make(i)`` that the bytes read between two
    uses of one set (``nbytes`` a set) exceed twice the L2: every timed call
    finds its inputs in device memory, as the training step does."""
    return [make(i) for i in range(max(2, math.ceil(2 * L2_BYTES / nbytes) + 1))]


def time_rotating(fn, sets, reps: int) -> float:
    """Mean milliseconds of ``fn(*set)`` by CUDA events over ``reps`` calls
    that take the sets in turn, after one warm-up call on each."""
    for args in sets:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(*sets[i % len(sets)])
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def last_block_rows(d, rows, bf16, bwd, device) -> torch.Tensor:
    """The rows the grid's last block takes (``rn.grid``: block ``b`` takes
    ``b·rows_at_once + i + k·blocks·rows_at_once``)."""
    geo = rn.grid(d, rows, bf16, bwd, device.index)
    blocks, at_once = geo["blocks"], geo["rows_at_once"]
    last = torch.arange((blocks - 1) * at_once, rows, blocks * at_once, device=device)
    mine = (last[:, None] + torch.arange(at_once, device=device)).flatten()
    return mine[mine < rows]


def rmsnorm_fwd_faults(x, scale, y_p) -> dict:
    """What the forward's row check reads on a fault the kernel could have,
    built from the plain formula: the grid's last block normalising its rows
    by a sum of squares that holds the first half of each row only (a row
    reduction one step short), rounded as the kernel rounds.  Must read
    above ``BF16_ROW_RTOL``."""
    d = x.shape[-1]
    rows = x.numel() // d
    mine = last_block_rows(d, rows, x.dtype == torch.bfloat16, False, x.device)
    xf, want = x.float().reshape(rows, d)[mine], y_p.reshape(rows, d)[mine]
    r = torch.rsqrt(xf[:, :d // 2].square().sum(dim=-1, keepdim=True) / d + 1e-6)
    out = {"half_row_sum_of_squares": {"y_row_rel": row_rel_err((xf * r * (1.0 + scale)
                                                                 ).to(x.dtype), want),
                                       "rows_faulty": int(mine.numel())}}
    if out["half_row_sum_of_squares"]["y_row_rel"] <= BF16_ROW_RTOL:
        raise AssertionError(f"the rmsnorm checks at rows={rows} d={d} cannot see a planted "
                             f"fault: {out}")
    return out


def rmsnorm_bwd_faults(x, scale, dy, dx_p, ds_p) -> dict:
    """What the bf16 checks read on two faults the backward kernel could
    have, built from the plain formulas: dx without its ``mean(w·g·x)``
    term, rounded as the kernel rounds; dscale without the partial of the
    grid's last block (its rows from ``rn.grid``).  Each must read above its
    tolerance."""
    d = x.shape[-1]
    rows = x.numel() // d
    xf, g = x.float().reshape(rows, d), dy.float().reshape(rows, d)
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + 1e-6)
    dx_bad = (g * (1.0 + scale) * r).to(x.dtype)
    mine = last_block_rows(d, rows, x.dtype == torch.bfloat16, True, x.device)
    ds_bad = ds_p - (g[mine] * (xf[mine] * r[mine])).sum(dim=0)
    out = {"dx_mean_term_dropped": {"dx_row_rel": row_rel_err(dx_bad, dx_p.reshape(rows, d))},
           "dscale_last_block_dropped": {"dscale_rel": rel_to_max(ds_bad, ds_p),
                                         "rows_dropped": int(mine.numel())}}
    if (out["dx_mean_term_dropped"]["dx_row_rel"] <= BF16_ROW_RTOL
            or out["dscale_last_block_dropped"]["dscale_rel"] <= DSCALE_RTOL):
        raise AssertionError(f"the rmsnorm_bwd checks at rows={rows} d={d} cannot see planted "
                             f"faults: {out}")
    return out


def time_rmsnorm(rows, d, cold=True) -> dict:
    """Forward and backward at (rows, d) in bf16: checked (forward 2e-2 and a
    row within ``BF16_ROW_RTOL``; backward dx a row within ``BF16_ROW_RTOL``,
    dscale within ``DSCALE_RTOL`` of its largest entry; a planted fault in the
    forward, two in the backward)
    and timed over rotated inputs (a cold L2; with ``cold`` false one input
    set, warm in L2, as a decode step's norm finds the row its previous
    operation just wrote), beside the plain versions, autograd of the plain
    forward (the backward before the kernel) and the library: ``F.rms_norm``
    with weight (1 + scale) in x's dtype and its autograd backward, which the
    port never calls."""
    dt = torch.bfloat16
    x, scale, dy = norm_inputs(generator(11), (rows, d), dt)
    y, y_p = rn.rmsnorm_cuda(x, scale), rn.rmsnorm_plain(x, scale)
    dx, ds = rn.rmsnorm_bwd_cuda(x, scale, dy)
    dx_p, ds_p = rn.rmsnorm_bwd_plain(x, scale, dy)
    torch.cuda.synchronize()
    fwd = {"max_abs_err": expect_close("rmsnorm", y, y_p, 2e-2, 2e-2, f"rows={rows} d={d} bf16"),
           "max_row_rel_err": row_rel_err(y, y_p)}
    bwd = {"max_abs_err": expect_close("rmsnorm_bwd", dx, dx_p, 2e-2, 2e-2,
                                       f"rows={rows} d={d} bf16 (dx)"),
           "max_row_rel_err": row_rel_err(dx, dx_p), "dscale_rel_err": rel_to_max(ds, ds_p)}
    if (fwd["max_row_rel_err"] > BF16_ROW_RTOL or bwd["max_row_rel_err"] > BF16_ROW_RTOL
            or not (torch.isfinite(ds).all() and bwd["dscale_rel_err"] <= DSCALE_RTOL)):
        raise AssertionError(f"rmsnorm kernels disagree with their plain versions at rows={rows} "
                             f"d={d} bf16: forward {fwd}, backward {bwd} (tolerances: a row "
                             f"{BF16_ROW_RTOL}, dscale {DSCALE_RTOL} of its largest entry)")
    fwd["planted_faults"] = rmsnorm_fwd_faults(x, scale, y_p)
    bwd["planted_faults"] = rmsnorm_bwd_faults(x, scale, dy, dx_p, ds_p)
    del y, y_p, dx, dx_p

    size = rows * d * x.element_size()
    sets = (rotating_sets(lambda i: norm_inputs(generator(20 + i), (rows, d), dt), size)
            if cold else [(x, scale, dy)])
    w = (1.0 + scale).to(dt)
    fwd.update(ms=time_rotating(lambda a, s, _: rn.rmsnorm_cuda(a, s), sets, 20),
               plain_ms=time_ms(lambda: rn.rmsnorm_plain(x, scale), 5),
               library_ms=time_rotating(lambda a, _, __: F.rms_norm(a, (d,), w, 1e-6), sets, 20),
               grid=rn.grid(d, rows, True, False, x.device.index), l2="cold" if cold else "warm",
               **rmsnorm_bound(rows, d, x.element_size()))
    bwd.update(ms=time_rotating(rn.rmsnorm_bwd_cuda, sets, 20),
               plain_ms=time_ms(lambda: rn.rmsnorm_bwd_plain(x, scale, dy), 5),
               autograd_of_plain_ms=backward_ms(rn.rmsnorm_plain, (x, scale), 5),
               grid=rn.grid(d, rows, True, True, x.device.index), l2="cold" if cold else "warm",
               **rmsnorm_bwd_bound(rows, d, x.element_size()))
    # library backward: autograd of F.rms_norm, one graph a set
    graphs = []
    for a, _, g in sets:
        a, wl = a.detach().requires_grad_(True), w.detach().requires_grad_(True)
        graphs.append((F.rms_norm(a, (d,), wl, 1e-6), a, wl, g))
    bwd["library_ms"] = fwd["library_bwd_ms"] = time_rotating(
        lambda out, a, wl, g: torch.autograd.grad(out, (a, wl), g, retain_graph=True), graphs, 20)
    del graphs, sets
    return {"forward": fwd, "backward": bwd}


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
    return check_adam_tree([leaf], count, tol)[0]


def check_adam_tree(leaves, count, tol, fault=None) -> tuple[float, int]:
    """One multi-tensor call of the kernel on copies of ``leaves`` against
    ``fused_adam_plain`` on each leaf's copy; every p, m and v within ``tol``
    (abs and rel; 0: bit for bit).  ``fault`` = (kind, i) plants a fault:
    ``"left_out"`` leaves leaf i out of the kernel's call, ``"p_unstored"``
    puts leaf i's p back as it was after the call, as a kernel that never
    stored it would; the check then returns what it reads instead of
    raising.  Returns (max abs error, launches of the call)."""
    kind, at = fault or (None, None)
    cnt = torch.tensor(count, dtype=torch.int32, device=DEV)
    mine = [[t.clone() for t in leaf] for leaf in leaves]
    before = ops.LAUNCHES["fused_adam"]
    fad.fused_adam_multi_cuda(
        *zip(*[m for i, m in enumerate(mine) if not (kind == "left_out" and i == at)],
             strict=True), cnt, **ADAM_HP)
    launched = ops.LAUNCHES["fused_adam"] - before
    if kind == "p_unstored":
        mine[at][0].copy_(leaves[at][0])
    worst = 0.0
    for i, (leaf, got) in enumerate(zip(leaves, mine, strict=True)):
        plain = [t.clone() for t in leaf]
        fad.fused_adam_plain(*plain, cnt, **ADAM_HP)
        p, g, m, _ = leaf
        what = f"leaf {i} n={p.numel()} p {p.dtype} g {g.dtype} m/v {m.dtype} count {count}"
        for k, a, b in zip("pgmv", got, plain, strict=True):
            if k == "g":
                continue
            if fault is None:
                worst = max(worst, expect_close("fused_adam", a, b, tol, tol, f"{what} ({k})"))
            else:
                worst = max(worst, max_err(a, b))
        del plain
    del mine
    return worst, launched


def time_adam(shape, p_dt, g_dt, s_dt) -> dict:
    """One leaf (a list of one for the multi-tensor kernel), checked bit for
    bit against the plain version."""
    n = math.prod(shape)
    p, g, m, v = leaf = adam_leaf(generator(13), n, p_dt, g_dt, s_dt)
    cnt = torch.tensor(100, dtype=torch.int32, device=DEV)
    err = check_adam(leaf, 100, 0.0)
    torch.cuda.empty_cache()
    ms = time_ms(lambda: fad.fused_adam_multi_cuda([p], [g], [m], [v], cnt, **ADAM_HP), 10)
    plain_ms = time_ms(lambda: fad.fused_adam_plain(p, g, m, v, cnt, **ADAM_HP), 3)
    out = {"max_abs_err": err, "tol": 0.0, "ms": ms, "plain_ms": plain_ms,
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


def adam_launches(dtypes) -> int:
    """Launches one multi-tensor call takes for leaves of these (p, g, m/v)
    dtypes: one per combination and ``fad.MAX_LEAVES`` leaves."""
    return sum(math.ceil(n / fad.MAX_LEAVES) for n in Counter(dtypes).values())


def leaf_dtypes(leaves):
    return [(p.dtype, g.dtype, m.dtype) for p, g, m, _ in leaves]


#: a tree for the multi-tensor launch: sizes on both sides of the kernel's
#: 8-element vector and 65536-element chunk, and more leaves than one launch
#: holds
ADAM_TREE_SIZES = [1, 7, 8, 13, 100, 1000, 65535, 65536, 65537, 131081, 200003, 1_000_003]
ADAM_DTYPES = [(torch.bfloat16, torch.bfloat16, torch.float32),
               (torch.bfloat16, torch.float32, torch.float32),
               (torch.float32, torch.float32, torch.bfloat16),
               (torch.bfloat16, torch.bfloat16, torch.bfloat16)]


def check_adam_trees() -> dict:
    """The multi-tensor kernel on two trees, bit for bit: all fp32, with
    more leaves than one launch takes; and every dtype combination in one
    call.  Launches equal ``adam_launches``."""
    rng = np.random.default_rng(3)
    sizes = ADAM_TREE_SIZES + [int(n) for n in rng.integers(1, 5000, 2 * fad.MAX_LEAVES)]
    f32 = torch.float32
    out = {}
    for tag, dts in (("fp32", [(f32, f32, f32)]),
                     ("mixed_dtypes", [(f32, f32, f32), *ADAM_DTYPES])):
        n_leaves = len(sizes) if tag == "fp32" else 40
        leaves = [adam_leaf(generator(100 + i), sizes[i], *dts[i % len(dts)])
                  for i in range(n_leaves)]
        err, launched = check_adam_tree(leaves, 100, 0.0)
        if launched != adam_launches(leaf_dtypes(leaves)):
            raise AssertionError(f"fused_adam on the {tag} tree: {launched} launches, expected "
                                 f"{adam_launches(leaf_dtypes(leaves))}")
        out[tag] = {"leaves": n_leaves, "launches": launched, "max_abs_err": err, "tol": 0.0}
    return out


def adam_tree_bound(leaves) -> dict:
    out = {"flops": 0, "bytes": 0}
    for p, g, m, _ in leaves:
        b = adam_bound(p.numel(), p.dtype, g.dtype, m.dtype)
        out["flops"] += b["flops"]
        out["bytes"] += b["bytes"]
    return bound(out["flops"], out["bytes"], PEAK_FP32)


def time_adam_tree(cfg) -> dict:
    """One multi-tensor call over the whole parameter tree of ``cfg`` (its
    params' dtypes, fp32 m and v, random gradients): checked against
    ``fused_adam_plain`` leaf by leaf, bit for bit (two planted faults on
    the largest leaf, left out of the call and its p left unstored, must read
    above that), timed beside the plain version leaf by leaf, and beside it
    the same tree all in fp32 through the kernel and through
    ``torch._fused_adamw_``, the library yardstick (one dtype for
    everything; the port never calls it)."""
    params = [p.detach() for p in tree_flatten_with_path(init_params(cfg, 0, DEV)).values()]
    rng = generator(14)
    leaves = [(p, randn(rng, p.shape, p.dtype), randn(rng, p.shape, torch.float32, 0.1),
               randn(rng, p.shape, torch.float32).abs() * 0.01) for p in params]
    del params
    err, launched = check_adam_tree(leaves, 100, 0.0)
    torch.cuda.empty_cache()
    biggest = max(range(len(leaves)), key=lambda i: leaves[i][0].numel())
    faults = {}
    for kind in ("left_out", "p_unstored"):
        faults[f"largest_leaf_{kind}"] = {
            "max_abs_err": check_adam_tree(leaves, 100, 0.0, fault=(kind, biggest))[0]}
        torch.cuda.empty_cache()
    if (launched != adam_launches(leaf_dtypes(leaves))
            or min(f["max_abs_err"] for f in faults.values()) <= 0.0):
        raise AssertionError(f"fused_adam on the {cfg.name} tree: {launched} launches "
                             f"(expected {adam_launches(leaf_dtypes(leaves))}), planted faults "
                             f"read {faults}")
    cnt = torch.tensor(100, dtype=torch.int32, device=DEV)
    ps, gs, ms, vs = (list(t) for t in zip(*leaves, strict=True))
    out = {"leaves": len(leaves), "elements": sum(p.numel() for p in ps), "launches": launched,
           "max_abs_err": err, "tol": 0.0, "planted_faults": faults,
           "ms": time_ms(lambda: fad.fused_adam_multi_cuda(ps, gs, ms, vs, cnt, **ADAM_HP), 5),
           "plain_ms": time_ms(lambda: [fad.fused_adam_plain(*leaf, cnt, **ADAM_HP)
                                        for leaf in leaves], 3),
           **adam_tree_bound(leaves)}
    del leaves
    for lst in (ps, gs):            # the same tree in fp32, in place of the bf16 buffers
        for i, t in enumerate(lst):
            lst[i] = t.float()
    torch.cuda.empty_cache()
    step = [torch.tensor(100.0, device=DEV) for _ in ps]
    out["all_fp32"] = {
        "ms": time_ms(lambda: fad.fused_adam_multi_cuda(ps, gs, ms, vs, cnt, **ADAM_HP), 5),
        "library_ms": time_ms(lambda: torch._fused_adamw_(
            ps, gs, ms, vs, [], step, lr=1e-3, beta1=0.9, beta2=0.95, weight_decay=0.01,
            eps=1e-8, amsgrad=False, maximize=False), 5),
        **adam_tree_bound(list(zip(ps, gs, ms, vs, strict=True)))}
    out["library_ms"] = out["all_fp32"]["library_ms"]
    out["library_note"] = ("torch._fused_adamw_ on the same tree all in fp32 (it takes one "
                           "dtype for params, grads and states)")
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


def check_ssd(args, tol, what, faults=False) -> dict:
    """The kernel against its plain version on ``args``: y and states within
    atol 10·tol and rtol tol, cum within tol (tests/test_kernels.py's); in
    bf16 also y and states a row (over hp) within ``BF16_ROW_RTOL``, returned
    under ``"row_rel"``: an absolute 0.2 on y cannot fail a wrong tile.
    With ``faults``, what the row checks read on planted faults."""
    got = sc.ssd_chunk_cuda(*args)
    want = sc.ssd_chunk_plain(*args)
    torch.cuda.synchronize()
    errs = [expect_close("ssd_chunk", u, w, atol, tol, f"{what} ({k})")
            for k, u, w, atol in zip(("y", "states", "cum"), got, want,
                                     (10 * tol, 10 * tol, tol), strict=True)]
    out = {"max_abs_err": max(errs)}
    if args[0].dtype == torch.bfloat16:
        out["row_rel"] = {k: row_rel_err(u, w) for k, u, w in zip(("y", "states"), got, want)}
        if max(out["row_rel"].values()) > BF16_ROW_RTOL:
            raise AssertionError(f"ssd_chunk disagrees with its plain version at {what}: row "
                                 f"relative errors {out['row_rel']} (tolerance "
                                 f"{BF16_ROW_RTOL})")
    if faults:
        out["planted_faults"] = ssd_planted_faults(args, want, what)
    return out


def ssd_planted_faults(args, want, what) -> dict:
    """What the bf16 row checks read on two faults the SSD kernel could have,
    built in fp32 from the plain formulas for batch 0, chunk 0, every head,
    and rounded as the kernel rounds: y without the diagonal 64 x 64 tile of
    the last row tile, and states without the last row tile's (64 rows)
    share of the sum — the rows with the least decay, so the largest share.
    Each must read above the tolerance."""
    x, dt, b, c, a = args
    Q, H = x.shape[2], x.shape[3]
    rep = H // b.shape[3]
    rows = slice((Q - 1) // 64 * 64, Q)
    xf, dtf = x[0, 0, rows].float(), dt[0, 0]                       # (r,H,hp), (Q,H)
    bh = b[0, 0].float().repeat_interleave(rep, dim=1)[rows]        # (r,H,N)
    ch = c[0, 0].float().repeat_interleave(rep, dim=1)[rows]
    cum = torch.cumsum(dtf, dim=0) * a                              # (Q,H)
    seg = cum[rows, None] - cum[None, rows]                         # (r,r,H)
    tri = torch.ones(seg.shape[:2], dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(torch.where(tri[..., None], seg, float("-inf")))
    att = torch.einsum("ihn,jhn->ijh", ch, bh) * decay
    y_diag = torch.einsum("ijh,jhp->ihp", att, xf * dtf[rows, :, None])
    y_want = want[0][0, 0, rows]
    w = torch.exp(cum[-1] - cum[rows]) * dtf[rows]                  # (r,H)
    st_tile = torch.einsum("jhn,jhp->hnp", bh * w[..., None], xf)
    st_want = want[1][0, 0]
    out = {"ssd_y_diagonal_tile_dropped": {
               "y_row_rel": row_rel_err((y_want.float() - y_diag).to(x.dtype), y_want)},
           "ssd_states_last_row_tile_dropped": {
               "states_row_rel": row_rel_err(st_want - st_tile, st_want)}}
    missed = {f"{fault}.{key}": v for fault, r in out.items() for key, v in r.items()
              if v <= BF16_ROW_RTOL}
    if missed:
        raise AssertionError(f"the bf16 SSD checks at {what} cannot see planted faults: {missed}")
    return out


SSD_CASES = [
    # Q, hp, N: the reference's test shapes (BH=3 heads, one per group, nc=2) ...
    (64, 32, 16), (128, 64, 128), (32, 16, 32),
]
#: ... and the model's layout: 8 heads on 2 groups, a ragged last row tile
#: (Q = 96) with dt as large as the model's at init, and mamba2's Q, hp, N
SSD_MODEL_CASES = [(96, 16, 32, 0.7), (256, 64, 128, 0.1)]


def ssd_reference_layout(i, Q, hp, N, dtype):
    """Inputs of the reference's layout: x (BH,nc,Q,hp), dt, b, c, a."""
    rng = generator(i)
    BH, nc = 3, 2
    x = randn(rng, (BH, nc, Q, hp), dtype)
    dt = randn(rng, (BH, nc, Q), torch.float32).abs() * 0.1
    b = randn(rng, (BH, nc, Q, N), dtype)
    c = randn(rng, (BH, nc, Q, N), dtype)
    a = -randn(rng, (BH,), torch.float32).abs() - 0.1
    return x, dt, b, c, a


def check_ssd_fp32() -> float:
    worst = 0.0
    for i, (Q, hp, N) in enumerate(SSD_CASES):
        x, dt, b, c, a = ssd_reference_layout(i, Q, hp, N, torch.float32)
        got = ops.ssd_chunk(x, dt, b, c, a)            # the reference's layout
        want = ref.ssd_chunk_ref(x, dt, b, c, a)
        torch.cuda.synchronize()
        for k, u, w, atol in zip(("y", "states", "cum"), got, want, (2e-4, 2e-4, 1e-5),
                                 strict=True):
            worst = max(worst, expect_close("ssd_chunk", u, w, atol, 2e-5,
                                            f"Q={Q} hp={hp} N={N} fp32 ({k})"))
    for Q, hp, N, dt_scale in SSD_MODEL_CASES:
        args = ssd_inputs(7, 2, 2, Q, 8, hp, 2, N, torch.float32, dt_scale)
        worst = max(worst, check_ssd(args, 2e-5, f"model layout Q={Q} hp={hp} N={N} "
                                                 "fp32")["max_abs_err"])
    return worst


def check_ssd_bf16_small() -> dict:
    """The small cases of ``check_ssd_fp32`` in bf16 (the tensor-core kernel),
    the reference's layout through the views ``ops.ssd_chunk`` makes;
    returns the largest abs and row errors."""
    worst = {"max_abs_err": 0.0, "y": 0.0, "states": 0.0}
    cases = []
    for i, (Q, hp, N) in enumerate(SSD_CASES):
        x, dt, b, c, a = ssd_reference_layout(i, Q, hp, N, torch.bfloat16)
        cases.append(((*ref.to_heads(x, dt, b, c), a), f"Q={Q} hp={hp} N={N} bf16"))
    for Q, hp, N, dt_scale in SSD_MODEL_CASES:
        cases.append((ssd_inputs(7, 2, 2, Q, 8, hp, 2, N, torch.bfloat16, dt_scale),
                      f"model layout Q={Q} hp={hp} N={N} bf16"))
    for args, what in cases:
        e = check_ssd(args, 2e-2, what)
        worst["max_abs_err"] = max(worst["max_abs_err"], e["max_abs_err"])
        for k in ("y", "states"):
            worst[k] = max(worst[k], e["row_rel"][k])
    return worst


def time_ssd(Bt, nc, Q, H, hp, G, N) -> dict:
    args = ssd_inputs(15, Bt, nc, Q, H, hp, G, N, torch.bfloat16)
    chk = check_ssd(args, 2e-2, f"B={Bt} nc={nc} Q={Q} H={H} hp={hp} N={N} bf16", faults=True)
    torch.cuda.empty_cache()
    return {"max_abs_err": chk["max_abs_err"],
            "max_row_rel_err": max(chk["row_rel"].values()), "row_rel": chk["row_rel"],
            "tol_row_rel": BF16_ROW_RTOL, "planted_faults": chk["planted_faults"],
            "ms": time_ms(lambda: sc.ssd_chunk_cuda(*args), 5),
            "plain_ms": time_ms(lambda: sc.ssd_chunk_plain(*args), 2),
            "backward_plain_ms": backward_ms(ops.ssd_chunk_heads, args, 2),
            "library_ms": None,
            "library_note": "no PyTorch call computes the SSD chunk",
            "tol": 0.2, "rtol": 2e-2,        # y: ten times the absolute tolerance
            "grid": tc_grid("ssd_chunk", (Bt, nc, Q, H, hp, G, N)),
            **ssd_bound(Bt, nc, Q, H, hp, G, N, 2)}


NORM_SHAPES = [(4, 128), (2, 33, 256), (1, 7, 5, 64), (37, 1152), (5, 2048), (3, 4096),
               (2, 8200)]


def mla_norm_shapes(mla) -> list[tuple[int, int]]:
    """(rows, d) the MLA paths give the norm: train_mla's B·S rows and a
    decode step's 8, at minicpm3's d_model, q_lora_rank and kv_lora_rank."""
    return [(rows, d) for rows in (MLA_BATCH * SEQ, SERVE_BATCH)
            for d in (mla.d_model, mla.mla.q_lora_rank, mla.mla.kv_lora_rank)]


def check_rmsnorm_dispatch() -> dict:
    """``ops.rmsnorm``'s forward and backward on bf16 CUDA tensors: one
    launch of the forward kernel and one of the backward's entry point (two
    device kernels) by the wrappers' counts, and, under torch.profiler (host
    side), the norm's autograd node ran no operator of the plain backward.
    Device kernels are counted over the training step's profile
    (``profile_step``): in sessions of a few microseconds the profiler was
    seen to drop all but the last kernel."""
    from torch.profiler import ProfilerActivity, profile
    x, scale, dy = norm_inputs(generator(30), (64, 2048), torch.bfloat16)
    x.requires_grad_(True)
    scale.requires_grad_(True)
    torch.autograd.grad(ops.rmsnorm(x, scale), (x, scale), dy)   # warm-up: loads the kernels
    torch.cuda.synchronize()
    reset_launches()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.autograd.grad(ops.rmsnorm(x, scale), (x, scale), dy)
        torch.cuda.synchronize()
    launched = {k: n for k, n in ops.LAUNCHES.items() if n}
    nodes, below = norm_backward_ops(prof)
    plain = sorted(PLAIN_NORM_OPS & set(below))
    if launched != {"rmsnorm": 1, "rmsnorm_bwd": 1} or nodes != 1 or plain:
        raise AssertionError(f"ops.rmsnorm forward and backward launched {launched}, "
                             f"{nodes} RMSNormBackward nodes, operators of the plain "
                             f"backward beneath: {plain}")
    return {"launches": launched, "operators_below_the_node": below}


def phase_kernels_more(gemma, mamba, mla, moe_cfg) -> dict:
    """rmsnorm (forward and backward), fused_adam and ssd_chunk: fp32 at
    small shapes (the norm also at MLA's shapes), then bf16 at the shapes the
    training and serve runs give them, timed; fused_adam also as one
    multi-tensor call over whole trees."""
    worst = {"rmsnorm": 0.0, "fused_adam": 0.0}
    bwd = {"dx": 0.0, "dscale_rel": 0.0}
    for i, shape in enumerate(NORM_SHAPES + mla_norm_shapes(mla)):
        worst["rmsnorm"] = max(worst["rmsnorm"],
                               check_rmsnorm(shape, torch.float32, 2e-5, seed=i))
        bwd = {k: max(v, e) for (k, v), e in zip(
            bwd.items(), check_rmsnorm_bwd_fp32(shape, seed=40 + i).values(), strict=True)}
    f32 = torch.float32
    for i, (n, count) in enumerate([(2 ** 10, 1), (3 * 2 ** 9, 100), (2 ** 16, 1),
                                    (1_000_003, 100)]):
        leaf = adam_leaf(generator(i), n, f32, f32, f32)
        worst["fused_adam"] = max(worst["fused_adam"], check_adam(leaf, count, 0.0))
    mixed = 0.0
    for i, dts in enumerate(ADAM_DTYPES):
        mixed = max(mixed, check_adam(adam_leaf(generator(10 + i), 100_003, *dts), 100, 0.0))
    trees = check_adam_trees()
    worst["ssd_chunk"] = check_ssd_fp32()
    emit("kernels_fp32_more", tol={"rmsnorm": 2e-5, "rmsnorm_bwd": {"dx": 5e-5,
                                                                    "dscale_rel": 5e-5},
                                   "fused_adam": 0.0, "fused_adam_mixed_dtypes": 0.0,
                                   "ssd_chunk": "y, states: atol 2e-4 rtol 2e-5; cum 1e-5"},
         max_abs_err={**worst, "rmsnorm_bwd": bwd, "fused_adam_mixed_dtypes": mixed},
         fused_adam_multi=trees)
    ssd_small = check_ssd_bf16_small()
    emit("kernels_bf16_small_ssd", cases=len(SSD_CASES) + len(SSD_MODEL_CASES), tol=0.2,
         rtol=2e-2, tol_row_rel=BF16_ROW_RTOL, max_abs_err=ssd_small["max_abs_err"],
         max_row_rel_err={k: ssd_small[k] for k in ("y", "states")})
    emit("kernels_dispatch_rmsnorm", **check_rmsnorm_dispatch())

    rows = TRAIN_BATCH * SEQ
    norms = {}
    for d in (gemma.d_model, mamba.d_model, mamba.d_inner):
        norms[d] = time_rmsnorm(rows, d)
        torch.cuda.empty_cache()
    mla_norms = {f"rows={r} d={d}": time_rmsnorm(r, d, cold=r > SERVE_BATCH)
                 for r, d in mla_norm_shapes(mla)}
    torch.cuda.empty_cache()
    L = mamba.n_layers
    adam = {"mamba2 scan wz (bf16 p/g, fp32 m/v)": time_adam(
                (L, mamba.d_model, mamba.d_inner), torch.bfloat16, torch.bfloat16,
                torch.float32),
            "gemma3 embed table (bf16 p/g, fp32 m/v)": time_adam(
                (gemma.vocab, gemma.d_model), torch.bfloat16, torch.bfloat16, torch.float32),
            "mamba2 scan wz, all fp32": time_adam(
                (L, mamba.d_model, mamba.d_inner), torch.float32, torch.float32,
                torch.float32),
            "olmoe one layer's expert stack moe/wi (E, d, f) (bf16 p/g, fp32 m/v)": time_adam(
                (moe_cfg.moe.n_experts, moe_cfg.d_model, moe_cfg.moe.d_ff_expert),
                torch.bfloat16, torch.bfloat16, torch.float32)}
    torch.cuda.empty_cache()
    tree = time_adam_tree(mamba)
    torch.cuda.empty_cache()
    s = mamba.ssm
    ssd_shape = (TRAIN_BATCH, SEQ // s.chunk, s.chunk, mamba.ssm_heads, s.headdim,
                 s.n_groups, s.d_state)
    ssd = time_ssd(*ssd_shape)
    torch.cuda.empty_cache()
    emit("kernels_bf16_more", tol=2e-2, tol_row_rel=BF16_ROW_RTOL, tol_dscale_rel=DSCALE_RTOL,
         rmsnorm={**{f"rows={rows} d={d}": v for d, v in norms.items()}, **mla_norms},
         fused_adam=adam, fused_adam_tree={"model": mamba.name, **tree},
         ssd_chunk={"shape": dict(zip(("B", "nc", "Q", "H", "hp", "G", "N"), ssd_shape,
                                      strict=True)), **ssd})
    shape = f"bf16 rows={rows} d={mamba.d_model}"
    others = lambda part: {**{f"d={d}": norms[d][part] for d in norms if d != mamba.d_model},
                           **{k: v[part] for k, v in mla_norms.items()}}
    return {"rmsnorm": {**norms[mamba.d_model]["forward"], "shape": shape,
                        "other_shapes": others("forward")},
            "rmsnorm_bwd": {**norms[mamba.d_model]["backward"], "shape": shape,
                            "tol_row_rel": BF16_ROW_RTOL, "tol_dscale_rel": DSCALE_RTOL,
                            "library_note": "autograd backward of F.rms_norm (dx and the "
                                            "weight's gradient)",
                            "other_shapes": others("backward")},
            "fused_adam": {**adam["mamba2 scan wz (bf16 p/g, fp32 m/v)"],
                           "shape": f"mamba2 scan wz leaf {(L, mamba.d_model, mamba.d_inner)}, "
                                    "bf16 p/g, fp32 m/v",
                           "tree": {"model": mamba.name, **tree},
                           "other_shapes": {k: v for k, v in adam.items()
                                            if not k.startswith("mamba2 scan wz (bf16")}},
            "ssd_chunk": {**ssd, "shape": "bf16 B={} nc={} Q={} H={} hp={} G={} N={}".format(
                *ssd_shape)}}


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------


def layer_norms(cfg, spec) -> int:
    """The norms a layer runs through ``ops.rmsnorm`` (forward or decode):
    ln1, ln2 when it has an MLP or a MoE layer, a mamba mixer's gated norm,
    an MLA mixer's q_ln and kv_ln."""
    return (1 + int(spec.moe or cfg.mlp != "none") + int(spec.mixer == "mamba")
            + 2 * int(spec.mixer == "mla"))


def expected_forward_launches(cfg) -> dict:
    """Kernel launches of one forward pass (no remat, no backward): per layer
    its norms, one flash_fwd for an attention mixer at S % 128 == 0 (MLA
    takes no flash kernel), one ssd_chunk for a mamba mixer; then the final
    norm."""
    out = dict.fromkeys(KERNELS, 0)
    for spec in cfg.layer_specs():
        out["rmsnorm"] += layer_norms(cfg, spec)
        out["flash_fwd"] += int(spec.mixer in ("attn", "local"))
        out["ssd_chunk"] += int(spec.mixer == "mamba")
    out["rmsnorm"] += 1
    return out


def expected_decode_launches(cfg) -> dict:
    """Kernel launches of one decode step: every layer's norms and the final
    norm; the decode steps' attention and SSM recurrence are einsums."""
    out = dict.fromkeys(KERNELS, 0)
    out["rmsnorm"] = 1 + sum(layer_norms(cfg, spec) for spec in cfg.layer_specs())
    return out


def expected_launches(cfg, params=None, optimizer="adamw") -> dict:
    """Kernel launches of one training step, derived from the model code.
    Each layer runs its forward once, and once more in the backward when its
    period is recomputed (``resolve_remat(cfg.remat)`` says to remat: every
    scanned layer, under every policy, since no policy keeps what a kernel
    wrapper allocates; the remainder layers are not recomputed).  A layer's forward launches one
    rmsnorm for each of its norms (``layer_norms``), one flash_fwd for an
    attention mixer and one
    ssd_chunk for a mamba mixer; its backward one rmsnorm_bwd for each of
    those norms (one call, two device kernels: the rows, then the
    fixed-order sum of dscale), one flash_dq and one flash_dkv for attention
    (ssd_chunk has no backward kernel).  Then the final norm and its
    backward, and, given the parameter tree ``params``, fused_adam once per
    (p, g, m/v) dtype group of AdamW's leaves (gradients in the params'
    dtypes, m and v in ``cfg.state_dtype``) and ``fad.MAX_LEAVES`` leaves;
    the other optimizers launch no kernel.  Without ``cfg.use_flash`` the
    model takes its plain attention and norms: AdamW's launches only."""
    period = cfg.scan_period()
    recomputed = (cfg.n_layers // period) * period if resolve_remat(cfg.remat)[0] else 0
    out = dict.fromkeys(KERNELS, 0)
    for i, spec in enumerate(cfg.layer_specs() if cfg.use_flash else ()):
        runs = 2 if i < recomputed else 1
        attn = int(spec.mixer in ("attn", "local"))
        mamba = int(spec.mixer == "mamba")
        norms = layer_norms(cfg, spec)
        out["flash_fwd"] += runs * attn
        out["flash_dq"] += attn
        out["flash_dkv"] += attn
        out["ssd_chunk"] += runs * mamba
        out["rmsnorm"] += runs * norms
        out["rmsnorm_bwd"] += norms
    out["rmsnorm"] += int(cfg.use_flash)
    out["rmsnorm_bwd"] += int(cfg.use_flash)
    if params is not None and optimizer == "adamw":
        state = getattr(torch, cfg.state_dtype)
        out["fused_adam"] = adam_launches((p.dtype, p.dtype, state)
                                          for p in tree_flatten_with_path(params).values())
    return out


def reset_launches() -> None:
    for name in ops.LAUNCHES:
        ops.LAUNCHES[name] = 0


def fit_and_check(cfg, batch: int, steps: int, optimizer: str = "adamw",
                  ckpt_dir: str | None = None, mesh=None) -> tuple[dict, Trainer, dict]:
    """``steps`` steps of ``Trainer.fit`` at ``batch`` × 4096 tokens with
    ``optimizer`` (AdamW on its warm-up schedule, the others at a constant
    lr, as the Trainer passes them): finite losses and grad norms, the first
    loss below ln V + 1, launch counts as derived, a checkpoint read back bit
    for bit when ``ckpt_dir`` is given; with MoE layers, the first layer's
    aux loss at step 0 inside ``MOE_AUX_RANGE`` and the layers' terms summing
    to the logged aux loss (each recorded as a device tensor, no
    synchronisation).  With ``mesh``, through ``Trainer(mesh=...)``.
    Returns (the results, the trainer, its launches)."""
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(cfg, get_shape("train_4k"), optimizer=optimizer, device=DEV,
                 ckpt_dir=ckpt_dir, ckpt_every=steps, mesh=mesh)
    terms = []
    aux_loss = moe._aux_loss

    def recording(gates, top_idx, E):
        out = aux_loss(gates, top_idx, E)
        terms.append(out.detach())
        return out

    reset_launches()
    with patched(moe, "_aux_loss", recording):
        logs = tr.fit(steps=steps, batch_override=batch)
    launches = dict(ops.LAUNCHES)
    if tr.ckpt:
        tr.ckpt.close()
    peak = torch.cuda.max_memory_allocated()

    losses = [l["loss"] for l in logs]
    gnorms = [l["grad_norm"] for l in logs]
    if len(logs) != steps or not all(math.isfinite(x) and x > 0 for x in losses):
        raise AssertionError(f"bad losses: {losses}")
    if not all(math.isfinite(x) and x > 0 for x in gnorms):
        raise AssertionError(f"bad grad norms: {gnorms}")
    if losses[0] >= math.log(cfg.vocab) + 1:
        raise AssertionError(f"first loss {losses[0]} >= ln(V) + 1")
    auxes = [l["aux_loss"] for l in logs]
    # step 0's forward: the first call of each MoE layer (the recompute
    # of remat and the later steps follow)
    n_moe = sum(spec.moe for spec in cfg.layer_specs())
    aux_terms = [float(t) for t in terms[:n_moe]]
    if cfg.moe and not (MOE_AUX_RANGE[0] <= aux_terms[0] <= MOE_AUX_RANGE[1]
                        and all(math.isfinite(x) for x in auxes)
                        and abs(sum(aux_terms) - auxes[0]) <= 1e-4 * auxes[0]):
        raise AssertionError(f"aux losses {auxes}, step 0 by layer {aux_terms}: the "
                             f"first layer's outside {MOE_AUX_RANGE}, or the terms do "
                             f"not sum to the logged {auxes[0]}")
    params, opt_state = tr._last_state
    per_step = expected_launches(cfg, params, optimizer)
    want = {name: n * steps for name, n in per_step.items()}
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want}")

    if ckpt_dir:
        if latest_step(ckpt_dir) != steps:
            raise AssertionError("no checkpoint was committed at the last step")
        tmpl = {"params": params, "opt": opt_state}
        loaded, manifest = load_checkpoint(ckpt_dir, tmpl, device="cpu")
        for (key, a), b in zip(tree_flatten_with_path(tmpl).items(),
                               tree_flatten_with_path(loaded).values(), strict=True):
            if a.dtype != b.dtype or not torch.equal(whole(a).cpu(), whole(b).cpu()):
                raise AssertionError(f"checkpoint leaf {key} differs from the live state")
        del loaded

    times = [l["time_s"] for l in logs]
    steady = float(np.median(times[1:]))
    res = {"arch": cfg.name, "layers": cfg.n_layers, "batch": batch, "seq": SEQ,
           "remat": cfg.remat, "optimizer": optimizer,
           "params": cfg.param_count(), "steps": steps, "losses": losses,
           **({"aux_losses": auxes, "aux_step0_by_layer": aux_terms,
               "aux_range_first_layer_step0": MOE_AUX_RANGE,
               "active_params": cfg.active_param_count()} if cfg.moe else {}),
           "grad_norms": gnorms, "step_s": times, "step_s_median_after_first": steady,
           "tokens_per_s": batch * SEQ / steady, "peak_memory_bytes": peak,
           "launches": launches, "launches_per_step": per_step,
           **({"checkpoint_step": manifest["step"], "checkpoint_bitexact": True}
              if ckpt_dir else {})}
    return res, tr, launches


#: each train phase's results, for ``train_mesh`` to hold its steps against
TRAIN_RESULTS: dict = {}


def phase_train(cfg, phase: str, profile: bool, batch=TRAIN_BATCH, steps=TRAIN_STEPS,
                reduced=None, mesh=None) -> dict:
    """``fit_and_check`` with a checkpoint written to ``$TMPDIR`` and read
    back; ``reduced`` names what was cut from the configuration.  Returns the
    launches."""
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        res, tr, launches = fit_and_check(cfg, batch, steps, ckpt_dir=ckpt_dir, mesh=mesh)
        TRAIN_RESULTS[phase] = res
        emit(phase, **({"reduced": reduced} if reduced else {}), **res)
        if profile:
            profile_step(tr, *tr._last_state, phase, res["launches_per_step"], batch, steps)
        return launches
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


#: remat: gemma3-1b trained under each policy, by the name reported: the four
#: named ones, and the policy of MONET's keep-set of
#: ``tests/test_system.py::test_monet_decision_drives_real_jax_step``
REMAT_KEEPSET = {"l0.fc1.out", "l0.q.out"}
REMAT_STEPS = 3
#: peak memory must rise in this order: what each policy keeps, reckoned from
#: the shapes (PERF.md)
REMAT_ORDER = ("full", "keepset", "dots", "none")


def remat_policies() -> dict[str, str]:
    """{reported name: ``cfg.remat``}; the keep-set's policy as the config
    knob names it (``save:`` and its families)."""
    return {"none": "none", "full": "full", "dots": "dots", "dots_no_batch": "dots_no_batch",
            "keepset": ac_search.policy_of(REMAT_KEEPSET)}


def order_violations(peaks: dict) -> list[str]:
    """The pairs of ``REMAT_ORDER`` whose peak memory does not rise."""
    return [f"{a} {peaks[a]} >= {b} {peaks[b]}" for a, b in zip(REMAT_ORDER, REMAT_ORDER[1:])
            if peaks[a] >= peaks[b]]


def phase_remat(cfg, profile: bool) -> dict:
    """gemma3-1b at full width and depth, batch 4 × 4096, ``REMAT_STEPS``
    steps of ``Trainer.fit`` from seed 0 under each policy: step time,
    tokens/s, peak memory and launches (derived per policy).  The policies
    choose only what is kept, so the losses and grad norms must be equal bit
    for bit, and the peaks must rise in ``REMAT_ORDER``; a planted fault (a
    policy that keeps nothing, under the name ``dots``) must break the order.
    With ``--profile``, one more step under ``full`` and under ``dots``.
    Returns the launches by policy."""
    runs, launches = {}, {}
    for name, remat in remat_policies().items():
        res, tr, launches[f"remat_{name}"] = fit_and_check(replace(cfg, remat=remat),
                                                           TRAIN_BATCH, REMAT_STEPS)
        runs[name] = res
        if profile and name in ("full", "dots"):
            profile_step(tr, *tr._last_state, f"remat_{name}", res["launches_per_step"],
                         TRAIN_BATCH, REMAT_STEPS)
        del tr           # and with it the run's weights and state, before the next
        torch.cuda.empty_cache()
    with mock.patch.dict(remat_policy.POLICIES, {"dots": remat_policy.nothing_saveable}):
        fault, tr, _ = fit_and_check(replace(cfg, remat="dots"), TRAIN_BATCH, REMAT_STEPS)
    del tr
    torch.cuda.empty_cache()

    peaks = {name: r["peak_memory_bytes"] for name, r in runs.items()}
    violations = order_violations(peaks)
    fault_violations = order_violations({**peaks, "dots": fault["peak_memory_bytes"]})
    ref = runs["none"]
    diff = {name: max(abs(a - b) for a, b in zip(r["losses"] + r["grad_norms"],
                                                 ref["losses"] + ref["grad_norms"],
                                                 strict=True))
            for name, r in runs.items()}
    emit("remat", arch=cfg.name, layers=cfg.n_layers, batch=TRAIN_BATCH, seq=SEQ,
         steps=REMAT_STEPS, keepset=sorted(REMAT_KEEPSET), order=REMAT_ORDER,
         policies={name: {key: r[key] for key in (
             "remat", "losses", "grad_norms", "step_s", "step_s_median_after_first",
             "tokens_per_s", "peak_memory_bytes", "launches_per_step")}
             for name, r in runs.items()},
         max_abs_diff_from_none=diff, order_violations=violations,
         planted_fault={"what": "a policy that keeps nothing, under the name dots",
                        "peak_memory_bytes": fault["peak_memory_bytes"],
                        "order_violations": fault_violations})
    if max(diff.values()) != 0.0 or violations or not fault_violations:
        raise AssertionError(f"remat: losses and grad norms apart from none's by {diff}, "
                             f"peak order violations {violations}, the planted fault's "
                             f"{fault_violations} (must be some)")
    return launches


#: ac_search: the legs of MONET's search, and the kernels every run under
#: their policies must launch
AC_LEGS = ("knapsack", "ga")
AC_KERNELS = ("flash_fwd", "flash_dq", "flash_dkv", "rmsnorm", "rmsnorm_bwd", "fused_adam")


def phase_ac_search(cfg) -> dict:
    """MONET's activation-checkpointing search chooses what gemma3-1b keeps:
    the knapsack at half the keep-all activation bytes and NSGA-II
    (``repro_torch.launch.ac_search``) on the training graph of MONET's GPT-2
    builder at gemma3-1b's widths, run twice from cold caches (the keep-sets
    and modelled numbers must agree); each keep-set's ``save:`` policy and
    ``full`` then train gemma3-1b at full width and depth, batch 4 × 4096,
    ``REMAT_STEPS`` steps (launches as derived, each of ``AC_KERNELS`` at
    least once; losses and grad norms equal ``full``'s bit for bit).  A
    planted fault, the GA's keep-set through a ``family_of`` that knows no
    family, gives ``nothing_saveable``, whose peak memory must differ from
    the GA policy's.  Returns the launches by policy."""
    tg, reduced = ac_search.search_graph(cfg, TRAIN_BATCH, SEQ)
    keep_all = stored_activation_bytes(tg, tg.activations)
    found = ac_search.search(tg, tpu_v5e_like())
    again = ac_search.search(tg, tpu_v5e_like())
    differ = [leg for leg in AC_LEGS
              if replace(found[leg], seconds=0.0) != replace(again[leg], seconds=0.0)]
    if differ or found["front"] != again["front"]:
        raise AssertionError(f"ac_search: a second search differs in {differ or 'the front'}")

    policies = {"full": "full", **{leg: found[leg].policy for leg in AC_LEGS}}
    runs, launches = {}, {}
    for remat in dict.fromkeys(policies.values()):
        res, tr, launched = fit_and_check(replace(cfg, remat=remat), TRAIN_BATCH, REMAT_STEPS)
        missing = [name for name in AC_KERNELS if not launched[name]]
        if missing:
            raise AssertionError(f"ac_search: {remat} launched no {missing}")
        runs[remat] = res
        del tr
        torch.cuda.empty_cache()
    for name, remat in policies.items():
        launches[f"ac_search_{name}"] = runs[remat]["launches"]
    with mock.patch.object(remat_policy, "family_of", lambda tensor_name: None):
        fault_policy = remat_policy.keepset_to_policy(found["ga"].keep)
    if fault_policy is not remat_policy.nothing_saveable:
        raise AssertionError(f"ac_search: a keep-set of no family gave {fault_policy}")
    with mock.patch.dict(remat_policy.POLICIES, {"ac_search_fault": fault_policy}):
        fault, tr, _ = fit_and_check(replace(cfg, remat="ac_search_fault"), TRAIN_BATCH,
                                     REMAT_STEPS)
    del tr
    torch.cuda.empty_cache()

    full = runs["full"]
    diff = {name: max(abs(a - b) for a, b in zip(
        runs[remat]["losses"] + runs[remat]["grad_norms"],
        full["losses"] + full["grad_norms"], strict=True))
        for name, remat in policies.items()}
    ga_peak = runs[policies["ga"]]["peak_memory_bytes"]
    emit("ac_search", arch=cfg.name, layers=cfg.n_layers, batch=TRAIN_BATCH, seq=SEQ,
         steps=REMAT_STEPS,
         graph={"nodes": len(tg.graph), "activations": len(tg.activations),
                "keep_all_bytes": keep_all, "reduced": reduced},
         modelled="MONET's analytic model on tpu_v5e_like(), not a measurement of the card",
         searches={leg: {**found[leg].summary(), "second_search_seconds": again[leg].seconds,
                         "keep": list(found[leg].keep)} for leg in AC_LEGS},
         ga_front_policies=dict(Counter(found["front"])),
         same_policy=policies["knapsack"] == policies["ga"],
         runs={name: {"remat": remat, **{key: runs[remat][key] for key in (
             "losses", "grad_norms", "step_s", "step_s_median_after_first", "tokens_per_s",
             "peak_memory_bytes", "launches_per_step")},
             **({"modelled_stored_bytes": found[name].act_bytes,
                 "modelled_cycles": found[name].latency} if name in AC_LEGS else {})}
             for name, remat in policies.items()},
         max_abs_diff_from_full=diff,
         planted_fault={"what": "the GA's keep-set through a family_of that maps every name "
                                "to None: nothing_saveable",
                        "peak_memory_bytes": fault["peak_memory_bytes"],
                        "ga_peak_memory_bytes": ga_peak})
    if max(diff.values()) != 0.0 or fault["peak_memory_bytes"] == ga_peak:
        raise AssertionError(f"ac_search: losses and grad norms apart from full's by {diff}, "
                             f"or the planted fault's peak {fault['peak_memory_bytes']} equals "
                             f"the GA policy's {ga_peak}")
    return launches


#: train_opt: the optimizers that launch no kernel, on gemma3-1b
OPTIMIZERS = ("sgd_momentum", "adafactor", "galore_adamw")
OPT_STEPS = 4


def phase_train_opt(cfg) -> dict:
    """gemma3-1b at full width and depth, batch 4 × 4096, ``OPT_STEPS`` steps
    of ``Trainer.fit`` with each of ``OPTIMIZERS`` (``fit_and_check``: finite
    losses and grad norms, launches, a checkpoint to ``$TMPDIR`` read back
    bit for bit), the state tree's keys, shapes and dtypes as ``opt.init``
    gives them (on the meta device), the time of one ``opt.update`` over the
    whole tree by CUDA events beside AdamW's (one ``fused_adam_multi`` call),
    and peak memory.  Returns the launches by optimizer."""
    launches, out = {}, {}
    rng = generator(21)
    for name in OPTIMIZERS:
        ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
        try:
            res, tr, launches[f"train_opt_{name}"] = fit_and_check(
                cfg, TRAIN_BATCH, OPT_STEPS, optimizer=name, ckpt_dir=ckpt_dir)
        finally:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
        params, state = tr._last_state
        meta = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), params)
        want = {k: (tuple(t.shape), t.dtype) for k, t in
                tree_flatten_with_path(tr.opt.init(meta)).items()}
        got = {k: (tuple(t.shape), t.dtype) for k, t in tree_flatten_with_path(state).items()}
        if got != want:
            raise AssertionError(f"{name}: state tree {sorted(set(got) ^ set(want))[:5]} "
                                 f"differs from opt.init's")
        grads = tree_map(lambda p: randn(rng, p.shape, p.dtype, 1e-3), params)
        res["update_ms"] = time_ms(lambda: tr.opt.update(grads, state, params, OPT_STEPS), 3)
        res["state_bytes"] = sum(t.numel() * t.element_size()
                                 for t in tree_flatten_with_path(state).values())
        out[name] = res
        del tr, params, state, grads, meta
        torch.cuda.empty_cache()
    params = init_params(cfg, 0, DEV)
    adamw = make_optimizer("adamw", 3e-4, state_dtype=cfg.state_dtype)
    state = adamw.init(params)
    grads = tree_map(lambda p: randn(rng, p.shape, p.dtype, 1e-3), params)
    adamw_ms = time_ms(lambda: adamw.update(grads, state, params, 0), 3)
    del params, state, grads
    torch.cuda.empty_cache()
    emit("train_opt", arch=cfg.name, layers=cfg.n_layers, batch=TRAIN_BATCH, seq=SEQ,
         steps=OPT_STEPS, adamw_update_ms=adamw_ms,
         optimizers={name: {key: r[key] for key in (
             "losses", "grad_norms", "step_s", "step_s_median_after_first", "tokens_per_s",
             "peak_memory_bytes", "update_ms", "state_bytes", "launches_per_step",
             "checkpoint_bitexact")} for name, r in out.items()})
    return launches


def norm_backward_ops(prof) -> tuple[int, list]:
    """The calls of the norm's autograd node in a profile, and every
    operator that ran beneath them (on the host: each launches what it
    computes).  The node's call itself, not the engine's range around it,
    which also adds the gradients that meet at the node's inputs."""
    nodes = [e for e in prof.events() if e.name == "RMSNormBackward"]
    below, stack = set(), [c for e in nodes for c in e.cpu_children]
    while stack:
        e = stack.pop()
        below.add(e.name)
        stack.extend(e.cpu_children)
    return len(nodes), sorted(below)


#: what autograd of the plain rmsnorm runs; none may run beneath the norm's
#: backward node
PLAIN_NORM_OPS = {"aten::rsqrt", "aten::mean", "aten::pow", "aten::square", "aten::sum",
                  "aten::mul", "aten::sub", "aten::add", "aten::div", "aten::neg"}


#: device kernels by group, by name pattern
GROUPS = {"flash_fwd": ("fa::flash_fwd",), "flash_dq": ("fa::flash_dq",),
          "flash_dkv": ("fa::flash_dkv",), "ssd_chunk": ("ssd::ssd_chunk",),
          "rmsnorm_bwd": ("rn::rmsnorm_bwd",), "rmsnorm": ("rn::rmsnorm",),
          "fused_adam": ("adam::adam",),
          "matmul": ("nvjet", "gemm", "cutlass", "gemv"),
          "elementwise": ("elementwise",), "reduce": ("reduce",),
          "memcpy_memset": ("Memcpy", "Memset")}


def device_rows(prof) -> list[tuple[float, int, str]]:
    """(ms, calls, name) of every device kernel in a profile, largest first:
    kernel events only (the operator rows repeat their kernels' device
    time).  Raises when there are none."""
    rows = [(e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not rows:
        raise AssertionError("the profiler recorded no device activity")
    return sorted(rows, reverse=True)


def by_group(rows) -> dict[str, float]:
    out = dict.fromkeys([*GROUPS, "other"], 0.0)
    for ms, _, key in rows:
        group = next((g for g, pats in GROUPS.items() if any(p in key for p in pats)), "other")
        out[group] += ms
    return {g: round(ms, 2) for g, ms in out.items()}


#: CUDA runtime calls that hold the host (a synchronise, a copy from pageable
#: memory, the allocator growing), counted in a profiled step
HOST_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpyAsync", "cudaMalloc", "cudaFree")


def profile_step(tr, params, opt_state, phase: str, per_step: dict, batch: int,
                 step: int) -> None:
    """One more training step under torch.profiler: device time by kernel.
    Checks that the norm's backward went through its kernel: two device
    kernels a call (``per_step["rmsnorm_bwd"]`` calls), and no operator of
    autograd of the plain version beneath its autograd node."""
    from torch.profiler import ProfilerActivity, profile

    data = make_batch(tr.cfg, tr.shape, step, tr.seed, batch, device=DEV)
    torch.cuda.synchronize()
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tr.step_fn(params, opt_state, data, step)
        torch.cuda.synchronize()
    wall = time.time() - t0
    rows = device_rows(prof)
    total = sum(r[0] for r in rows)
    bwd_kernels = sum(n for _, n, key in rows if "rn::rmsnorm_bwd" in key)
    nodes, below = norm_backward_ops(prof)
    plain = sorted(PLAIN_NORM_OPS & set(below))
    if bwd_kernels != 2 * per_step["rmsnorm_bwd"] or nodes != per_step["rmsnorm_bwd"] or plain:
        raise AssertionError(
            f"{phase} profile: {bwd_kernels} rmsnorm_bwd device kernels and {nodes} "
            f"RMSNormBackward nodes (expected {2 * per_step['rmsnorm_bwd']} and "
            f"{per_step['rmsnorm_bwd']}); operators of the plain backward beneath them: {plain}")
    host = {e.key: {"calls": e.count, "host_ms": round(e.cpu_time_total / 1e3, 3)}
            for e in prof.key_averages() if e.key in HOST_CALLS}
    emit("profile", of=phase, step_wall_ms=wall * 1e3, device_busy_ms=total,
         by_group_ms=by_group(rows), runtime_calls=host,
         norm_backward={"nodes": nodes, "device_kernels": bwd_kernels, "operators_below": below},
         top=[{"ms": round(ms, 3), "calls": n, "kernel": key[:90]}
              for ms, n, key in rows[:16]])


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------


#: decode == forward at full width, bf16: each row's largest |decode − forward|
#: over the row's largest |forward logit|, per model.  The two paths round
#: differently (mamba2's decode keeps its state, convolution and x in fp32 where
#: the chunked forward rounds them to bf16; MLA's decode absorbs W_un), and the
#: difference grows with depth.  Set before the first run on the card (PERF.md);
#: each model's planted fault must read above its tolerance
SERVE_ROW_TOL = {"gemma3-1b": 0.1, "mamba2-1.3b": 0.75, "minicpm3-4b": 0.2,
                 "olmoe-1b-7b": 0.5}
#: ... and the median row, for a model whose largest row cannot separate a
#: sound decode from a faulty one: where two of olmoe's experts have nearly
#: equal gates, the rounding of the two paths picks either, and a token whose
#: choice flipped in some layer differs by a tail of up to 0.17 at 8 layers in
#: a CPU rehearsal at full width (median row 0.017), where the planted fault
#: reads 0.34 (median 0.25).  The median holds olmoe (its planted fault must
#: read above it), the largest row guards against a blow-up
SERVE_MEDIAN_TOL = {"olmoe-1b-7b": 0.08}


@contextlib.contextmanager
def patched(module, name, fn):
    """``module.name`` is ``fn`` inside the block (a planted fault, a probe)."""
    orig = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, orig)


def serve_calls(cfg, params, toks, steps, on_logits, feed_from=None, cache=None, start=0):
    """``steps`` calls of ``make_serve_step(cfg)`` (greedy), position
    ``start + t`` taking ``toks[:, start + t]``; from ``feed_from`` on, each
    call's token is written to the next position of ``toks`` and fed back.
    ``on_logits(pos, logits (B, V))`` sees every call's logits (the step's
    ``decode_step`` is wrapped for it).  A fresh cache of ``SERVE_MAX_SEQ``
    unless one is given.  Returns (greedy tokens (B, steps), seconds a call by
    the host clock, each call ending in a synchronise, the cache)."""
    decode = transformer.decode_step

    def recording(params, cache, cfg, inputs, pos):
        logits, cache = decode(params, cache, cfg, inputs, pos)
        on_logits(pos, logits[:, -1])
        return logits, cache

    with patched(transformer, "decode_step", recording):
        serve = make_serve_step(cfg)
    B = toks.shape[0]
    cache = init_cache(cfg, B, SERVE_MAX_SEQ, DEV) if cache is None else cache
    out = torch.empty((B, steps), dtype=torch.int32, device=DEV)
    secs = []
    for t in range(start, start + steps):
        t0 = time.perf_counter()
        nxt, cache = serve(params, cache, toks[:, t:t + 1], t)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        out[:, t - start] = nxt
        if feed_from is not None and feed_from <= t + 1 < toks.shape[1]:
            toks[:, t + 1] = nxt
    return out, secs, cache


def row_rel(got, want):
    """Per row (the last dim): the largest |got − want| over the row's
    largest |want|."""
    got, want = got.float(), want.float()
    return (got - want).abs().amax(dim=-1) / want.abs().amax(dim=-1)


def ring_at_pos(p, x, k_cache, v_cache, pos, cfg, window=None):
    """Planted fault: a ``local`` layer's slot written at ``pos``, clamped
    onto the last slot (as the reference's ``dynamic_update_slice`` would),
    instead of ``pos % T``.  Once the ring is full every slot is attended and
    their order does not matter, so the real step runs with slot ``pos % T``
    and the last slot swapped around it."""
    T = k_cache.shape[1]
    if window is None or pos < T:
        return attention.attn_decode_step(p, x, k_cache, v_cache, pos, cfg, window)
    slots = [pos % T, T - 1]
    for c in (k_cache, v_cache):
        c[:, slots] = c[:, slots[::-1]]
    out = attention.attn_decode_step(p, x, k_cache, v_cache, pos, cfg, window)
    for c in (k_cache, v_cache):
        c[:, slots] = c[:, slots[::-1]]
    return out


def ssm_without_decay(p, x, conv_cache, state, cfg):
    """Planted fault: ``ssd_decode_step`` with the state carried over
    without its decay ``exp(dt·A)`` (``A = −exp(A_log)`` set to −0, which
    nothing else in the step reads)."""
    return ssm.ssd_decode_step({**p, "A_log": torch.full_like(p["A_log"], -math.inf)}, x,
                               conv_cache, state, cfg)


def mla_heads_latent_swapped(p, x, ckv_cache, kr_cache, pos, cfg):
    """Planted fault: ``mla_decode_step`` absorbing ``wun`` read as (H, r,
    nope) instead of (r, H, nope)."""
    m, H = cfg.mla, cfg.n_heads
    wun = p["wun"].reshape(H, m.kv_lora_rank, m.qk_nope_dim).transpose(0, 1)
    return attention.mla_decode_step({**p, "wun": wun.reshape(p["wun"].shape)}, x, ckv_cache,
                                     kr_cache, pos, cfg)


_route = moe._route


def moe_gates_not_renormalised(p, x, cfg):
    """Planted fault: ``moe_apply`` combining with the top gates as the
    softmax gave them (their sum below 1) instead of renormalised."""
    def route(p, x, cfg):
        gates, _, top_idx = _route(p, x, cfg)
        return gates, gates.gather(-1, top_idx), top_idx

    with patched(moe, "_route", route):
        return moe.moe_apply(p, x, cfg)


#: per mixer, or "moe" for a model with MoE layers: the step function a planted
#: fault replaces, the fault, and the positions its run decodes (the ring only
#: shows once it wraps, at 512)
SERVE_FAULTS = {"local": ("attn_decode_step", ring_at_pos, SERVE_PROMPT + 64),
                "mamba": ("ssd_decode_step", ssm_without_decay, 64),
                "mla": ("mla_decode_step", mla_heads_latent_swapped, 64),
                "moe": ("moe_apply", moe_gates_not_renormalised, 64)}


def drop_free(cfg):
    """``cfg`` with capacity_factor E/K for a MoE model: capacity C = S, so
    its forward drops no token, as decode (one token a group) never does."""
    if not cfg.moe:
        return cfg
    return replace(cfg, moe=replace(cfg.moe, capacity_factor=cfg.moe.n_experts
                                    / cfg.moe.top_k))


def profile_decode(cfg, params, cache, toks, start, calls=8) -> dict:
    """``calls`` more greedy calls from position ``start`` under
    torch.profiler: device busy time by group, and against the host clock of
    these calls (``idle_share_profiled``: the profiler slows the host); the
    norm's device kernels counted against the calls' launches
    (``complete``: whether the profiler kept them all)."""
    from torch.profiler import ProfilerActivity, profile
    serve = make_serve_step(cfg)
    inp = toks[:, start:start + 1]
    torch.cuda.synchronize()
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for t in range(start, start + calls):
            inp, cache = serve(params, cache, inp, t)
            inp = inp[:, None]
        torch.cuda.synchronize()
    wall = (time.time() - t0) * 1e3
    rows = device_rows(prof)
    busy = sum(r[0] for r in rows)
    norms = sum(n for _, n, key in rows if "rn::rmsnorm_kernel<" in key)
    want = calls * expected_decode_launches(cfg)["rmsnorm"]
    return {"calls": calls, "positions": [start, start + calls - 1], "wall_ms": wall,
            "device_busy_ms": busy, "idle_share_profiled": 1.0 - busy / wall,
            "rmsnorm_device_kernels": norms, "rmsnorm_expected": want,
            "complete": norms == want, "by_group_ms": by_group(rows),
            "top": [{"ms": round(ms, 3), "calls": n, "kernel": key[:90]}
                    for ms, n, key in rows[:8]]}


def serve_model(cfg, profile: bool) -> dict:
    """Greedy serving at full width and depth: 8 sequences, the prompt fed a
    token a call, then the greedy tokens; launches, timing, peak memory; then
    decode == forward a row at a time against one teacher-forced forward pass
    over the same 768 tokens (a MoE model's with ``drop_free``), and the
    planted fault of the model's mixer or MoE layer."""
    params = init_params(cfg, 0, DEV)
    B, steps = SERVE_BATCH, SERVE_PROMPT + SERVE_NEW
    toks = torch.zeros((B, steps), dtype=torch.int32, device=DEV)
    toks[:, :SERVE_PROMPT] = torch.from_numpy(make_tokens(cfg, B, SERVE_PROMPT, 0, 0))
    dt = getattr(torch, cfg.compute_dtype)
    dec = torch.empty((B, steps, cfg.vocab), dtype=dt, device=DEV)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    greedy, secs, cache = serve_calls(cfg, params, toks, steps,
                                      lambda t, lg: dec[:, t].copy_(lg),
                                      feed_from=SERVE_PROMPT)
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    per_step = expected_decode_launches(cfg)
    want = {k: n * steps for k, n in per_step.items()}
    if launches != want:
        raise AssertionError(f"serve {cfg.name}: launches {launches}, expected {want}")
    if not torch.isfinite(dec).all():
        raise AssertionError(f"serve {cfg.name}: non-finite decode logits")
    med = float(np.median(secs[SERVE_WARMUP:]))
    res = {"arch": cfg.name, "layers": cfg.n_layers, "batch": B, "prompt": SERVE_PROMPT,
           "generated": SERVE_NEW, "max_seq": SERVE_MAX_SEQ, "calls": steps,
           "params": cfg.param_count(), "launches": launches,
           "rmsnorm_launches_per_call": per_step["rmsnorm"],
           "ms_per_call_median": med * 1e3,
           "ms_per_call_prompt_median": float(np.median(secs[SERVE_WARMUP:SERVE_PROMPT])) * 1e3,
           "ms_per_call_generate_median": float(np.median(secs[SERVE_PROMPT:])) * 1e3,
           "ms_per_call_first": secs[0] * 1e3,
           "tokens_per_s": B / med, "peak_memory_bytes": peak,
           "logit_record_bytes": dec.numel() * dec.element_size(),
           "peak_without_record_bytes": peak - dec.numel() * dec.element_size()}
    if profile:
        prof = profile_decode(cfg, params, cache, torch.cat([toks, greedy[:, -1:]], dim=1), steps)
        # the device's idle share of an unprofiled call: its busy time a call
        # (profiled) against the median call's host time (not profiled)
        prof["idle_share"] = 1.0 - prof["device_busy_ms"] / prof["calls"] / (med * 1e3)
        res["profile"] = prof
    del cache

    # decode == the teacher-forced forward over the same tokens, a row at a
    # time (logits at position t from the tokens up to t); a MoE forward
    # without capacity drops, which decode never makes
    reset_launches()
    with torch.inference_mode():
        fwd, _ = logits_fn(params, drop_free(cfg), toks)
    fwd_launches = dict(ops.LAUNCHES)
    if fwd_launches != expected_forward_launches(cfg):
        raise AssertionError(f"serve {cfg.name} forward: launches {fwd_launches}, expected "
                             f"{expected_forward_launches(cfg)}")
    err = torch.cat([row_rel(dec[:, t:t + 64], fwd[:, t:t + 64]) for t in range(0, steps, 64)],
                    dim=1)                                              # (B, steps)
    agree = float((dec.argmax(dim=-1) == fwd.argmax(dim=-1)).float().mean())
    tol, tol_med = SERVE_ROW_TOL[cfg.name], SERVE_MEDIAN_TOL.get(cfg.name)
    if cfg.moe:
        res["forward_capacity_factor"] = drop_free(cfg).moe.capacity_factor
        res["forward_capacity"] = moe._capacity(steps, drop_free(cfg))
    res.update(forward_launches=fwd_launches, tol_row_rel=tol, tol_median_row_rel=tol_med,
               decode_vs_forward={"max_row_rel": float(err.max()),
                                  "median_row_rel": float(err.median()),
                                  "max_row_rel_after_prompt": float(err[:, SERVE_PROMPT:].max())},
               greedy_agrees_with_forward_argmax=agree,
               greedy_is_decode_argmax=bool(torch.equal(
                   greedy, dec.argmax(dim=-1).to(torch.int32))))
    del dec
    if (float(err.max()) > tol or (tol_med is not None and float(err.median()) > tol_med)
            or not res["greedy_is_decode_argmax"]):
        raise AssertionError(f"serve {cfg.name}: decode != forward: {res['decode_vs_forward']} "
                             f"(tolerance {tol}, median {tol_med}); greedy is the argmax: "
                             f"{res['greedy_is_decode_argmax']}")

    # the planted fault of this model's MoE layer or mixer, teacher-forced
    # over the same tokens: it must read above the tolerance (the median's,
    # where the model has one)
    kind = "moe" if cfg.moe else next(s.mixer for s in cfg.layer_specs()
                                      if s.mixer in SERVE_FAULTS)
    name, fault, n = SERVE_FAULTS[kind]
    errs = []
    with patched(transformer, name, fault):
        serve_calls(cfg, params, toks, n, lambda t, lg: errs.append(row_rel(lg, fwd[:, t])))
    errs = torch.stack(errs)
    read, limit = ((float(errs.max()), tol) if tol_med is None
                   else (float(errs.median()), tol_med))
    res["planted_fault"] = {"fault": fault.__name__, "positions": n,
                            "max_row_rel": float(errs.max()),
                            "median_row_rel": float(errs.median())}
    if read <= limit:
        raise AssertionError(f"serve {cfg.name}: the decode == forward check cannot see the "
                             f"planted fault {fault.__name__}: {read} <= {limit}")
    del fwd, params
    return res


def phase_serve(cfgs, profile: bool) -> dict:
    """``serve_model`` on each configuration; returns each one's launches."""
    out = {}
    for cfg in cfgs:
        res = serve_model(cfg, profile)
        emit("serve", **res)
        out[f"serve_{cfg.name}"] = res["launches"]
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# parity
# ---------------------------------------------------------------------------


def parity(cfg, phase: str, seq: int) -> None:
    """Kernel path (``use_flash=True``) vs plain path on the card, fp32: loss
    and the MoE aux loss to 1e-5, every gradient leaf to 5e-5, and the
    kernels the kernel path launched counted (forward and backward of
    ``lm_loss``, no remat)."""
    # every weight in fp32 (the specs give the matrices bf16 whatever the config says)
    params = tree_map(lambda t: t.float(), init_params(cfg, 0, DEV))
    rng = np.random.default_rng(0)
    inputs = torch.from_numpy(rng.integers(0, cfg.vocab, (2, seq)).astype(np.int32)).to(DEV)
    labels = torch.from_numpy(rng.integers(0, cfg.vocab, (2, seq)).astype(np.int32)).to(DEV)
    leaves = list(tree_flatten_with_path(params).values())
    for p in leaves:
        p.requires_grad_(True)
    out, dropped = {}, []

    def slots(top_idx, E, C):
        dest = dispatch_slots(top_idx, E, C)
        dropped.append(int((dest == E * C).sum()))
        return dest

    dispatch_slots = moe._dispatch_slots
    for flash in (True, False):
        reset_launches()
        with patched(moe, "_dispatch_slots", slots):
            loss, metrics = lm_loss(params, replace(cfg, use_flash=flash), inputs, labels)
        grads = torch.autograd.grad(loss, leaves)
        out[flash] = (loss.item(), grads, dict(ops.LAUNCHES), metrics["aux_loss"].item())
    want = {k: v for k, v in expected_launches(replace(cfg, use_flash=True)).items()
            if k != "fused_adam"}
    got = {k: v for k, v in out[True][2].items() if k != "fused_adam"}
    if got != want or any(out[False][2].values()):
        raise AssertionError(f"kernel launches: kernel path {got} (expected {want}), "
                             f"plain path {out[False][2]}")
    dloss = abs(out[True][0] - out[False][0])
    daux = abs(out[True][3] - out[False][3])
    dgrad = max(max_err(a, b) for a, b in zip(out[True][1], out[False][1], strict=True))
    if not (dloss <= 1e-5 and daux <= 1e-5 and dgrad <= 5e-5):
        raise AssertionError(f"kernel path != plain path: loss {dloss}, aux {daux}, "
                             f"grads {dgrad}")
    if cfg.moe and not sum(dropped):
        raise AssertionError(f"{phase}: the forward dropped no entry at capacity "
                             f"{moe._capacity(seq, cfg)}")
    emit(phase, config=cfg.name, layers=cfg.n_layers, seq=seq, loss=out[True][0],
         loss_abs_diff=dloss, tol_loss=1e-5, aux_loss=out[True][3], aux_abs_diff=daux,
         grad_max_abs_diff=dgrad, tol_grad=5e-5, launches=got,
         **({"capacity": moe._capacity(seq, cfg),
             "dropped_entries_per_layer": dropped[:cfg.n_layers]} if cfg.moe else {}))


def phase_parity() -> None:
    parity(replace(smoke_config("gemma3-1b"), param_dtype="float32",
                   compute_dtype="float32"), "parity", 128)


def small_ssm():
    """A small fp32 mamba2 inside the kernels' contract: head dim 16, state
    16, chunk 64 (two chunks of S = 128), d_model 64, d_inner 128."""
    base = smoke_config("mamba2-1.3b")
    return replace(base, param_dtype="float32", compute_dtype="float32",
                   ssm=replace(base.ssm, headdim=16, chunk=64))


def phase_parity_ssm() -> None:
    parity(small_ssm(), "parity_ssm", 128)


#: parity_serve, fp32 on the card: decode on the kernel path vs the plain
#: path and vs the forward (two fp32 summation orders and rsqrtf, 128
#: positions through at most six layers)
SERVE_PARITY_TOL = 5e-5


def decode_logits(cfg, params, toks) -> tuple[torch.Tensor, dict]:
    """The logits (B, S, V) of greedy serve calls over every position of
    ``toks`` (B, S), teacher-forced, and the launches they made."""
    reset_launches()
    out = []
    serve_calls(cfg, params, toks, toks.shape[1], lambda t, lg: out.append(lg))
    return torch.stack(out, dim=1), dict(ops.LAUNCHES)


def small_params(cfg):
    """fp32 weights of ``cfg`` on the card, the norm scales (zero at init)
    drawn at scale 0.2 so that the norms' scales take part."""
    rng_t = generator(50)
    return tree_map(lambda t: t.float() + (0.2 * torch.randn(
        t.shape, generator=rng_t, device=DEV) if t.dtype == torch.float32
        and not t.any() else 0.0), init_params(cfg, 0, DEV))


def serve_parity(cfg, S=128) -> dict:
    """Decode on the kernel path (``use_flash``: the rmsnorm kernel; launches
    derived) == decode on the plain path (no launches) == the teacher-forced
    forward on the kernel path (flash, ssd_chunk, rmsnorm kernels; a MoE
    model's ``drop_free``), fp32, within ``SERVE_PARITY_TOL``."""
    params = small_params(cfg)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, S)).astype(np.int32)).to(DEV)
    kcfg, pcfg = replace(cfg, use_flash=True), replace(cfg, use_flash=False)
    kernel, k_launches = decode_logits(kcfg, params, toks)
    plain, p_launches = decode_logits(pcfg, params, toks)
    reset_launches()
    with torch.inference_mode():
        fwd, _ = logits_fn(params, drop_free(kcfg), toks)
    f_launches = dict(ops.LAUNCHES)
    want = {k: n * S for k, n in expected_decode_launches(cfg).items()}
    res = {"decode_kernel_vs_plain": max_err(kernel, plain),
           "decode_vs_forward": max_err(kernel, fwd),
           "launches_decode_kernel_path": k_launches,
           "launches_forward": f_launches}
    if (k_launches != want or any(p_launches.values())
            or f_launches != expected_forward_launches(cfg)):
        raise AssertionError(f"parity_serve {cfg.name}: launches {k_launches} (expected "
                             f"{want}), plain path {p_launches}, forward {f_launches} "
                             f"(expected {expected_forward_launches(cfg)})")
    if max(res["decode_kernel_vs_plain"], res["decode_vs_forward"]) > SERVE_PARITY_TOL:
        raise AssertionError(f"parity_serve {cfg.name}: {res} (tolerance "
                             f"{SERVE_PARITY_TOL})")
    return res


def phase_parity_serve() -> None:
    """Small fp32 models on the card: gemma3 (window 8: the ring wraps 15
    times), mamba2, minicpm3: ``serve_parity`` at S = 128; then minicpm3's
    kernel path == plain path for loss and gradients."""
    fp32 = dict(param_dtype="float32", compute_dtype="float32")
    cfgs = [replace(smoke_config("gemma3-1b"), window=8, **fp32), small_ssm(),
            replace(smoke_config("minicpm3-4b"), **fp32)]
    emit("parity_serve", seq=128, tol=SERVE_PARITY_TOL,
         models={cfg.name: serve_parity(cfg) for cfg in cfgs})
    parity(cfgs[2], "parity_mla", 128)


def phase_parity_moe() -> None:
    """A small fp32 olmoe (4 experts, top 2; capacity as configured, so the
    forward at S = 128 drops entries, and ``parity`` fails unless it does):
    kernel path == plain path for loss, aux and gradients, then
    ``serve_parity``."""
    cfg = replace(smoke_config("olmoe-1b-7b"), param_dtype="float32",
                  compute_dtype="float32")
    parity(cfg, "parity_moe", 128)
    emit("parity_moe_serve", seq=128, tol=SERVE_PARITY_TOL,
         capacity=moe._capacity(128, cfg), forward_capacity=moe._capacity(128, drop_free(cfg)),
         models={cfg.name: serve_parity(cfg)})


#: parity_opt: the optimizers on the card vs on the CPU, each leaf within this
#: share of its largest entry (fp32 products and reductions in other orders)
OPT_PARITY_TOL = 1e-6


def phase_parity_opt() -> None:
    """A small fp32 gemma3 (8 layers: GaLore at rank 4 projects the table and
    the remainder's matrices): 3 updates of each of ``OPTIMIZERS`` with the
    same gradients on CUDA tensors and on CPU tensors (GaLore's ``P`` is
    drawn on the CPU for both); parameters and states leaf by leaf within
    ``OPT_PARITY_TOL`` of the leaf's largest entry."""
    cfg = replace(smoke_config("gemma3-1b"), n_layers=8, param_dtype="float32",
                  compute_dtype="float32")
    base = tree_map(lambda t: t.float(), init_params(cfg, 0, "cpu"))
    rng = np.random.default_rng(5)
    grads = [tree_map(lambda p: torch.from_numpy(
        rng.standard_normal(tuple(p.shape)).astype(np.float32) * 0.1), base) for _ in range(3)]
    out = {}
    for name in OPTIMIZERS:
        kw = {"rank": 4} if name == "galore_adamw" else {}
        trees = {}
        for dev in (DEV, "cpu"):
            params = tree_map(lambda t: t.clone().to(dev), base)
            opt = make_optimizer(name, 1e-2, **kw)
            state = opt.init(params)
            for step, g in enumerate(grads):
                params, state = opt.update(tree_map(lambda t: t.to(dev), g), state, params, step)
            trees[dev] = tree_flatten_with_path({"params": params, "opt": state})
        cuda, cpu = trees[DEV], trees["cpu"]
        err = max((cuda[k].cpu().float() - cpu[k].float()).abs().max().item()
                  / max(cpu[k].float().abs().max().item(), 1e-30) for k in cpu)
        out[name] = {"leaves": len(cpu), "projected": sum(k.endswith("/P") for k in cpu),
                     "max_err_over_leaf_max": err}
    emit("parity_opt", config=cfg.name, layers=cfg.n_layers, updates=len(grads),
         tol=OPT_PARITY_TOL, optimizers=out)
    if max(o["max_err_over_leaf_max"] for o in out.values()) > OPT_PARITY_TOL:
        raise AssertionError(f"parity_opt: the card != the CPU: {out}")


# ---------------------------------------------------------------------------
# the mesh path: DTensors on a one-rank mesh, and the dry-run

#: train_mesh: mamba2-1.3b at full width, 4 of 48 layers, 2 x 4096, 2 steps
MESH_SSM_LAYERS, MESH_SSM_BATCH, MESH_SSM_STEPS = 4, 2, 2
#: dryrun: the cells the phase lowers on both production meshes
DRYRUN_CELLS = (("gemma3-1b", "train_4k"), ("mamba2-1.3b", "decode_32k"))


class OpCounter(TorchDispatchMode):
    """Counts the aten operators dispatched at the level of the tensors the
    step holds: on the mesh, DTensor operators (each one's sharding
    propagation and the local operator it issues are DTensor's host cost)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def ops_a_step(tr, params, opt_state, batch: int) -> int:
    """Aten operators of one more training step of ``tr``."""
    from repro_torch.distributed.sharding import use_mesh
    data = tr._shard_batch(make_batch(tr.cfg, tr.shape, 0, tr.seed, batch, device=DEV))
    with use_mesh(tr.mesh), OpCounter() as count:
        tr.step_fn(params, opt_state, data, 0)
    torch.cuda.synchronize()
    return count.n


def phase_train_mesh(gemma, mamba) -> dict:
    """The trainer's mesh path on a one-rank NCCL group and a (1, 1)
    ('data', 'model') mesh on the card: gemma3-1b as in ``train`` (the same
    seed), each step's loss and grad norm equal to ``train``'s bit for bit,
    launches as derived, the checkpoint bit for bit; step time, tokens/s and
    peak memory beside ``train``'s, and the aten operators of one step on
    and off the mesh.  Then mamba2-1.3b at full width and 4 layers, so that
    ssd_chunk runs through its mesh route, and a planted fault: the mesh
    route's rmsnorm taken through its plain version must fail the launch
    check.  Returns the launches."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    if "train" not in TRAIN_RESULTS:
        raise AssertionError("train_mesh holds its steps against the train phase's: run both")
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        out = {}
        launches = phase_train(gemma, "train_mesh", False, mesh=mesh)
        got, want = TRAIN_RESULTS["train_mesh"], TRAIN_RESULTS["train"]
        same = {k: got[k] == want[k] for k in ("losses", "grad_norms", "launches")}
        # aten operators of one step, on no mesh and on the mesh
        plain = Trainer(gemma, get_shape("train_4k"), device=DEV)
        ops_plain = ops_a_step(plain, *plain.init_state(), TRAIN_BATCH)
        del plain
        torch.cuda.empty_cache()
        meshed = Trainer(gemma, get_shape("train_4k"), device=DEV, mesh=mesh)
        ops_mesh = ops_a_step(meshed, *meshed.init_state(), TRAIN_BATCH)
        del meshed
        torch.cuda.empty_cache()
        out["gemma3"] = {"equal_to_train": same, "step_s": got["step_s_median_after_first"],
                         "train_step_s": want["step_s_median_after_first"],
                         "tokens_per_s": got["tokens_per_s"],
                         "train_tokens_per_s": want["tokens_per_s"],
                         "peak_memory_bytes": got["peak_memory_bytes"],
                         "train_peak_memory_bytes": want["peak_memory_bytes"],
                         "aten_ops_a_step": ops_mesh, "train_aten_ops_a_step": ops_plain}
        emit("train_mesh_vs_train", **out["gemma3"])
        if not all(same.values()):
            raise AssertionError(f"train_mesh differs from train: {same}; losses "
                                 f"{got['losses']} vs {want['losses']}, grad norms "
                                 f"{got['grad_norms']} vs {want['grad_norms']}")
        ssm = replace(mamba, n_layers=MESH_SSM_LAYERS)
        ssm_launches = phase_train(
            ssm, "train_mesh_ssm", False, batch=MESH_SSM_BATCH, steps=MESH_SSM_STEPS,
            reduced=f"n_layers 48 -> {MESH_SSM_LAYERS}, batch {MESH_SSM_BATCH}, "
                    f"{MESH_SSM_STEPS} steps (the mesh route's ssd_chunk, not a second "
                    "full train_ssm)", mesh=mesh)
        # planted fault: the mesh route's norm through the plain version
        plain_norm = type("PlainNorm", (), {"apply": staticmethod(rn.rmsnorm_plain)})
        try:
            with patched(ops, "RMSNorm", plain_norm):
                fit_and_check(ssm, MESH_SSM_BATCH, 1, mesh=mesh)
        except AssertionError as e:
            if "launch counts" not in str(e):
                raise
            emit("train_mesh_fault", caught=True, what="rmsnorm's mesh route taken "
                 "through its plain version", message=str(e)[:300])
        else:
            raise AssertionError("train_mesh: the planted fault (plain rmsnorm on the mesh "
                                 "route) passed the launch check")
        torch.cuda.empty_cache()
        return {"train_mesh": launches, "train_mesh_ssm": ssm_launches}
    finally:
        dist.destroy_process_group()


def phase_dryrun() -> None:
    """``python -m repro_torch.launch.dryrun`` for each of ``DRYRUN_CELLS`` on
    both production meshes (a fake process group of 512 ranks, ``meta`` local
    shards: no device): per cell the FLOPs a device and global, the
    collectives by kind, the argument bytes a device and the wall seconds.
    A non-zero exit fails the phase, and so does a cell whose global FLOPs
    are not positive or exceed its ranks' FLOPs together."""
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    try:
        cells = {}
        for arch, shape in DRYRUN_CELLS:
            t0 = time.time()
            proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                                   "--arch", arch, "--shape", shape, "--mesh", "both",
                                   "--out", out_dir], env=env, capture_output=True, text=True,
                                  timeout=600)
            if proc.returncode:
                raise AssertionError(f"dryrun {arch} {shape}: exit {proc.returncode}\n"
                                     f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
            for name in sorted(os.listdir(out_dir)):
                with open(os.path.join(out_dir, name)) as f:
                    row = json.load(f)
                # flops_global counts the step once for the mesh; each rank's
                # flops is its share or more (replicated work on every rank)
                ranks = math.prod(row["mesh_shape"])
                if not 0 < row["flops_global"] <= row["flops"] * ranks:
                    raise AssertionError(f"dryrun {name}: flops {row['flops']} a device on "
                                         f"{ranks} ranks, flops_global {row['flops_global']}")
                cells[name.removesuffix(".json")] = {
                    k: row[k] for k in ("flops", "flops_global", "n_collectives",
                                        "collective_bytes", "argument_bytes", "lower_s",
                                        "wall_s")}
            cells[f"{arch}__{shape}__process_s"] = time.time() - t0
        emit("dryrun", meshes={"pod16x16": [16, 16], "pod2x16x16": [2, 16, 16]},
             process_group="fake, 512 ranks; meta local shards", cells=cells)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


#: trace: mamba2-1.3b and olmoe-1b-7b at full width and reduced depth (their
#: ssd_chunk and MoE operators through the tracer on the card)
TRACE_SSM_LAYERS, TRACE_MOE_LAYERS = 4, 4
#: trace: the graph's gemm- and conv-class FLOPs against FlopCounterMode over
#: the same step on meta, plus what SAC's recompute hides from it there
TRACE_FLOP_RTOL = 0.01


def by_class(g) -> dict:
    out = Counter()
    for n in g.nodes.values():
        out[n.op_class] += n.flops
    return dict(out)


def graph_rows(g) -> tuple:
    """Every tensor and node of a graph, field by field, in order."""
    return ([(s.name, s.shape, s.dtype, s.is_param, s.is_state, s.is_input)
             for s in g.tensors.values()],
            [(n.name, n.op, n.kind, sorted(n.dims.items()), n.inputs, n.outputs, n.flops,
              sorted(n.meta.items(), key=str)) for n in g.nodes.values()])


def first_difference(a, b) -> str:
    for what, xs, ys in (("tensor", a[0], b[0]), ("node", a[1], b[1])):
        for i, (x, y) in enumerate(zip(xs, ys, strict=False)):
            if x != y:
                return f"{what} {i}: {x} vs {y}"
        if len(xs) != len(ys):
            return f"{len(xs)} vs {len(ys)} {what}s"
    return "none"


def check_kernel_nodes(rec, before: dict) -> dict:
    """The trace's kernel nodes per entry point against the traced step's
    ``LAUNCHES`` delta; returns the delta."""
    delta = {k: ops.LAUNCHES[k] - before[k] for k in ops.LAUNCHES}
    if rec.kernel_nodes != delta:
        raise AssertionError(f"trace: kernel nodes {rec.kernel_nodes} differ from the "
                             f"traced step's LAUNCHES delta {delta}")
    return delta


def meta_step_args(tr, data):
    params = abstract_params(tr.cfg)
    return params, tr.opt.init(params), {k: torch.empty_like(v, device="meta")
                                         for k, v in data.items()}


def traced_step(cfg, what: str, batch: int = TRAIN_BATCH, timed: int = 2,
                same_on_meta: bool = False) -> tuple[dict, dict]:
    """One training step of ``cfg`` as ``train`` runs it (``Trainer.step_fn``
    at ``batch`` × 4096, AdamW through fused_adam), traced on the card after
    ``timed`` + 1 untimed-then-timed steps: the kernel nodes per entry point
    equal to the traced step's ``LAUNCHES`` delta, a finite loss, the graph's
    gemm- and conv-class FLOPs equal to ``FlopCounterMode`` over the same step
    on ``meta`` (plus what SAC's recompute hides from it there) within
    ``TRACE_FLOP_RTOL``, the graph validated (on leaving ``recording``) and
    scheduled on ``tpu_v5e_like()``; with ``same_on_meta``, the graph equal
    field by field to the step's graph on ``meta``.  Returns (the results,
    the launches)."""
    tr = Trainer(cfg, get_shape("train_4k"), device=DEV)
    params, state = tr.init_state()
    data = make_batch(cfg, tr.shape, 0, tr.seed, batch, device=DEV)
    times = []
    for i in range(1 + timed):
        torch.cuda.synchronize()
        t0 = time.time()
        params, state, _ = tr.step_fn(params, state, data, i)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
    before = dict(ops.LAUNCHES)
    t0 = time.time()
    with recording(f"{cfg.name}_train_step", params=params, inputs=(state, data)) as rec:
        params, state, metrics = tr.step_fn(params, state, data, 1 + timed)
        torch.cuda.synchronize()
    trace_s = time.time() - t0
    launches = check_kernel_nodes(rec, before)
    loss = float(metrics["loss"])
    if not math.isfinite(loss):
        raise AssertionError(f"trace: the traced step's loss is {loss}")
    g = rec.graph
    del params, state, metrics
    torch.cuda.empty_cache()
    cls = by_class(g)
    t0 = time.time()
    counted, hidden = flop_count(tr.step_fn, *meta_step_args(tr, data), 0)
    flop_s = time.time() - t0
    traced = cls.get("gemm", 0) + cls.get("conv", 0)
    rel = abs(traced - (counted + hidden)) / max(counted + hidden, 1)
    if not rel <= TRACE_FLOP_RTOL:
        raise AssertionError(f"trace: gemm + conv FLOPs {traced} against FlopCounterMode "
                             f"{counted} + {hidden} hidden by the recompute: {rel:.4f} apart")
    meta_same = None
    if same_on_meta:
        margs = meta_step_args(tr, data)
        with recording(f"{cfg.name}_train_step", params=margs[0], inputs=margs[1:]) as mrec:
            tr.step_fn(*margs, 1 + timed)
        diff = first_difference(graph_rows(g), graph_rows(mrec.graph))
        if diff != "none":
            raise AssertionError(f"trace: the graph on the card differs from meta's: {diff}")
        meta_same = True
    t0 = time.time()
    res = schedule(g, tpu_v5e_like())
    sched_s = time.time() - t0
    out = {"arch": cfg.name, "layers": cfg.n_layers, "batch": batch, "seq": SEQ,
           "remat": cfg.remat, "dtype": cfg.param_dtype, "use_flash": cfg.use_flash,
           "what": what, "nodes": len(g), "tensors": len(g.tensors),
           "params": sum(1 for t in g.tensors.values() if t.is_param),
           "param_bytes": sum(t.bytes for t in g.tensors.values() if t.is_param),
           "flops_by_class": cls, "flops_total": g.total_flops(),
           "kernel_nodes": dict(rec.kernel_nodes), "launches_delta": launches,
           "loss": loss, "flopcounter_meta": counted, "flopcounter_hidden_by_recompute": hidden,
           "gemm_conv_flops_rel_diff": rel, "tol_rel": TRACE_FLOP_RTOL,
           "graph_equal_to_meta": meta_same,
           "schedule": {"hda": "tpu_v5e_like", "latency_cycles": res.latency,
                        "peak_mem_bytes": res.peak_mem, "energy_pj": res.energy,
                        "n_subgraphs": res.n_subgraphs, "mem_breakdown": res.mem_breakdown},
           "trace_s": trace_s, "schedule_s": sched_s, "flopcounter_meta_s": flop_s,
           "step_s_untraced": times[1:], "first_step_s": times[0], "card": smi()}
    return out, launches


def small_cpu_cuda_graphs() -> dict:
    """A small gemma3 (smoke config, use_flash, dots, 2 × 128 tokens, AdamW)
    traced on the CPU (plain versions) and on the card (kernels) from the
    same weights: the two graphs equal field by field."""
    cfg = replace(smoke_config("gemma3-1b"), use_flash=True, remat="dots")
    base = init_params(cfg, 0, "cpu")

    def weights_on(dev):
        return tree_map(lambda t: t.to(dev).clone(), base)

    graphs = {}
    for dev in ("cpu", DEV):
        tr = Trainer(cfg, get_shape("train_4k"), device=dev)
        data = {k: v.clone() for k, v in make_batch(cfg, tr.shape, 0, 0, 2, 128,
                                                   device=dev).items()}
        for traced in (False, True):
            params = weights_on(dev)
            state = tr.opt.init(params)
            if not traced:
                tr.step_fn(params, state, data, 0)     # caches filled (RoPE tables)
                continue
            before = dict(ops.LAUNCHES)
            with recording("small_gemma3", params=params, inputs=(state, data)) as rec:
                tr.step_fn(params, state, data, 0)
            if dev == DEV:
                check_kernel_nodes(rec, before)
            graphs[dev] = rec.graph
    diff = first_difference(graph_rows(graphs["cpu"]), graph_rows(graphs[DEV]))
    if diff != "none":
        raise AssertionError(f"trace: the small gemma3's graph on the card differs from the "
                             f"CPU's: {diff}")
    return {"nodes": len(graphs[DEV]), "tensors": len(graphs[DEV].tensors), "equal": True}


def phase_trace(gemma, mamba, olmoe) -> dict:
    """``repro_torch.core.trace`` on the card: gemma3-1b at full size, a
    planted fault, a small gemma3 on the CPU and on the card, then mamba2-1.3b
    and olmoe-1b-7b at full width and reduced depth (``traced_step``).
    Returns the launches of each traced step."""
    out, launches = {}, {}
    out["gemma3"], launches["trace_gemma3"] = traced_step(
        gemma, "the train phase's step, full width and depth", same_on_meta=True)
    emit("trace", **out["gemma3"])
    torch.cuda.empty_cache()
    # planted fault: the norm's forward around kernel_call (its hook off)
    hookless = lambda x, scale, eps=1e-6: rn.rmsnorm_cuda(x, scale, eps)  # noqa: E731
    try:
        with patched(rn, "rmsnorm_fwd", hookless):
            traced_step(replace(gemma, n_layers=2), "planted fault", batch=1, timed=0)
    except AssertionError as e:
        if "kernel nodes" not in str(e):
            raise
        emit("trace_fault", caught=True, what="rmsnorm's forward without its trace hook",
             message=str(e)[:300])
    else:
        raise AssertionError("trace: the planted fault (the norm's hook switched off) passed "
                             "the kernel-node check")
    torch.cuda.empty_cache()
    emit("trace_cpu_vs_card", **small_cpu_cuda_graphs())
    for key, cfg, layers, full in (("mamba2", mamba, TRACE_SSM_LAYERS, 48),
                                   ("olmoe", olmoe, TRACE_MOE_LAYERS, 16)):
        out[key], launches[f"trace_{key}"] = traced_step(
            replace(cfg, n_layers=layers),
            f"full width, n_layers {full} -> {layers} (its kernels and operators through "
            "the tracer; the train phases run the deeper model)", timed=1)
        emit(f"trace_{key}", **out[key])
        torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# resilience, monet_cli: MONET's fault model on the card's own times
# ---------------------------------------------------------------------------

#: resilience: gemma3-1b steps before the checkpoint (step time: the median of
#: the last two), the cluster sizes MONET's interval is picked for (one card;
#: the dry-run's (16, 16) mesh), the largest range ``optimal_checkpoint_interval``
#: enumerates whole (resilience.py), and how close its geometric grid must come
#: to the exhaustive optimum beyond that (its docstring's "fraction of a percent")
RES_STEPS = 3
RES_CHIPS = (1, 256)
RES_EXHAUSTIVE = 1 << 17
RES_EXACT_RTOL, RES_GRID_RTOL = 1e-12, 1e-3


def bits(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bits as integers of its width (floats compared bit for bit:
    NaN equal to itself, −0 apart from +0)."""
    if not t.is_floating_point():
        return t
    return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


def first_mismatch(saved, restored) -> str | None:
    """The path of the first leaf of ``restored`` whose dtype, shape or bits
    differ from ``saved``'s, or None."""
    for (key, a), b in zip(tree_flatten_with_path(saved).items(),
                           tree_flatten_with_path(restored).values(), strict=True):
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(bits(a), bits(b)):
            return key
    return None


def one_ulp_off(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` whose first element is one ulp away (its bits + 1)."""
    out = t.clone()
    bits(out.view(-1)[:1]).add_(1)
    return out


def exhaustive_interval(plan, t_step, write_s, recovery_s, mtbf_s) -> dict:
    """``plan``'s efficiency against the best of Daly's efficiency
    (``resilience._segment_efficiency``) over every k in 1 … max(8·k_YD, 64):
    equal within ``RES_EXACT_RTOL`` where the function enumerates that range
    itself, within ``RES_GRID_RTOL`` where it takes its geometric grid."""
    k_yd = max(int(round(plan.tau_yd_s / t_step)), 1)
    hi = max(8 * k_yd, 64)
    ks = np.arange(1, hi + 1, dtype=np.int64)
    eff = resilience._segment_efficiency(ks * t_step, write_s, recovery_s, mtbf_s)
    i = int(np.argmax(eff))
    best = float(eff[i])
    enumerated = hi <= RES_EXHAUSTIVE
    rel = (best - plan.efficiency) / best
    tol = RES_EXACT_RTOL if enumerated else RES_GRID_RTOL
    if not 0.0 <= rel <= tol:
        raise AssertionError(f"resilience: k {plan.interval_steps} at efficiency "
                             f"{plan.efficiency!r}, the exhaustive best k {ks[i]} at {best!r} "
                             f"over 1..{hi} (relative gap {rel:.3e} > {tol:g})")
    return {"search": "exhaustive" if enumerated else "geometric grid", "k_yd": k_yd,
            "range": hi, "exhaustive_best_k": int(ks[i]), "exhaustive_best_efficiency": best,
            "relative_gap": rel, "tol": tol}


def checkpoint_intervals(t_step, write_s, read_s, fm) -> dict:
    """``optimal_checkpoint_interval`` for each of ``RES_CHIPS`` (MTBF of that
    many chips of ``fm``, recovery ``fm.restart_s`` + ``read_s``), each k held
    against the exhaustive enumeration."""
    out = {}
    for n in RES_CHIPS:
        args = (t_step, write_s, fm.restart_s + read_s, fm.cluster_mtbf_s(n))
        plan = optimal_checkpoint_interval(*args)
        out[n] = {"interval_steps": plan.interval_steps, "interval_s": plan.interval_s,
                  "efficiency": plan.efficiency, "tau_yd_s": plan.tau_yd_s,
                  "recovery_s": args[2], "mtbf_s": args[3],
                  "check": exhaustive_interval(plan, *args)}
    return out


def monet_parallel(tg) -> dict:
    """``evaluate_parallel`` of ``tg`` under each strategy of 4 chips on
    ``datacenter_cluster(4)``, then ``degrade(dp4, 1 chip)``: dp3, no
    findings, and its stage graphs rescheduled with no fresh signing."""
    cluster = datacenter_cluster(n_chips=4)
    t0 = time.perf_counter()
    strategies = {}
    for strat in strategy_space(4):
        r = evaluate_parallel(tg, cluster, strat)
        strategies[strat.label] = {"cycles": r.latency, "wire_bytes": r.wire_bytes,
                                   "peak_mem": r.peak_mem, "feasible": r.feasible}
    parallel_s = time.perf_counter() - t0
    engine = get_engine(cluster.chip)
    t0 = time.perf_counter()
    d = degrade(tg, cluster, ParallelStrategy(data=4), failed_chips=1, engine=engine)
    degrade_s = time.perf_counter() - t0
    before = sign_count()
    for sg in d.plan.stage_graphs:
        part, quotient = fusion_partition(sg, d.cluster.chip, "manual", None, engine)
        schedule(sg, d.cluster.chip, part, engine=engine, quotient=quotient)
    fresh = sign_count() - before
    if d.strategy.label != "dp3" or d.findings or fresh:
        raise AssertionError(f"resilience: degrade(dp4, 1) gave {d.strategy.label}, "
                             f"findings {d.findings}, {fresh} fresh signings")
    return {"cluster": "datacenter_cluster(4), tpu_v5e_like() chips, 16 GiB each",
            "strategies": strategies, "host_s": parallel_s,
            "degrade": {"from": "dp4", "failed_chips": 1, "to": d.strategy.label,
                        "findings": len(d.findings), "fresh_signings": fresh,
                        "cycles": d.result.latency, "feasible": d.result.feasible,
                        "host_s": degrade_s}}


def phase_resilience(cfg) -> dict:
    """MONET's resilience model on the card's own times.  gemma3-1b as in
    train, ``RES_STEPS`` steps (the step time); a synchronous
    ``save_checkpoint`` of params and AdamW state to ``$TMPDIR`` (write_s,
    bytes on disk); a fresh ``Trainer``'s ``restore_or_init`` from it (read_s;
    every leaf equal to the saved one bit for bit, and a planted fault, one
    leaf one ulp off, that the check must catch).  Then the port's core picks
    the checkpoint interval for 1 and 256 cards from these times (each k held
    against an exhaustive enumeration), beside MONET's own prediction
    (``evaluate_goodput`` on gemma3-1b's training graph, ``datacenter_cluster(1)``)
    and its 4-chip strategies and dp4 → dp3 degrade.  Returns the launches."""
    res, tr, launches = fit_and_check(cfg, TRAIN_BATCH, RES_STEPS)
    params, opt_state = tr._last_state
    saved = {"params": params, "opt": opt_state}
    t_step = res["step_s_median_after_first"]
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_resilience_")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save_checkpoint(ckpt_dir, RES_STEPS, saved)
        write_s = time.perf_counter() - t0
        files = {name: os.path.getsize(os.path.join(path, name)) for name in os.listdir(path)}
        t0 = time.perf_counter()
        with open(os.path.join(path, "arrays.npz"), "rb") as f:
            os.fsync(f.fileno())
        fsync_s = time.perf_counter() - t0
        payload = sum(t.numel() * t.element_size() for t in tree_flatten_with_path(saved).values())

        fresh = Trainer(cfg, get_shape("train_4k"), device=DEV, ckpt_dir=ckpt_dir)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p2, o2, start = fresh.restore_or_init()
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
        fresh.ckpt.close()
        restored = {"params": p2, "opt": o2}
        # the part of read_s a restart pays whether or not it reads a checkpoint
        t0 = time.perf_counter()
        fresh.init_state()
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        bad = first_mismatch(saved, restored)
        if start != RES_STEPS or bad is not None:
            raise AssertionError(f"resilience: restored step {start}, leaf {bad} differs")
        key, leaf = next(iter(tree_flatten_with_path(p2).items()))
        planted = first_mismatch(saved, {"params": tree_map(
            lambda t: one_ulp_off(t) if t is leaf else t, p2), "opt": o2})
        if planted != f"params/{key}":
            raise AssertionError(f"resilience: the planted fault (params/{key} one ulp off) "
                                 f"read {planted}")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    del tr, fresh, saved, restored, params, opt_state, p2, o2
    torch.cuda.empty_cache()

    fm = datacenter_fault_model()
    measured = checkpoint_intervals(t_step, write_s, read_s, fm)
    tg, reduced = ac_search.search_graph(cfg, TRAIN_BATCH, SEQ)
    t0 = time.perf_counter()
    gp = evaluate_goodput(tg, datacenter_cluster(n_chips=1), fault=fm)
    goodput_s = time.perf_counter() - t0
    modelled = {"ckpt_bytes": gp.ckpt_bytes, "write_s": gp.ckpt.write_s,
                "read_s": gp.ckpt.read_s, "step_s": gp.step_s,
                "interval_steps": gp.ckpt.interval_steps, "efficiency": gp.efficiency,
                "host_s": goodput_s,
                # the card's step with MONET's δ and read-back, for each cluster size
                "intervals_at_measured_step": checkpoint_intervals(
                    t_step, gp.ckpt.write_s, gp.ckpt.read_s, fm)}
    emit("resilience", arch=cfg.name, layers=cfg.n_layers, batch=TRAIN_BATCH, seq=SEQ,
         remat=cfg.remat, steps=RES_STEPS, losses=res["losses"], step_s=res["step_s"],
         step_s_median_last_two=t_step,
         checkpoint={"write_s": write_s, "fsync_after_write_s": fsync_s, "read_s": read_s,
                     "init_state_s": init_s,
                     "payload_bytes": payload, "bytes_on_disk": sum(files.values()),
                     "files": files, "dir": "$TMPDIR", "bitexact": True,
                     "planted_fault": {"what": f"params/{key}: its first element one ulp off",
                                       "caught_at": planted}},
         fault_model={"name": "datacenter_fault_model()", "mtbf_hours": fm.mtbf_hours,
                      "restart_s": fm.restart_s},
         intervals_measured=measured,
         monet={"model": "MONET's analytic model (evaluate_goodput) on datacenter_cluster(1): "
                         "tpu_v5e_like() chips, not the card",
                "graph": {"nodes": len(tg.graph), "reduced": reduced}, **modelled,
                "measured_over_modelled": {"write_s": write_s / gp.ckpt.write_s,
                                           "bytes": payload / gp.ckpt_bytes}},
         parallel=monet_parallel(tg))
    return launches


#: monet_cli: the port's MONET command lines (name, what follows ``-m``, a line
#: each must print); each must exit 0
MONET_CLI = (
    ("verify", ["repro_torch.verify"], "all clean: 0 findings"),
    ("faultinject", ["repro_torch.core.faultinject", "--seed", "0"],
     "21/21 injected fault classes caught (seed 0)"),
    ("serve_datacenter", ["repro_torch.launch.serve", "--site", "datacenter", "--chips", "4",
                          "--slots", "16"], "max KEEP slots"),
    ("serve_edge_offload", ["repro_torch.launch.serve", "--site", "edge", "--chips", "4",
                            "--slots", "16", "--policy", "offload"], "max KEEP slots"),
)


def side_by_side(argvs, cwd=None) -> list[tuple[subprocess.CompletedProcess, float]]:
    """Each argv run by this interpreter (``PYTHONPATH=src``) in a process of
    its own on the card's host, all at once: (the finished process, its host
    seconds) for each."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))

    def run(argv):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, *argv], env=env, capture_output=True, text=True,
                              timeout=300, cwd=cwd)
        return proc, time.perf_counter() - t0

    with ThreadPoolExecutor(len(argvs)) as pool:
        return list(pool.map(run, argvs))


def phase_monet_cli(cfg) -> None:
    """``python -m`` each of ``MONET_CLI`` on the card's host, side by side
    (most of each is the interpreter's start): exit 0 and its line, host
    seconds; then MONET's KV bytes a token at ``cfg``'s widths (its
    GPT-2-shaped serving graph) beside the port's real cache, as ``serve``
    allocates it (``init_cache``, ``SERVE_BATCH`` × ``SERVE_MAX_SEQ``)."""
    done = side_by_side([["-m", *argv] for _, argv, _ in MONET_CLI])
    runs = {}
    for (name, argv, want), (proc, secs) in zip(MONET_CLI, done, strict=True):
        if proc.returncode or want not in proc.stdout:
            raise AssertionError(f"monet_cli {name}: exit {proc.returncode}, no {want!r}\n"
                                 f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
        lines = proc.stdout.strip().splitlines()
        runs[name] = {"argv": " ".join(argv), "exit": proc.returncode, "host_s": secs,
                      "lines": len(lines),
                      "report": lines if name.startswith("serve") else lines[-1]}
    model = {"d_model": cfg.d_model, "n_layers": cfg.n_layers, "n_heads": cfg.n_heads,
             "vocab": cfg.vocab}
    monet_kv = kv_bytes_per_token(model)
    cache = init_cache(cfg, SERVE_BATCH, SERVE_MAX_SEQ, DEV)
    leaves = list(tree_flatten_with_path(cache).items())
    cache_bytes = sum(t.numel() * t.element_size() for _, t in leaves)
    shapes = Counter(f"{tuple(t.shape)} {str(t.dtype).removeprefix('torch.')}"
                     for _, t in leaves)
    del cache
    torch.cuda.empty_cache()
    port_kv = cache_bytes / (SERVE_BATCH * SERVE_MAX_SEQ)
    emit("monet_cli", runs=runs,
         kv_bytes_per_token={
             "monet": monet_kv, "monet_model": f"GPT-2-shaped at {cfg.name}'s widths: "
                                               f"{model}, MHA, no window, bfloat16",
             "port_cache_bytes": cache_bytes, "port_cache_leaves": dict(shapes),
             "port_per_token": port_kv, "port_cache": f"init_cache({cfg.name}, "
                                                      f"{SERVE_BATCH}, {SERVE_MAX_SEQ})",
             "monet_over_port": monet_kv / port_kv})


# ---------------------------------------------------------------------------
# examples
# ---------------------------------------------------------------------------


EXAMPLES = os.path.join(ROOT, "examples", "port")
#: train_lm: the first call's steps, the second call's (it resumes at
#: LM_RESUME, the last commit before the first call's end), the use_flash
#: run's; batch and sequence are the twin's defaults
LM_FIRST, LM_SECOND, LM_RESUME, LM_FLASH_STEPS = 120, 300, 100, 8
LM_BATCH, LM_SEQ = 4, 512
#: losses reported after this many steps
LM_LOSS_AT = (1, 100, 120, 300)
#: the replayed steps (LM_RESUME + 1 .. LM_FIRST) from the same weights,
#: AdamW state and batches: losses and grad norms equal to the first call's
LM_REPLAY_TOL = 0.0
#: use_flash against the plain attention and norms: they differ by bf16
#: roundings (trap T1).  Each step's loss and grad norm is held to the plain
#: run's within these relative limits, set at 20-35x the largest readings
#: (NVIDIA H100 80GB HBM3, 700.00 W: losses 3.04e-5, grad norms 4.89e-4); the
#: flash output zeroed, a planted fault, read 1.9e-3 and 0.25 and must read
#: above one of them
LM_FLASH_RTOL = {"loss": 1e-3, "grad_norm": 1e-2}
#: the host twins at small arguments, with the rows each CSV holds; the one
#: table of them: tests/test_torch_examples.py reads it from this file and
#: runs each twin beside the reference at these arguments
HOST_TWINS = (("quickstart", [], None), ("dse_resnet", ["--sample", "20"], 20),
              ("serve_lm", ["--chips", "1", "4", "--slots", "4", "64"], 24),
              ("memory_wall", [], 32), ("parallel_training", ["--chips", "2", "4"], 18),
              ("resilience", ["--chips", "1", "2", "4"], 20), ("fusion_search", [], 68))


def example(name):
    """The twin ``examples/port/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(f"port_example_{name}",
                                                  os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def dir_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def run_train_lm(mod, argv) -> dict:
    """One in-process call of the train_lm twin, ``mod.main(argv)``: its log
    and stdout, the kernels it launched, its peak device memory, each
    checkpoint commit (step, seconds on the writer's thread, bytes on disk)
    and each restore (seconds of ``load_checkpoint``)."""
    writes, reads = [], []
    save, load = ckpt_store.save_checkpoint, train_module.load_checkpoint

    def timed_save(ckpt_dir, step, tree, extra=None):
        t0 = time.perf_counter()
        path = save(ckpt_dir, step, tree, extra)
        writes.append({"step": step, "write_s": time.perf_counter() - t0,
                       "bytes": dir_bytes(path)})
        return path

    def timed_load(*args, **kw):
        t0 = time.perf_counter()
        out = load(*args, **kw)
        reads.append({"step": out[1]["step"], "read_s": time.perf_counter() - t0})
        return out

    buf = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with (patched(ckpt_store, "save_checkpoint", timed_save),
          patched(train_module, "load_checkpoint", timed_load), contextlib.redirect_stdout(buf)):
        logs = mod.main(argv)
    return {"logs": logs, "stdout": buf.getvalue().splitlines(), "launches": dict(ops.LAUNCHES),
            "peak_memory_bytes": torch.cuda.max_memory_allocated(), "writes": writes,
            "reads": reads}


def check_lm_call(cfg, run, start, steps) -> dict:
    """A call's log covers steps ``start`` .. ``steps`` − 1 with finite losses
    and grad norms, and it launched each kernel the derived count a step
    times its steps.  Returns the count a step."""
    logs = run["logs"]
    if [l["step"] for l in logs] != list(range(start, steps)):
        raise AssertionError(f"train_lm logged steps {[l['step'] for l in logs]}, expected "
                             f"{start} .. {steps - 1}")
    if not all(math.isfinite(l["loss"]) and math.isfinite(l["grad_norm"]) for l in logs):
        raise AssertionError(f"train_lm: non-finite losses or grad norms {logs}")
    per_step = expected_launches(cfg, abstract_params(cfg))
    want = {name: n * (steps - start) for name, n in per_step.items()}
    if run["launches"] != want:
        raise AssertionError(f"train_lm launches {run['launches']}, expected {want}")
    return per_step


def lm_summary(run, steps) -> dict:
    times = [l["time_s"] for l in run["logs"]]
    steady = float(np.median(times[1:]))
    return {"steps": steps, "step_s_median_after_first": steady,
            "tokens_per_s": LM_BATCH * LM_SEQ / steady, "step_s_first": times[0],
            "peak_memory_bytes": run["peak_memory_bytes"], "checkpoints": run["writes"],
            "restores": run["reads"], "stdout": run["stdout"],
            "launches": run["launches"],
            "launches_per_step": {name: n // len(times) for name, n in run["launches"].items()}}


def phase_examples_lm(mod, root) -> tuple[dict, list]:
    """(a) ``examples/port/train_lm.py`` as documented: LM-100M at full size,
    ``--steps 120``, then ``--steps 300`` on the same ``--ckpt-dir``.  The
    trainer commits every 50 steps and at its last step; the commit of step
    120 is removed between the calls, as a run stopped after step 100's
    commit would leave the directory, so that the second call resumes at 100
    and replays steps 101–120 (held to the first call's).  Returns the
    launches of both calls and the log of the first ``LM_FLASH_STEPS`` steps."""
    cfg = mod.LM_100M
    ckpt = os.path.join(root, "ckpt")
    first = run_train_lm(mod, ["--steps", str(LM_FIRST), "--ckpt-dir", ckpt])
    per_step = check_lm_call(cfg, first, 0, LM_FIRST)
    commits = [w["step"] for w in first["writes"]]
    ckpt_bytes = first["writes"][-1]["bytes"]
    shutil.rmtree(os.path.join(ckpt, f"step_{LM_FIRST:08d}"))
    second = run_train_lm(mod, ["--steps", str(LM_SECOND), "--ckpt-dir", ckpt])
    check_lm_call(cfg, second, LM_RESUME, LM_SECOND)
    with open(os.path.join(root, "lm100m_torch_log.jsonl")) as f:
        log_lines = len(f.readlines())

    full = first["logs"][:LM_RESUME] + second["logs"]
    losses = [l["loss"] for l in full]
    replayed = list(zip(first["logs"][LM_RESUME:], second["logs"][:LM_FIRST - LM_RESUME],
                        strict=True))
    replay = {key: max(abs(a[key] - b[key]) for a, b in replayed)
              for key in ("loss", "grad_norm")}
    emit("examples_train_lm", arch=cfg.name, params=cfg.param_count(), batch=LM_BATCH,
         seq=LM_SEQ, remat=cfg.remat, use_flash=cfg.use_flash,
         config={k: getattr(cfg, k) for k in ("n_layers", "d_model", "n_heads", "n_kv_heads",
                                               "head_dim", "d_ff", "vocab", "mlp")},
         first_call=lm_summary(first, LM_FIRST),
         second_call=lm_summary(second, LM_SECOND),
         commits_first_call=commits, checkpoint_bytes=ckpt_bytes,
         removed_before_second_call=LM_FIRST, resumed_at=second["logs"][0]["step"],
         log_lines=log_lines, loss_at_step={n: losses[n - 1] for n in LM_LOSS_AT},
         replayed_steps=[LM_RESUME + 1, LM_FIRST], replay_max_abs_diff=replay,
         replay_tol=LM_REPLAY_TOL, losses=losses)
    if ([r["step"] for r in second["reads"]] != [LM_RESUME]
            or log_lines != LM_FIRST + LM_SECOND - LM_RESUME):
        raise AssertionError(f"the second call restored {second['reads']} (expected step "
                             f"{LM_RESUME} once); the log holds {log_lines} lines")
    if per_step["fused_adam"] != 2 or commits != [50, 100, LM_FIRST]:
        raise AssertionError(f"fused_adam {per_step['fused_adam']} a step (expected 2), "
                             f"commits {commits}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train_lm: the last loss {losses[-1]} is not below the first "
                             f"{losses[0]}")
    if max(replay.values()) > LM_REPLAY_TOL:
        raise AssertionError(f"train_lm: the resumed call's steps {LM_RESUME + 1}–{LM_FIRST} "
                             f"differ from the first call's by {replay}")
    return ({"examples_lm100m": first["launches"], "examples_lm100m_resumed": second["launches"]},
            first["logs"][:LM_FLASH_STEPS])


def lm_rel_diffs(logs, plain_logs) -> dict:
    """Each step's loss and grad norm against the plain run's, relative."""
    return {key: [abs(a[key] - b[key]) / abs(b[key]) for a, b in zip(logs, plain_logs, strict=True)]
            for key in LM_FLASH_RTOL}


def phase_examples_flash(mod, plain_logs, root) -> tuple[dict, dict]:
    """(b) the same LM-100M with ``use_flash=True`` (set here by
    ``dataclasses.replace``), ``LM_FLASH_STEPS`` steps from seed 0: losses
    and grad norms against the plain run's (``LM_FLASH_RTOL``), and again
    with the flash output zeroed through the wrapper, a planted fault that
    must read above them; launches.  Then flash forward, dq, dkv at its
    attention's shape and rmsnorm forward and backward at its rows and width
    against their plain versions (rows within ``BF16_ROW_RTOL``, planted
    faults that must read above), and fused_adam over its parameter tree
    (``time_adam_tree``: bit for bit), each timed beside bound, plain version
    and library call.  Returns the launches and the timings by kernel."""
    cfg = replace(mod.LM_100M, use_flash=True)
    flash = ops.flash_attention
    with patched(mod, "LM_100M", cfg):
        run = run_train_lm(mod, ["--steps", str(LM_FLASH_STEPS), "--ckpt-dir",
                                 os.path.join(root, "ckpt_flash")])
        with patched(ops, "flash_attention", lambda *a, **kw: flash(*a, **kw) * 0):
            faulty = run_train_lm(mod, ["--steps", str(LM_FLASH_STEPS), "--ckpt-dir",
                                        os.path.join(root, "ckpt_flash_fault")])
    check_lm_call(cfg, run, 0, LM_FLASH_STEPS)
    rel = lm_rel_diffs(run["logs"], plain_logs)
    fault = lm_rel_diffs(faulty["logs"], plain_logs)
    torch.cuda.empty_cache()

    case = (LM_BATCH, LM_SEQ, LM_SEQ, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_, True, None)
    errs = check_case(case, torch.bfloat16, 2e-2, 2e-2, seed=100, faults=True)
    timed = time_case(case, torch.bfloat16, reps=20)
    for name in FLASH:
        timed[name].update(max_abs_err=errs[name], max_row_rel_err=errs["row_rel"][name],
                           grid=tc_grid(name, case))
    timed["flash_fwd"]["lse_abs_err"] = errs["lse_abs"]
    norm = time_rmsnorm(LM_BATCH * LM_SEQ, cfg.d_model)
    timed["rmsnorm"], timed["rmsnorm_bwd"] = norm["forward"], norm["backward"]
    torch.cuda.empty_cache()
    timed["fused_adam"] = time_adam_tree(cfg)
    torch.cuda.empty_cache()
    emit("examples_train_lm_flash", arch=cfg.name, use_flash=True,
         run=lm_summary(run, LM_FLASH_STEPS),
         steps={key: [l[key] for l in run["logs"]] for key in LM_FLASH_RTOL},
         plain_steps={key: [l[key] for l in plain_logs] for key in LM_FLASH_RTOL},
         rel_diff=rel, rtol=LM_FLASH_RTOL,
         flash_shape=dict(zip(("B", "S", "T", "H", "Kv", "hd", "causal", "window"), case,
                              strict=True)),
         norm_shape={"rows": LM_BATCH * LM_SEQ, "d": cfg.d_model}, tol=2e-2,
         tol_row_rel=BF16_ROW_RTOL, tol_lse=BF16_LSE_ATOL, kernels=timed,
         planted_faults={"train_flash_output_zeroed": {
                             "rel_diff": fault,
                             "steps": {key: [l[key] for l in faulty["logs"]]
                                       for key in LM_FLASH_RTOL}},
                         "flash": errs["planted_faults"],
                         "rmsnorm": norm["forward"]["planted_faults"],
                         "rmsnorm_bwd": norm["backward"]["planted_faults"]})
    if any(max(rel[key]) > tol for key, tol in LM_FLASH_RTOL.items()):
        raise AssertionError(f"use_flash against the plain run: relative differences {rel} "
                             f"(tolerances {LM_FLASH_RTOL})")
    if all(max(fault[key]) <= tol for key, tol in LM_FLASH_RTOL.items()):
        raise AssertionError(f"use_flash with the flash output zeroed reads {fault}, within "
                             f"the tolerances {LM_FLASH_RTOL}")
    return {"examples_lm100m_flash": run["launches"]}, timed


def phase_examples_ga() -> None:
    """(c) ``examples/port/checkpointing_ga.py`` on the CPU and on the card:
    the same printed front and families, and the toy step's loss 32768 and
    grad norm 512 exactly on both."""
    mod = example("checkpointing_ga")
    out = {}
    for dev in ("cpu", DEV):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            loss, gnorm = mod.main(["--device", dev])
        out[dev] = {"loss": loss, "grad_norm": gnorm, "host_s": time.perf_counter() - t0,
                    "stdout": buf.getvalue().splitlines()}
    emit("examples_checkpointing_ga", runs=out, expected={"loss": 32768.0, "grad_norm": 512.0})
    if out["cpu"]["stdout"] != out[DEV]["stdout"] or any(
            (r["loss"], r["grad_norm"]) != (32768.0, 512.0) for r in out.values()):
        raise AssertionError(f"checkpointing_ga: the card's run differs from the CPU's, or the "
                             f"step is not 32768 / 512: {out}")


def phase_examples_host() -> None:
    """(d) the seven host twins, each ``python examples/port/<name>.py`` in a
    process of its own, side by side: exit 0, the CSV's rows as on the CPU,
    host seconds."""
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_host_twins_")
    csv_path = lambda name: os.path.join(out_dir, f"{name}.csv")
    try:
        done = side_by_side([[os.path.join(EXAMPLES, f"{name}.py"), *args,
                              *(["--out", csv_path(name)] if rows else [])]
                             for name, args, rows in HOST_TWINS], cwd=out_dir)
        runs = {}
        for (name, args, rows), (proc, secs) in zip(HOST_TWINS, done, strict=True):
            got = None
            if os.path.exists(csv_path(name)):
                with open(csv_path(name), newline="") as f:
                    got = sum(1 for _ in csv.reader(f)) - 1
            if proc.returncode or got != rows:
                raise AssertionError(f"examples/port/{name}.py: exit {proc.returncode}, {got} rows "
                                     f"(expected {rows})\n{proc.stdout[-2000:]}\n"
                                     f"{proc.stderr[-2000:]}")
            lines = proc.stdout.strip().splitlines()
            runs[name] = {"argv": " ".join(args), "exit": proc.returncode, "host_s": secs,
                          "csv_rows": got, "stdout_lines": len(lines), "last_line": lines[-1]}
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    emit("examples_host", runs=runs)


def phase_examples() -> tuple[dict, dict]:
    """The four parts of the ``examples`` phase; the train_lm calls write
    their checkpoints and log into a directory of their own under
    ``$TMPDIR``, removed at the end.  Returns the launches by path and
    the LM-100M kernel timings."""
    mod = example("train_lm")
    root = tempfile.mkdtemp(prefix="chip_smoke_examples_")
    try:
        with patched(tempfile, "tempdir", root):
            launches, plain_logs = phase_examples_lm(mod, root)
            torch.cuda.empty_cache()
            flash_launches, timed = phase_examples_flash(mod, plain_logs, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    phase_examples_ga()
    phase_examples_host()
    return {**launches, **flash_launches}, timed

# ---------------------------------------------------------------------------

PHASES = ("env", "build", "kernels", "train", "train_ssm", "train_mla", "train_moe", "remat",
          "ac_search", "train_opt", "train_mesh", "serve", "parity", "parity_ssm", "parity_serve",
          "parity_moe", "parity_opt", "dryrun", "trace", "resilience", "monet_cli",
          "examples")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--profile", action="store_true",
                    help="after each train phase (and remat's full and dots), profile one more "
                         "step; after each model's serve run, eight more decode calls")
    args = ap.parse_args()
    phases = args.phases.split(",")
    t0 = time.time()

    gemma = replace(get_config("gemma3-1b"), use_flash=True)
    mamba = replace(get_config("mamba2-1.3b"), use_flash=True)
    mla = replace(get_config("minicpm3-4b"), use_flash=True)
    olmoe = replace(get_config("olmoe-1b-7b"), use_flash=True)
    lm100m = example("train_lm").LM_100M
    seconds, last = {}, time.time()

    def lap(phase):
        nonlocal last
        seconds[phase] = round(time.time() - last, 1)
        last = time.time()

    if "env" in phases:
        phase_env()
        lap("env")
    if "build" in phases:
        phase_build(norm_widths(gemma, mamba, mla, olmoe, lm100m))
        lap("build")
    timed = None
    if "kernels" in phases:
        timed = phase_kernels_flash(gemma, olmoe)
        torch.cuda.empty_cache()
        timed["more"] = phase_kernels_more(gemma, mamba, mla, olmoe)
        torch.cuda.empty_cache()
        lap("kernels")
    launches = {}
    if "train" in phases:
        launches["train"] = phase_train(gemma, "train", args.profile)
        torch.cuda.empty_cache()
        lap("train")
    if "train_ssm" in phases:
        launches["train_ssm"] = phase_train(mamba, "train_ssm", args.profile)
        torch.cuda.empty_cache()
        lap("train_ssm")
    if "train_mla" in phases:
        launches["train_mla"] = phase_train(
            replace(mla, n_layers=MLA_LAYERS), "train_mla", args.profile, batch=MLA_BATCH,
            steps=MLA_STEPS, reduced=f"n_layers 62 -> {MLA_LAYERS} (weights and AdamW state of "
                                     "62 layers, ≈ 51 GB, leave too little for activations); "
                                     f"batch {MLA_BATCH}")
        torch.cuda.empty_cache()
        lap("train_mla")
    if "train_moe" in phases:
        launches["train_moe"] = phase_train(
            replace(olmoe, n_layers=MOE_LAYERS), "train_moe", args.profile, batch=MOE_BATCH,
            steps=MOE_STEPS, reduced=f"n_layers 16 -> {MOE_LAYERS} (weights, gradients and "
                                     "AdamW state of 16 layers, ≈ 83 GB, do not fit the card)")
        torch.cuda.empty_cache()
        lap("train_moe")
    if "remat" in phases:
        launches.update(phase_remat(gemma, args.profile))
        lap("remat")
    if "ac_search" in phases:
        launches.update(phase_ac_search(gemma))
        lap("ac_search")
    if "train_opt" in phases:
        launches.update(phase_train_opt(gemma))
        lap("train_opt")
    if "train_mesh" in phases:
        launches.update(phase_train_mesh(gemma, mamba))
        lap("train_mesh")
    if "serve" in phases:
        launches.update(phase_serve((gemma, mamba, mla, olmoe), args.profile))
        lap("serve")
    if "parity" in phases:
        phase_parity()
        lap("parity")
    if "parity_ssm" in phases:
        phase_parity_ssm()
        lap("parity_ssm")
    if "parity_serve" in phases:
        phase_parity_serve()
        lap("parity_serve")
    if "parity_moe" in phases:
        phase_parity_moe()
        lap("parity_moe")
    if "parity_opt" in phases:
        phase_parity_opt()
        lap("parity_opt")
    if "dryrun" in phases:
        phase_dryrun()
        lap("dryrun")
    if "trace" in phases:
        launches.update(phase_trace(gemma, mamba, olmoe))
        lap("trace")
    if "resilience" in phases:
        launches["resilience"] = phase_resilience(gemma)
        lap("resilience")
    if "monet_cli" in phases:
        phase_monet_cli(gemma)
        lap("monet_cli")
    timed_lm = None
    if "examples" in phases:
        more, timed_lm = phase_examples()
        launches.update(more)
        lap("examples")

    emit("done", phases=phases, seconds=round(time.time() - t0, 1), phase_seconds=seconds)
    if timed is not None and {"train", "train_ssm"} <= set(launches):
        line = []
        for name, meta in KERNELS.items():
            by_path = {path: counts[name] for path, counts in launches.items()}
            # a kernel's own path: gemma3-1b for the flash kernels, mamba2-1.3b
            # for the others (rmsnorm, its backward and fused_adam run on both)
            own = "train" if name in FLASH else "train_ssm"
            entry = {"name": name, **meta, "launches": by_path[own],
                     "launches_by_path": by_path}
            if name == "rmsnorm":
                steps = SERVE_PROMPT + SERVE_NEW
                entry["launches_per_decode_call"] = {
                    path: n // steps for path, n in by_path.items() if path.startswith("serve_")}
            if name in FLASH:
                g, w, o = (timed[layer][name] for layer in ("global", "window", "olmoe"))
                entry.update({"max_abs_err": max(g["max_abs_err"], w["max_abs_err"],
                                                 o["max_abs_err"]),
                              "tol": 2e-2, "rtol": 2e-2,
                              "max_row_rel_err": max(g["max_row_rel_err"],
                                                     w["max_row_rel_err"],
                                                     o["max_row_rel_err"]),
                              "tol_row_rel": BF16_ROW_RTOL,
                              "ms": g["ms"], "plain_ms": g["plain_ms"],
                              "bound_ms": g["bound_ms"], "bound_by": g["bound_by"],
                              "library_ms": g["library_ms"], "grid": g.get("grid"),
                              "shape": f"bf16 B={TRAIN_BATCH} S=T={SEQ} H={gemma.n_heads} "
                                       f"Kv={gemma.n_kv_heads} hd={gemma.head_dim_} causal",
                              "window_layer": {"window": gemma.window, **{
                                  key: w[key] for key in ("ms", "plain_ms", "bound_ms",
                                                          "bound_by", "library_ms")}},
                              "olmoe_layer": {
                                  "shape": f"bf16 B={TRAIN_BATCH} S=T={SEQ} "
                                           f"H={olmoe.n_heads} Kv={olmoe.n_kv_heads} "
                                           f"hd={olmoe.head_dim_} causal",
                                  "launches_train_moe": by_path.get("train_moe"),
                                  **{key: o[key] for key in (
                                      "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                      "max_abs_err", "max_row_rel_err", "grid")}}})
                if name != "flash_fwd":
                    # the library's backward computes dq, dk and dv in one call
                    entry["library_note"] = ("whole autograd backward of "
                                             "F.scaled_dot_product_attention (dq, dk, dv): "
                                             "compare with flash_dq + flash_dkv")
                    entry["dq_plus_dkv_ms"] = {
                        layer: timed[layer]["flash_dq"]["ms"] + timed[layer]["flash_dkv"]["ms"]
                        for layer in ("global", "window", "olmoe")}
            else:
                t = timed["more"][name]
                entry.update({"max_abs_err": t["max_abs_err"], "tol": t.get("tol", 2e-2),
                              "rtol": t.get("rtol", 2e-2), "ms": t["ms"],
                              "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                              "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                              "shape": t["shape"]})
                for key in ("library_note", "backward_plain_ms", "other_shapes", "grid",
                            "max_row_rel_err", "tol_row_rel", "dscale_rel_err",
                            "tol_dscale_rel", "autograd_of_plain_ms", "planted_faults",
                            "tree"):
                    if key in t:
                        entry[key] = t[key]
            if timed_lm is not None and name in timed_lm:
                t = timed_lm[name]
                if name in FLASH:
                    shape = (f"bf16 B={LM_BATCH} S=T={LM_SEQ} H={lm100m.n_heads} "
                             f"Kv={lm100m.n_kv_heads} hd={lm100m.head_dim_} causal")
                elif name == "fused_adam":
                    shape = (f"{lm100m.name}'s parameter tree: {t['leaves']} leaves, "
                             f"{t['elements']} elements, fp32 m/v, one multi-tensor call")
                else:
                    shape = f"bf16 rows={LM_BATCH * LM_SEQ} d={lm100m.d_model}"
                path = "examples_lm100m" if name == "fused_adam" else "examples_lm100m_flash"
                entry["lm100m_layer"] = {
                    "shape": shape, f"launches_{path}": by_path.get(path),
                    **{key: t[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                               "library_ms", "library_note", "max_abs_err",
                                               "tol", "max_row_rel_err", "grid",
                                               "planted_faults") if key in t}}
            line.append(entry)
        print(json.dumps({"kernels": line}), flush=True)
    print(smi(), flush=True)
    if set(phases) >= set(PHASES):
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
