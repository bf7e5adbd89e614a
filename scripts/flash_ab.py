#!/usr/bin/env python
"""Time the bf16 flash kernels, forward (``flash_fwd_cuda``) and backward
(``flash_dq_cuda``, ``flash_dkv_cuda``), from several source trees in one
process tree on one GPU, to compare two versions of the kernels on the same
card:

    python3 scripts/flash_ab.py TREE_A TREE_B     # each holds src/repro_torch

Shapes: gemma3-1b's global and 512-key window layers (B 4, S = T 4096, H 4,
Kv 1, hd 256), olmoe-1b-7b's layer (H = Kv = 16, hd 128) and LM-100M's (B 4,
S = T 512, H 10, Kv 5, hd 64), all causal.  Each tree's kernels build into
``TREE/build`` (in parallel), then each tree is timed in a fresh process in
the order A, B, B, A: three means of 20 calls of each by CUDA events after a
warm-up, each call's device time by kernel (torch.profiler, 10 calls), and
its largest relative 2-norm error of a row against the plain version (rows
held to at least 2^-8 of the median row's norm, as chip_smoke.py holds them;
o, dq, dk, dv), and the largest error of lse.
Put the parent with ``git archive HEAD | tar -x -C DIR`` into a directory
``.gitignore`` lists.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

BUILD = ("from repro_torch.kernels import build; build.load_library('flash_dq'); "
         "print('built in', round(build.BUILD_INFO['seconds'], 1), 's')")
TIME = r'''
import json, numpy as np, torch
from torch.profiler import ProfilerActivity, profile
from repro_torch.kernels import flash_attention as fa, ops
SHAPES = {"global": (4, 4096, 4096, 4, 1, 256, None), "window": (4, 4096, 4096, 4, 1, 256, 512),
          "olmoe": (4, 4096, 4096, 16, 16, 128, None), "lm100m": (4, 512, 512, 10, 5, 64, None)}
out = {"device": torch.cuda.get_device_name(0)}
def row_rel(got, want):
    g, w = got.float().reshape(-1, got.shape[-1]), want.float().reshape(-1, want.shape[-1])
    num, den = (g - w).norm(dim=-1), w.norm(dim=-1)
    den = den.clamp_min(2 ** -8 * float(den.median()))
    return float(torch.where(num == 0, 0.0, num / den).max())
for tag, (B, S, T, H, Kv, hd, window) in SHAPES.items():
    rng = np.random.default_rng(7)
    t = lambda shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda().bfloat16()
    q, k, v, do = t((B, S, H, hd)), t((B, T, Kv, hd)), t((B, T, Kv, hd)), t((B, S, H, hd))
    o, lse = fa.flash_fwd_cuda(q, k, v, True, window)
    delta = ops.attention_delta(o, do)
    bw = (q, k, v, do, lse, delta, True, window)
    res = {}
    for name, f in (("flash_fwd", lambda: fa.flash_fwd_cuda(q, k, v, True, window)),
                    ("flash_dq", lambda: fa.flash_dq_cuda(*bw)),
                    ("flash_dkv", lambda: fa.flash_dkv_cuda(*bw))):
        f(); torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ms = []
        for _ in range(3):
            start.record()
            for _ in range(20):
                f()
            stop.record(); torch.cuda.synchronize(); ms.append(start.elapsed_time(stop) / 20)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                f()
            torch.cuda.synchronize()
        kernel = sum(e.self_device_time_total for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / 10
        res[name] = {"ms": ms, "kernel_ms": kernel}
    o_p, lse_p = fa.flash_fwd_plain(q, k, v, True, window)
    got = (o, fa.flash_dq_cuda(*bw), *fa.flash_dkv_cuda(*bw))
    want = (o_p, fa.flash_dq_plain(*bw), *fa.flash_dkv_plain(*bw))
    res["row_rel"] = [row_rel(a, b) for a, b in zip(got, want)]
    res["lse_abs"] = float((lse - lse_p).abs().max())
    del got, want, o_p, lse_p
    torch.cuda.empty_cache()
    out[tag] = res
print(json.dumps(out))
'''


def env(root: str) -> dict:
    return {**os.environ, "PYTHONPATH": os.path.join(root, "src"),
            "REPRO_TORCH_BUILD_DIR": os.path.join(root, "build")}


def main() -> None:
    roots = [os.path.abspath(r) for r in sys.argv[1:]]
    if not roots:
        sys.exit(__doc__)
    t0 = time.time()
    procs = [subprocess.Popen([sys.executable, "-c", BUILD], env=env(r), text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in roots]
    for r, p in zip(roots, procs, strict=True):
        out = p.communicate()[0]
        if p.returncode:
            sys.exit(f"{r}: build failed\n{out[-4000:]}")
        print(os.path.basename(r), out.strip().splitlines()[-1], flush=True)
    print("build wall", round(time.time() - t0, 1), "s", flush=True)
    for r in roots + roots[::-1]:
        p = subprocess.run([sys.executable, "-c", TIME], env=env(r), capture_output=True,
                           text=True)
        if p.returncode:
            sys.exit(f"{r}: timing failed\n{p.stderr[-4000:]}")
        print(os.path.basename(r), p.stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
