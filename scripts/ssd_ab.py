#!/usr/bin/env python
"""Time the bf16 SSD chunk, forward (``ssd_chunk_cuda``) and backward
(``ssd_chunk_bwd_cuda``), at mamba2-1.3b's shape (B 4, nc 16, Q 256, 64 heads
of 64, G 1, N 128) from several source trees in one process tree on one GPU,
to compare two versions of the kernels on the same card:

    python3 scripts/ssd_ab.py TREE_A TREE_B     # each holds src/repro_torch

Each tree's kernels build into ``TREE/build`` (in parallel), then each tree
is timed in a fresh process in the order A, B, B, A: for each direction three
means of 20 calls by CUDA events after a warm-up and the call's device time
by kernel (torch.profiler, 5 calls); for the forward also the largest
relative 2-norm error of a row of y and of the states against the plain
version (rows held to at least 2^-8 of the median row's norm, as
chip_smoke.py holds them).  Put the parent with ``git archive HEAD | tar -x
-C DIR`` into a directory ``.gitignore`` lists.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

BUILD = ("from repro_torch.kernels import build; build.load_library('ssd_chunk'); "
         "print('built in', round(build.BUILD_INFO['seconds'], 1), 's')")
TIME = r'''
import json, numpy as np, torch
from torch.profiler import ProfilerActivity, profile
from repro_torch.kernels import ssd_chunk as sc
rng = np.random.default_rng(16)
def randn(shape, dtype):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda().to(dtype)
Bt, nc, Q, H, hp, G, N = 4, 16, 256, 64, 64, 1, 128
x = randn((Bt, nc, Q, H, hp), torch.bfloat16)
dt = randn((Bt, nc, Q, H), torch.float32).abs() * 0.1
b, c = randn((Bt, nc, Q, 2 * G, N), torch.bfloat16).split(G, dim=3)
a = -randn((H,), torch.float32).abs() - 0.1
dy = randn(x.shape, torch.bfloat16)
dS = randn((Bt, nc, H, N, hp), torch.float32)
dcum = randn((Bt, nc, Q, H), torch.float32)
def row_rel(got, want):
    g, w = got.float().reshape(-1, got.shape[-1]), want.float().reshape(-1, want.shape[-1])
    num, den = (g - w).norm(dim=-1), w.norm(dim=-1)
    den = den.clamp_min(2 ** -8 * float(den.median()))
    return float(torch.where(num == 0, 0.0, num / den).max())
out = {"device": torch.cuda.get_device_name(0)}
for name, f in (("ssd_chunk", lambda: sc.ssd_chunk_cuda(x, dt, b, c, a)),
                ("ssd_chunk_bwd", lambda: sc.ssd_chunk_bwd_cuda(x, dt, b, c, a, dy, dS, dcum))):
    f(); torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ms = []
    for _ in range(3):
        start.record()
        for _ in range(20):
            f()
        stop.record(); torch.cuda.synchronize(); ms.append(start.elapsed_time(stop) / 20)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            f()
        torch.cuda.synchronize()
    split = {e.key.removeprefix("void ").split("(")[0]: e.self_device_time_total / 1e3 / 5
             for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA}
    out[name] = {"ms": ms, "split_ms": split}
got, want = sc.ssd_chunk_cuda(x, dt, b, c, a), sc.ssd_chunk_plain(x, dt, b, c, a)
out["ssd_chunk"]["row_rel"] = {"y": row_rel(got[0], want[0]), "states": row_rel(got[1], want[1])}
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
