#!/usr/bin/env python
"""Where the bf16 flash kernels spend their time, without ncu:

    python3 scripts/flash_phases.py

Copies ``src/repro_torch`` into ``build/flash_phases/`` and marks the phases
of ``flash_fwd_wg_kernel``, ``flash_dq_wg_kernel`` and ``flash_dkv_wg_kernel``
there (thread 0 of each warpgroup adds the ``clock64`` cycles since the
previous mark into a shared counter, and the block's counters into a device
array at its end), builds the copy, runs one call of each at gemma3-1b's
global layer (B 4, S = T 4096, H 4, Kv 1, hd 256: the backward's "split"
layout), its 512-key window layer, and olmoe-1b-7b's layer (H = Kv = 16,
hd 128: dq's "split", dk/dv's "rows") after a warm-up, and prints each
phase's cycles a block for each warpgroup and its share.
The marks cost some cycles of their own; the repository's kernels are not
changed.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "build" / "flash_phases"
#: by source: (where, the statement, its occurrence, the phase that ends
#: there): a mark goes after the statement, or before it (and before its loop
#: header)
MARKS = {
    "flash_fwd": [
        ("after", "hop::mbar_wait(q_full, 0);", 1, "start: barriers, Q in"),
        ("after", "pack_p();", 1, "first tile: K wait, s, softmax, pack"),
        ("after", "hop::mbar_wait(&v_full[it % VST], (it / VST) & 1);", 1, "loop: K, V waits"),
        ("after", "pv_product(it);", 1, "loop: s and p·v issued"),
        ("after", "hop::fence_regs(sc);", 2, "loop: wait for s"),
        ("after", "softmax(j);", 1, "loop: softmax (p·v in flight)"),
        ("after", "pack_p();", 2, "loop: wait for p·v, rescale o, pack p"),
        ("after", "__syncwarp();", 2, "loop: barrier, the last warpgroup's refill"),
        ("after", "for (int hh = 0; hh < NH; ++hh) hop::fence_regs(acc[hh]);", 1,
         "last tile: V wait, p·v"),
    ],
    "flash_dkv": [
        ("after", "hop::mbar_wait(kv_full, 0);", 1, "start: barriers, K and V in"),
        ("after", "const int s = it % ST, q0 = (qt_lo + it % nq) * BM;", 1,
         "rows: refill (thread 0 waits for the other warpgroup), loop"),
        ("after", "hop::mbar_wait(&full[s], (it / ST) & 1);", 1, "rows: stage wait"),
        ("after", "hop::fence_regs(st);", 1, "rows: sT product"),
        ("before", "hop::wg_wait<0>();", 1, "rows: p elementwise"),
        ("after", "hop::fence_regs(dpt);", 1, "rows: dpT product (rest)"),
        ("before", "hop::wg_fence();", 2, "rows: ds, pack"),
        ("after", "hop::fence_regs(acc_k);", 1, "rows: dv, dk products"),
        ("after", "if (tid == 0) hop::mbar_arrive(&empty[s]);", 1, "rows: barrier, arrive"),
        ("after", "const int s = it % ST, q0 = (qt_lo + it % nq) * BM;", 2,
         "split: refill, loop"),
        ("after", "hop::mbar_wait(&full[s], (it / ST) & 1);", 2, "split: stage wait"),
        ("after", "hop::fence_regs(st);", 2, "split: sT product"),
        ("before", "hop::wg_wait<0>();", 3, "split: p elementwise"),
        ("after", "hop::fence_regs(dpt);", 2, "split: dpT product (rest)"),
        ("after", "hop::fence_async_smem();", 2, "split: ds, pT and dsT to shared memory"),
        ("after", "hop::bar_sync(3, 256);  // pᵀ and dsᵀ are whole", 1,
         "split: barrier (pT, dsT whole)"),
        ("after", "hop::fence_regs(acc_k);", 2, "split: dv, dk products"),
        ("after", "hop::bar_sync(3, 256);  // both are done with pᵀ, dsᵀ and the stage", 1,
         "split: barrier (stage done)"),
    ],
    "flash_dq": [
        ("after", "hop::mbar_wait(qo_full, 0);", 1, "start: barriers, lse, Q and dO in"),
        ("after", "const int s = it % ST, k0 = (kt_lo + it) * BN;", 1,
         "rows: refill (thread 0 waits for the other warpgroup), loop"),
        ("after", "hop::mbar_wait(&full[s], (it / ST) & 1);", 1, "rows: stage wait"),
        ("after", "hop::fence_regs(sc);", 1, "rows: s product"),
        ("before", "hop::wg_wait<0>();", 1, "rows: p elementwise"),
        ("after", "hop::fence_regs(dp);", 1, "rows: dp product (rest)"),
        ("before", "hop::wg_fence();", 2, "rows: ds"),
        ("after", "hop::fence_regs(acc);", 1, "rows: pack, dq product"),
        ("after", "if (tid == 0) hop::mbar_arrive(&empty[s]);", 1, "rows: barrier, arrive"),
        ("after", "const int s = it % ST, k0 = (kt_lo + it) * BN;", 2, "split: refill, loop"),
        ("after", "hop::mbar_wait(&full[s], (it / ST) & 1);", 2, "split: stage wait"),
        ("after", "hop::fence_regs(sc);", 2, "split: s product"),
        ("before", "hop::wg_wait<0>();", 3, "split: p elementwise"),
        ("after", "hop::fence_regs(dp);", 2, "split: dp product (rest)"),
        ("after", "hop::fence_async_smem();", 2, "split: ds to shared memory"),
        ("after", "hop::bar_sync(3, 256);  // ds is whole", 1, "split: barrier (ds whole)"),
        ("after", "hop::fence_regs(acc);", 2, "split: dq product"),
        ("after", "hop::bar_sync(3, 256);  // both are done with ds and the stage", 1,
         "split: barrier (stage done)"),
    ],
}
#: the line before which each kernel's counters go to device memory, and the
#: first line of its body
FLUSH = {"flash_fwd": "  // lse = m·scale + log l; o = acc / l rounded to bf16 once",
         "flash_dkv": "  // dk and dv of the warpgroup's keys and columns, rounded to bf16 once",
         "flash_dq": "  // dq of the warpgroup's rows and columns, rounded to bf16 once"}
#: warpgroups a block at most (the forward runs three up to hd 128)
W = 3
HEAD = {"flash_fwd": "  using C = FwdWg<D>;\n", "flash_dkv": "  using C = DkvWg<D>;\n",
        "flash_dq": "  using C = DqWg<D>;\n"}
SHAPES = {"gemma3-1b global": (4, 4096, 4096, 4, 1, 256, None),
          "gemma3-1b window": (4, 4096, 4096, 4, 1, 256, 512),
          "olmoe-1b-7b": (4, 4096, 4096, 16, 16, 128, None)}


def instrument(name: str, src: str) -> str:
    marks, lines = MARKS[name], src.split("\n")
    inserts = []
    for k, (where, text, occurrence, phase) in enumerate(marks):
        hits = [i for i, line in enumerate(lines) if line.strip() == text]
        if len(hits) < occurrence:
            raise SystemExit(f"{name}.cu no longer has the statement of {phase!r}: {text}")
        i = hits[occurrence - 1]
        if where == "before":
            while lines[i - 1].strip().startswith(("for (", "#pragma")):
                i -= 1
        else:
            i += 1
        inserts.append((i, f"  PHASE_MARK({k});"))
    for i, line in sorted(inserts, reverse=True):
        lines.insert(i, line)
    out, K = "\n".join(lines), len(marks)
    out = out.replace(HEAD[name], HEAD[name] + f"  __shared__ long long phase_cycles[{W}][{K}];\n"
                      "  long long phase_t0 = clock64();\n"
                      f"  if (threadIdx.x < {W * K}) (&phase_cycles[0][0])[threadIdx.x] = 0;\n", 1)
    out = out.replace(FLUSH[name], f"  if (n_it > 0 && tid == 0) {{\n"
                      f"    for (int k = 0; k < {K}; ++k) atomicAdd(&g_phase_cycles[w][k], "
                      "(unsigned long long)phase_cycles[w][k]);\n"
                      "    if (w == 0) atomicAdd(&g_phase_blocks, 1ull);\n  }\n" + FLUSH[name], 1)
    out = out.replace("namespace fa {\n", "namespace fa {\n"
                      f"__device__ unsigned long long g_phase_cycles[{W}][{K}];\n"
                      "__device__ unsigned long long g_phase_blocks;\n"
                      "#define PHASE_MARK(k) do { if (tid == 0) { const long long now = "
                      "clock64(); phase_cycles[w][k] += now - phase_t0; phase_t0 = now; } "
                      "} while (0)\n", 1)
    return out + f'''
extern "C" int {name}_phase_cycles(unsigned long long* out) {{
  cudaError_t e = cudaMemcpyFromSymbol(out, fa::g_phase_cycles, sizeof(unsigned long long) * {W * K});
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(out + {W * K}, fa::g_phase_blocks, sizeof(unsigned long long));
  return (int)e;
}}
'''


def main() -> None:
    shutil.rmtree(OUT, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch", OUT / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name in MARKS:
        cu = OUT / "src" / "repro_torch" / "kernels" / "csrc" / f"{name}.cu"
        cu.write_text(instrument(name, cu.read_text()))
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(OUT / "build")
    sys.path.insert(0, str(OUT / "src"))
    import numpy as np
    import torch
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import flash_attention as fa

    out = {"device": torch.cuda.get_device_name(0)}
    for tag, (B, S, T, H, Kv, hd, window) in SHAPES.items():
        rng = np.random.default_rng(7)
        t = lambda shape: torch.from_numpy(  # noqa: E731
            rng.standard_normal(shape).astype(np.float32)).cuda().bfloat16()
        q, k, v, do = t((B, S, H, hd)), t((B, T, Kv, hd)), t((B, T, Kv, hd)), t((B, S, H, hd))
        o, lse = fa.flash_fwd_cuda(q, k, v, True, window)
        delta = ops.attention_delta(o, do)
        bw = (q, k, v, do, lse, delta, True, window)
        for name, fn, args in (("flash_fwd", fa.flash_fwd_cuda, (q, k, v, True, window)),
                               ("flash_dq", fa.flash_dq_cuda, bw),
                               ("flash_dkv", fa.flash_dkv_cuda, bw)):
            lib, K = build.load_library(name), len(MARKS[name])
            counts = (ctypes.c_ulonglong * (W * K + 1))()
            fn(*args)
            torch.cuda.synchronize()
            getattr(lib, f"{name}_phase_cycles")(counts)
            before = np.array(list(counts), dtype=np.float64)
            fn(*args)
            torch.cuda.synchronize()
            if getattr(lib, f"{name}_phase_cycles")(counts) != 0:
                raise SystemExit("reading the counters failed")
            diff = np.array(list(counts), dtype=np.float64) - before
            blocks = diff[-1]
            cycles = diff[:-1].reshape(W, K) / blocks
            cycles = cycles[cycles.sum(1) > 0]  # the warpgroups the kernel has
            total = cycles.sum(1)
            out[f"{tag} {name}"] = {
                "blocks": int(blocks), "cycles_a_block": total.round(0).tolist(),
                "phases": {phase: {"cycles": cycles[:, j].round(0).tolist(),
                                   "share": (cycles[:, j] / total).round(4).tolist()}
                           for j, (_, _, _, phase) in enumerate(MARKS[name])
                           if cycles[:, j].sum() > 0}}
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
