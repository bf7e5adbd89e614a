#!/usr/bin/env python
"""Where the bf16 SSD chunk's kernels, forward and backward, spend their
time, without ncu:

    python3 scripts/ssd_phases.py

Copies ``src/repro_torch`` into ``build/ssd_phases/`` and marks the phases of
``ssd_chunk_wg_kernel`` (the forward) and ``ssd_chunk_bwd_wg_kernel`` (the
backward's main kernel) there (thread 0 of each warpgroup adds the
``clock64`` cycles since the previous mark into a shared counter, and the
block's counters into a device array at its end), builds the copy, runs one
call of each at mamba2-1.3b's shape (B 4, nc 16, Q 256, 64 heads of 64, G 1,
N 128, bf16) after a warm-up, and prints each phase's cycles a block for each
warpgroup and its share (the forward's by role: its states blocks and its y
blocks, whose phases are apart).  The marks cost some cycles of their own;
the repository's kernels are not changed.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "build" / "ssd_phases"
#: (where, the statement, its occurrence, the phase that ends there): a mark
#: goes after the statement, or before it (and before its loop header)
#: by kernel: its signature's line (the marks are searched from there to
#: the next template), and its marks (where, the statement, its occurrence,
#: the phase that ends there): a mark goes after the statement, or before it
#: (and before its loop header); the forward's carry the role they belong to
MARKS = {
    "fwd": ("ssd_chunk_wg_kernel(const __grid_constant__ FwdMaps maps, const FwdArgs A) {", [
        ("after", "hop::bar_sync(bar, 128);", 1, "start: barriers, every head's dt loaded"),
        ("after", "hop::bar_sync(bar, 128);", 2, "start: every head's scan"),
        ("after", "hop::bar_sync(bar, 128);", 3, "start: every head's cum"),
        ("after", "hop::bar_sync(bar, 128);", 4, "start: every head's weights (states: cum out)"),
        ("after", "hop::mbar_wait(&bars[0], 0);", 1, "start: B and C in"),
        ("after", "for (int j = 0; j < NTM; ++j) hop::fence_regs(s[j]);", 1,
         "y: the scores C·Bᵀ, once a block"),
        ("after", "const float ci[2] = {vcum[ti * BT + rl0], vcum[ti * BT + rl0 + 8]};", 1,
         "y: a head's y out, the loop"),
        ("after", "hop::mbar_wait(&ring_full[q], (rs / RING) & 1);", 1, "y: x tile wait"),
        ("after", "uint32_t af[4][4];", 1, "y: att"),
        ("after", "hop::fence_regs(y);", 1, "y: pack, att·x product"),
        ("after", "release(rs++);", 1, "y: release, refill"),
        ("after", "const float* vw = vecs + (3 * k + 2) * QMAX;", 1,
         "states: a head's states out, the loop"),
        ("after", "hop::mbar_wait(&ring_full[q], (rs / RING) & 1);", 2,
         "states: cum out, x tile wait"),
        ("before", "hop::wg_fence();", 3, "states: (B·w)ᵀ operands (ldmatrix, scale)"),
        ("after", "for (int mt = 0; mt < NMT; ++mt) hop::fence_regs(st[mt]);", 1,
         "states: product"),
        ("after", "release(rs++);", 2, "states: release, refill"),
    ]),
    "bwd": ("ssd_chunk_bwd_wg_kernel(const __grid_constant__ WgMaps maps, const WgArgs A) {", [
    ("after", "hop::mbar_wait(&bars[0], 0);", 1, "wait for B and C"),
    ("after", "if (tid == 0 && hs > 0) issue_held(hs + 1);", 1, "walk 1: head's barrier"),
    ("after", "hop::fence_async_smem();", 3, "walk 1: dS to bf16"),
    ("after", "wg_head_vectors(d, a, vdt, vcum, sTot, tid, bar);", 1, "walk 1: dt, cum"),
    ("after", "hop::mbar_wait(&held_full[hsl], (hs >> 1) & 1);", 1, "walk 1: held tile"),
    ("after", "hop::mbar_wait(&ring_full[q], (rs / RING) & 1);", 1, "walk 1: streamed tile"),
    ("after", "hop::fence_regs(dPT);", 1, "walk 1: s, dP products"),
    ("after", "const int col = rows_sum16(rp, lane);", 1, "walk 1: P, ds, sums of dP P"),
    ("before", "hop::wgmma_rs<1>(du, pa[kk], hop::Sw<HP>::desc_mn(sY, kk, BT), 1);", 1,
     "walk 1: pack"),
    ("after", "hop::fence_regs(du);", 1, "walk 1: du, dB products"),
    ("after", "if (tid == 0) issue_ring(rs + RING);", 1, "walk 1: barrier, row sums"),
    ("after", "hop::fence_regs(qv);", 1, "states: q product"),
    ("after", "hop::fence_regs(accN);", 2, "states: dx, dw, ddt, dB product"),
    ("after", "combine(p.pdb);", 1, "dB over the warpgroups"),
    ("after", "if (tid == 0 && hs > 0) issue_held(hs + 1);", 2, "walk 2: head's barrier"),
    ("after", "hop::mbar_wait(&held_full[hsl], (hs >> 1) & 1);", 2, "walk 2: held tile"),
    ("after", "hop::mbar_wait(&ring_full[q], (rs / RING) & 1);", 2, "walk 2: streamed tile"),
    ("after", "hop::fence_regs(dP);", 1, "walk 2: dP product"),
    ("before", "hop::wgmma_rs<1>(accN, da[kk], hop::Sw<N>::desc_mn(sB, kk, BT), 1);", 1,
     "walk 2: ds, pack"),
    ("after", "hop::fence_regs(accN);", 3, "walk 2: dC product"),
    ("after", "if (tid == 0) issue_ring(rs + RING);", 2, "walk 2: barrier"),
    ("after", "combine(p.pdc);", 1, "dC over the warpgroups"),
]),
}
#: the statement after which each kernel declares its counters
HEAD = {"fwd": "  using W = FwdWg<HP, N>;\n", "bwd": "  using W = Wg<HP, N>;\n"}


def instrument(src: str) -> str:
    lines = src.split("\n")
    inserts = []
    for kernel, (signature, marks) in MARKS.items():
        start = next(i for i, line in enumerate(lines) if line.strip() == signature)
        end = next(i for i in range(start, len(lines)) if lines[i].startswith("template <"))
        for k, (where, text, occurrence, name) in enumerate(marks):
            hits = [i for i in range(start, end) if lines[i].strip() == text]
            if len(hits) < occurrence:
                raise SystemExit(f"ssd_chunk.cu no longer has the statement of {name!r}: {text}")
            i = hits[occurrence - 1]
            if where == "before":
                while lines[i - 1].strip().startswith(("for (", "#pragma")):
                    i -= 1
            else:
                i += 1
            inserts.append((i, f"  PHASE_MARK({kernel}, {k});"))
        # the block's counters into the device's, at the kernel's end
        close = next(i for i in range(end - 1, start, -1) if lines[i] == "}")
        inserts.append((close, f"  if (tid == 0) for (int k = 0; k < {len(marks)}; ++k) "
                               f"atomicAdd(&g_phase_{kernel}[w][k], "
                               "(unsigned long long)phase_cycles[w][k]);"))
    for i, line in sorted(inserts, reverse=True):
        lines.insert(i, line)
    out = "\n".join(lines)
    decl = ""
    for kernel, (_, marks) in MARKS.items():
        K = len(marks)
        out = out.replace(HEAD[kernel], HEAD[kernel] +
                          f"  __shared__ long long phase_cycles[2][{K}];\n"
                          "  long long phase_t0 = clock64();\n"
                          f"  if (threadIdx.x < {2 * K}) (&phase_cycles[0][0])[threadIdx.x] = 0;\n",
                          1)
        decl += f"__device__ unsigned long long g_phase_{kernel}[2][{K}];\n"
    first = "template <int HP, int N>\nstruct FwdWg {"
    out = out.replace(first, decl + "#define PHASE_MARK(kernel, k) do { if (tid == 0) { const "
                      "long long now = clock64(); phase_cycles[w][k] += now - phase_t0; "
                      "phase_t0 = now; } } while (0)\n" + first, 1)
    for kernel, (_, marks) in MARKS.items():
        out += f'''
extern "C" int ssd_phase_cycles_{kernel}(unsigned long long* out) {{
  return (int)cudaMemcpyFromSymbol(out, ssd::g_phase_{kernel},
                                   sizeof(unsigned long long) * {2 * len(marks)});
}}
'''
    return out


def main() -> None:
    shutil.rmtree(OUT, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch", OUT / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = OUT / "src" / "repro_torch" / "kernels" / "csrc" / "ssd_chunk.cu"
    cu.write_text(instrument(cu.read_text()))
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(OUT / "build")
    sys.path.insert(0, str(OUT / "src"))
    import numpy as np
    import torch
    from repro_torch.kernels import build, ssd_chunk as sc

    lib = build.load_library("ssd_chunk")
    rng = np.random.default_rng(16)
    randn = lambda shape, dtype: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32)).cuda().to(dtype)
    Bt, nc, Q, H, hp, G, N = 4, 16, 256, 64, 64, 1, 128
    x = randn((Bt, nc, Q, H, hp), torch.bfloat16)
    dt = randn((Bt, nc, Q, H), torch.float32).abs() * 0.1
    b, c = randn((Bt, nc, Q, 2 * G, N), torch.bfloat16).split(G, dim=3)
    a = -randn((H,), torch.float32).abs() - 0.1
    cots = (randn(x.shape, torch.bfloat16), randn((Bt, nc, H, N, hp), torch.float32),
            randn((Bt, nc, Q, H), torch.float32))
    fwd = sc.ssd_fwd_geometry(Bt, nc, Q, H, G, hp, N)
    y_blocks = fwd["blocks"] // len(fwd["roles"]) * (len(fwd["roles"]) - 1)
    runs = {"fwd": (lambda: sc.ssd_chunk_cuda(x, dt, b, c, a),
                    {"start": fwd["blocks"], "states": fwd["blocks"] - y_blocks,
                     "y": y_blocks}),
            "bwd": (lambda: sc.ssd_chunk_bwd_cuda(x, dt, b, c, a, *cots),
                    {"": sc.ssd_bwd_geometry(Bt, nc, Q, H, G, hp, N)["blocks"]})}
    out = {"device": torch.cuda.get_device_name(0)}
    for kernel, (fn, blocks) in runs.items():
        marks = MARKS[kernel][1]
        K = len(marks)
        counts = (ctypes.c_ulonglong * (2 * K))()
        read = getattr(lib, f"ssd_phase_cycles_{kernel}")
        fn()
        torch.cuda.synchronize()
        read(counts)
        before = np.array(list(counts), dtype=np.float64)
        fn()
        torch.cuda.synchronize()
        if read(counts) != 0:
            raise SystemExit("reading the counters failed")
        cycles = (np.array(list(counts), dtype=np.float64) - before).reshape(2, K)
        for role, n in blocks.items():
            # a role's phases: those named after it (the forward's start, shared by
            # both roles, is the states blocks' and the y blocks' together)
            ks = [k for k, m in enumerate(marks) if m[3].startswith(role)]
            per = cycles[:, ks] / n
            total = per.sum(1)
            out[f"{kernel} {role}".strip()] = {
                "blocks": n, "cycles_a_block": total.round(0).tolist(),
                "phases": {marks[k][3]: {"cycles": per[:, j].round(0).tolist(),
                                         "share": (per[:, j] / total).round(4).tolist()}
                           for j, k in enumerate(ks)}}
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
