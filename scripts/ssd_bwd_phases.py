#!/usr/bin/env python
"""Where the bf16 SSD backward's main kernel spends its time, without ncu:

    python3 scripts/ssd_bwd_phases.py

Copies ``src/repro_torch`` into ``build/ssd_bwd_phases/`` and marks the
phases of ``ssd_chunk_bwd_wg_kernel`` there (thread 0 of each warpgroup adds
the ``clock64`` cycles since the previous mark into a shared counter, and the
block's counters into a device array at its end), builds the copy, runs one
call at mamba2-1.3b's shape (B 4, nc 16, Q 256, 64 heads of 64, G 1, N 128,
bf16) after a warm-up, and prints each phase's cycles a block for each
warpgroup and its share.  The marks cost some cycles of their own; the
repository's kernel is not changed.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "build" / "ssd_bwd_phases"
#: (where, the statement, its occurrence, the phase that ends there): a mark
#: goes after the statement, or before it (and before its loop header)
MARKS = [
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
]


def instrument(src: str) -> str:
    lines = src.split("\n")
    inserts = []
    for k, (where, text, occurrence, name) in enumerate(MARKS):
        hits = [i for i, line in enumerate(lines) if line.strip() == text]
        if len(hits) < occurrence:
            raise SystemExit(f"ssd_chunk.cu no longer has the statement of {name!r}: {text}")
        i = hits[occurrence - 1]
        if where == "before":
            while lines[i - 1].strip().startswith(("for (", "#pragma")):
                i -= 1
        else:
            i += 1
        inserts.append((i, f"  PHASE_MARK({k});"))
    for i, line in sorted(inserts, reverse=True):
        lines.insert(i, line)
    out, K = "\n".join(lines), len(MARKS)
    head = "  using W = Wg<HP, N>;\n"
    out = out.replace(head, head + f"  __shared__ long long phase_cycles[2][{K}];\n"
                      "  long long phase_t0 = clock64();\n"
                      f"  if (threadIdx.x < {2 * K}) (&phase_cycles[0][0])[threadIdx.x] = 0;\n", 1)
    last = f"  PHASE_MARK({K - 1});"
    out = out.replace(last, last + f"\n  if (tid == 0) for (int k = 0; k < {K}; ++k) "
                      "atomicAdd(&g_phase_cycles[w][k], "
                      "(unsigned long long)phase_cycles[w][k]);", 1)
    kernel = "template <int HP, int N>\nstruct Wg {"
    out = out.replace(kernel, f"__device__ unsigned long long g_phase_cycles[2][{K}];\n"
                      "#define PHASE_MARK(k) do { if (tid == 0) { const long long now = "
                      "clock64(); phase_cycles[w][k] += now - phase_t0; phase_t0 = now; } "
                      "} while (0)\n" + kernel, 1)
    return out + f'''
extern "C" int ssd_phase_cycles(unsigned long long* out) {{
  return (int)cudaMemcpyFromSymbol(out, ssd::g_phase_cycles, sizeof(unsigned long long) * {2 * K});
}}
'''


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
    K = len(MARKS)
    counts = (ctypes.c_ulonglong * (2 * K))()
    blocks = sc.ssd_bwd_geometry(Bt, nc, Q, H, G, hp, N)["blocks"]
    sc.ssd_chunk_bwd_cuda(x, dt, b, c, a, *cots)
    torch.cuda.synchronize()
    lib.ssd_phase_cycles(counts)
    before = np.array(list(counts), dtype=np.float64)
    sc.ssd_chunk_bwd_cuda(x, dt, b, c, a, *cots)
    torch.cuda.synchronize()
    if lib.ssd_phase_cycles(counts) != 0:
        raise SystemExit("reading the counters failed")
    cycles = (np.array(list(counts), dtype=np.float64) - before).reshape(2, K) / blocks
    total = cycles.sum(1)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "blocks": blocks,
                      "cycles_a_block": total.round(0).tolist(),
                      "phases": {name: {"cycles": cycles[:, k].round(0).tolist(),
                                        "share": (cycles[:, k] / total).round(4).tolist()}
                                 for k, (_, _, _, name) in enumerate(MARKS)}}, indent=1))


if __name__ == "__main__":
    main()
