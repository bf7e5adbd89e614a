"""Build the CUDA sources under ``csrc/`` into shared libraries, at first use.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into ``build/lib<name>_<hash>.so`` (the hash covers the
sources and the flags, so an edited source is rebuilt) and loaded with
``ctypes``.  All sources are compiled in parallel, one ``nvcc`` each.  A
failed build raises with the compiler's output; nothing falls back.  Beside
each library, ``lib<name>_<hash>.ptxas.json`` keeps what ``ptxas`` reported
for its kernels (registers, spill bytes), so a cached build still reports it.

The build directory is ``build/`` at the repository root, or
``$REPRO_TORCH_BUILD_DIR``.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch.autograd.profiler as _profiler

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("flash_fwd", "flash_dq", "flash_dkv", "rmsnorm", "fused_adam", "ssd_chunk",
           "causal_conv")
#: ``--split-compile 0`` runs the front end's optimisation on all host cores:
#: ssd_chunk.cu's 48 kernels build in ≈ 26 s instead of ≈ 40 s on the H100's
#: host (PERF.md)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "--split-compile", "0")

#: the counted C entry points, each named by its symbol, and the source whose
#: library holds it: one per source, and the rmsnorm, SSD chunk and causal
#: conv backwards beside their forwards
ENTRY_POINTS = {**{name: name for name in SOURCES}, "rmsnorm_bwd": "rmsnorm",
                "ssd_chunk_bwd": "ssd_chunk", "causal_conv_bwd": "causal_conv"}
#: launches per entry point, counted by each wrapper where it launches its
#: kernel and nowhere else
LAUNCHES = dict.fromkeys(ENTRY_POINTS, 0)
#: devices whose tensors take a kernel's plain version: the CPU, and ``meta``
#: (shapes and dtypes only: it holds no values, so nothing is computed and no
#: fallback can hide; the dry-run's FLOP counters see the plain version's
#: operators)
PLAIN_DEVICES = ("cpu", "meta")
#: the recorder of an active trace (``repro_torch.core.trace``), or ``None``:
#: while it is set, ``kernel_call`` hands each wrapper's call to it
TRACE_HOOK = None

_LIBS: dict[str, ctypes.CDLL] = {}
#: filled by the build: seconds, and ptxas' per-kernel resource lines
#: of every library, built now or cached
BUILD_INFO: dict = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    return Path(env) if env else Path(__file__).resolve().parents[3] / "build"


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           f"{cuda_home}/bin): the CUDA kernels cannot be built")
    return nvcc


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:12]


def build_all() -> dict[str, Path]:
    """Compile every source that has no up-to-date library; returns paths."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = _digest()
    paths = {name: out_dir / f"lib{name}_{tag}.so" for name in SOURCES}
    reports = {name: p.with_suffix(".ptxas.json") for name, p in paths.items()}
    todo = [n for n in SOURCES if not (paths[n].exists() and reports[n].exists())]
    t0 = time.time()
    if todo:
        nvcc = find_nvcc()
        procs = {}
        for name in todo:
            tmp = paths[name].with_suffix(f".tmp{os.getpid()}.so")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs[name] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs, failed = {}, []
        for name, (tmp, proc) in procs.items():
            logs[name] = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(name)
            else:
                reports[name].write_text(json.dumps(_ptxas_summary(logs[name])))
                os.replace(tmp, paths[name])
        if failed:
            raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n" +
                               "\n".join(logs[n] for n in failed))
    BUILD_INFO["ptxas"] = {n: json.loads(reports[n].read_text()) for n in SOURCES}
    BUILD_INFO["seconds"] = time.time() - t0
    BUILD_INFO["built"] = todo
    BUILD_INFO["paths"] = paths
    return paths


def _ptxas_summary(log: str) -> list[dict]:
    """One entry per compiled kernel: registers, spill bytes, static shared
    memory, as ``-Xptxas -v`` printed them, and under ``wgmma_notes`` what
    ptxas said of its ``wgmma`` products (a product it serialized, a wait it
    injected: C75xx), matched by the kernel's name in the line, else given to
    the kernel being compiled."""
    import re
    out, name, notes = [], None, []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            out.append({"kernel": name})
            continue
        if re.search(r"\(C75\d\d\)|wgmma|warpgroup", line):
            notes.append((len(out) - 1, line.strip()))
            continue
        if not out:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[-1]["spill_stores"] = int(m.group(1))
            out[-1]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[-1]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out[-1]["static_smem"] = int(sm.group(1)) if sm else 0
    for at, note in notes:
        named = [k for k in out if k["kernel"] in note] or (out[at:at + 1] if at >= 0 else [])
        for k in named:
            k.setdefault("wgmma_notes", []).append(note)
    return out


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (building everything on the
    first call of the process)."""
    if name not in _LIBS:
        paths = build_all()
        for n, p in paths.items():
            _LIBS[n] = ctypes.CDLL(str(p))
    return _LIBS[name]


def launch(name: str, argtypes: list, device, *args) -> None:
    """Call the C entry point ``name`` (of the library of
    ``csrc/<ENTRY_POINTS[name]>.cu``) with ``args`` and the current CUDA
    stream of ``device`` (appended as the last argument).  The entry point
    returns ``cudaGetLastError()`` of its launch; anything but 0 raises.  A
    successful launch adds one to ``LAUNCHES[name]``."""
    import torch
    fn = getattr(load_library(ENTRY_POINTS[name]), name)
    fn.argtypes = [*argtypes, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    LAUNCHES[name] += 1


def kernel_call(name: str, plain, run, *args, written: tuple[int, ...] = ()):
    """``run(*args)``, where ``run`` is the kernel of entry point ``name`` or,
    for tensors on a ``PLAIN_DEVICES`` device, its plain version ``plain``:
    the one place where each wrapper has chosen between the two.  While a
    trace is active (``TRACE_HOOK``) the call goes through the tracer, which
    records it as one node; ``written`` holds the positions of the arguments
    that the call updates in place.  While a ``torch.profiler`` session
    records, ``run`` is the span ``kernel.<name>`` (``core/spans.py``), inside
    the tracer's node."""
    if _profiler._is_profiler_enabled:
        from ..core import spans
        run = spans.kernel(name, run)
    if TRACE_HOOK is None:
        return run(*args)
    return TRACE_HOOK(name, plain, run, args, written)
