"""Build the CUDA sources under ``csrc/`` into shared libraries, at first use.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into ``build/lib<name>_<hash>.so`` (the hash covers the
sources and the flags, so an edited source is rebuilt) and loaded with
``ctypes``.  All sources are compiled in parallel, one ``nvcc`` each.  A
failed build raises with the compiler's output; nothing falls back.

The build directory is ``build/`` at the repository root, or
``$REPRO_TORCH_BUILD_DIR``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("flash_fwd", "flash_dq", "flash_dkv", "rmsnorm", "fused_adam", "ssd_chunk")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: launches per kernel, counted by each wrapper where it launches its kernel
#: and nowhere else
LAUNCHES = dict.fromkeys(SOURCES, 0)

_LIBS: dict[str, ctypes.CDLL] = {}
#: filled by the build: seconds, and ptxas' per-kernel resource lines
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
    todo = [n for n in SOURCES if not paths[n].exists()]
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
                os.replace(tmp, paths[name])
        if failed:
            raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n" +
                               "\n".join(logs[n] for n in failed))
        BUILD_INFO["ptxas"] = {n: _ptxas_summary(logs[n]) for n in todo}
    BUILD_INFO["seconds"] = time.time() - t0
    BUILD_INFO["built"] = todo
    BUILD_INFO["paths"] = paths
    return paths


def _ptxas_summary(log: str) -> list[dict]:
    """One entry per compiled kernel: registers, spill bytes, static shared
    memory, as ``-Xptxas -v`` printed them."""
    import re
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            out.append({"kernel": name})
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
    """Call ``csrc/<name>.cu``'s C entry point ``name`` with ``args`` and the
    current CUDA stream of ``device`` (appended as the last argument).  The
    entry point returns ``cudaGetLastError()`` of its launch; anything but 0
    raises.  A successful launch adds one to ``LAUNCHES[name]``."""
    import torch
    fn = getattr(load_library(name), name)
    fn.argtypes = [*argtypes, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    LAUNCHES[name] += 1
