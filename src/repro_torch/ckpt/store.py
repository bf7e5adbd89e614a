"""Fault-tolerant checkpointing: atomic commit and an async writer.

Layout:  <dir>/step_{step:08d}/  {arrays.npz, manifest.json}
Commit protocol: write into ``<dir>/.tmp_<step>`` → fsync → atomic rename.
A crash mid-write never corrupts the latest checkpoint; ``latest_step``
only sees committed directories.

The layout, the key scheme (tree path joined by ``/``, stored with ``|``) and
the dtype names in the manifest are the JAX package's, and bfloat16 is stored
as its 16 raw bits, so a checkpoint written by either package loads in the
other.  Arrays are stored whole, by logical path.

Elastic restart: a DTensor leaf is saved unsharded (gathered on the main
thread, in the tree's order on every rank, and written by rank 0 only), and
``load_checkpoint`` reshards each leaf onto the template leaf's mesh and
placements; so a checkpoint written on one mesh restores onto any other, or
onto none, and its files are the same as an unsharded run's.
"""

from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from .. import resolve_device
from ..convert import tree_flatten_with_path, tree_map
from ..distributed.sharding import distribute, whole


def _writes() -> bool:
    """Whether this process writes checkpoints: rank 0, or the only one."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """(array as stored, dtype name): bfloat16 becomes its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = whole(leaf).detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.dtype).removeprefix("torch.")
    a = np.asarray(leaf)
    if str(a.dtype) == "bfloat16":
        return a.view(np.uint16), "bfloat16"
    return a, str(a.dtype)


def _to_tensor(a: np.ndarray, dtype_name: str | None, device) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def save_checkpoint(ckpt_dir: str, step: int, tree, extra: dict | None = None
                    ) -> str:
    """Commit ``tree`` as ``step``.  Every rank gathers its DTensor leaves;
    only rank 0 writes."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    store, dtypes = {}, {}
    for key, leaf in tree_flatten_with_path(tree).items():
        store[key.replace("/", "|")], dtypes[key] = _to_host(leaf)
    if not _writes():
        return final
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f".tmp_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **store)
    manifest = {"step": step, "time": time.time(), "dtypes": dtypes,
                "extra": extra or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def available_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and os.path.exists(
                os.path.join(ckpt_dir, d, "manifest.json")):
            out.append(int(d[5:]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> int | None:
    steps = available_steps(ckpt_dir)
    return steps[-1] if steps else None


def load_checkpoint(ckpt_dir: str, template, step: int | None = None,
                    device="cuda") -> tuple:
    """Returns (tree of tensors on ``device``, manifest).  ``template`` gives
    the tree structure and the shape each leaf must have; a DTensor leaf of
    it gives the mesh and placements its leaf is resharded onto (on its own
    device)."""
    dev = resolve_device(device)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    raw = np.load(os.path.join(path, "arrays.npz"))
    have = {k.replace("|", "/"): k for k in raw.files}
    keys = iter(tree_flatten_with_path(template))

    def load(leaf):
        key = next(keys)
        if key not in have:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = raw[have[key]]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                             f"{tuple(leaf.shape)}")
        if isinstance(leaf, DTensor):
            full = _to_tensor(arr, manifest["dtypes"].get(key), leaf.to_local().device)
            return distribute(full, leaf.device_mesh, leaf.placements)
        return _to_tensor(arr, manifest["dtypes"].get(key), dev)

    return tree_map(load, template), manifest


def prune_checkpoints(ckpt_dir: str, keep: int = 3) -> None:
    steps = available_steps(ckpt_dir)
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


class AsyncCheckpointer:
    """Background writer: ``save`` snapshots to host memory synchronously
    and commits to disk off-thread — training never blocks on I/O.  The
    snapshot is a copy, so the in-place optimizer cannot change it.  DTensor
    leaves are gathered by the snapshot, on the calling thread (a collective
    never runs on the writer's thread); only rank 0 queues the write."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.dir = ckpt_dir
        self.keep = keep
        self._q: queue.Queue = queue.Queue()
        self._err: Exception | None = None
        self._t = threading.Thread(target=self._worker, daemon=True)
        self._t.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, host_tree, extra = item
            try:
                save_checkpoint(self.dir, step, host_tree, extra)
                prune_checkpoints(self.dir, self.keep)
            except Exception as e:   # surfaced on next save/wait
                self._err = e
            finally:
                self._q.task_done()

    def save(self, step: int, tree, extra: dict | None = None) -> None:
        if self._err:
            raise self._err
        host_tree = tree_map(                               # snapshot now
            lambda t: whole(t).detach().to("cpu", copy=True), tree)
        if _writes():
            self._q.put((step, host_tree, extra))

    def wait(self) -> None:
        self._q.join()
        if self._err:
            raise self._err

    def close(self) -> None:
        self.wait()
        self._q.put(None)
        self._t.join(timeout=10)
