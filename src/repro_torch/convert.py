"""Move parameter / optimizer-state trees between the two packages.

A tree is a nested dict whose leaves are numpy arrays on the reference's side
and torch tensors on the port's side.  Conversion keeps every dtype; bfloat16
goes through a 16-bit integer view because torch cannot read numpy's
(ml_dtypes) bfloat16 directly.  The caller turns jax arrays into numpy first
(``jax.tree.map(np.asarray, tree)``); nothing here imports jax.
"""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device


def tree_map(fn, tree, *rest):
    """Map ``fn`` over the leaves of nested dicts (keys in sorted order)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves of nested dicts in sorted-key order (the reference's order)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(tree_leaves(tree[k]))
        return out
    return [tree]


def tree_flatten_with_path(tree, prefix: str = "") -> dict:
    """{'a/b/c': leaf} — the key scheme of the checkpoint store."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(tree_flatten_with_path(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def numpy_to_tensor(a, device="cpu") -> torch.Tensor:
    a = np.asarray(a).copy()            # C-ordered, owned, keeps 0-dim
    if str(a.dtype) == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """bfloat16 comes back as numpy's bfloat16 (``ml_dtypes``, the numpy
    extension type the reference's arrays use; imported only when needed)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        bits = t.view(torch.int16).numpy().view(np.uint16)
        return bits.view(ml_dtypes.bfloat16)
    return t.numpy()


def from_reference(tree, device="cuda"):
    """Nested dict of numpy arrays → nested dict of torch tensors."""
    dev = resolve_device(device)
    return tree_map(lambda a: numpy_to_tensor(a, dev), tree)


def to_reference(tree):
    """Nested dict of torch tensors → nested dict of numpy arrays."""
    return tree_map(tensor_to_numpy, tree)
