"""One AdamW step over a list of parameter leaves: the ctypes wrapper of
``csrc/fused_adam.cu`` and its plain PyTorch version.

Both update every ``p``, ``m`` and ``v`` **in place**: all math in fp32, each
store in its buffer's dtype, weight decay on the old ``p``.  ``count`` is the
post-increment step as an int32 tensor on the leaves' device; the kernel
reads it on the device, so a step never waits for the host.  ``lr`` and the
other hyper-parameters are plain floats passed at every call (trap T6 in
ROADMAP.md: nothing is baked into the kernel).

The kernel takes many leaves a launch: leaves are grouped by their (p, g,
m/v) dtypes, and each group is cut into runs of at most ``MAX_LEAVES``, one
launch each (``launch_groups``).
"""

from __future__ import annotations

import ctypes

import torch

from .build import launch
from .ref import fused_adam_ref

_DTYPES = (torch.float32, torch.bfloat16)
_ARGTYPES = ([ctypes.POINTER(ctypes.c_longlong)] * 2 + [ctypes.c_int, ctypes.c_void_p]
             + [ctypes.c_float] * 7 + [ctypes.c_int] * 3)
#: leaves one launch takes: ``MAX_LEAVES`` of ``csrc/fused_adam.cu``, whose
#: leaf table is a kernel parameter
MAX_LEAVES = 64


@torch.no_grad()
def fused_adam_plain(p, g, m, v, count, lr, b1=0.9, b2=0.95, eps=1e-8,
                     weight_decay=0.0):
    """The kernel's arithmetic in PyTorch on one leaf, written back in place."""
    p2, m2, v2 = fused_adam_ref(p, g, m, v, lr=lr, b1=b1, b2=b2, eps=eps,
                                weight_decay=weight_decay, count=count)
    p.copy_(p2)
    m.copy_(m2)
    v.copy_(v2)


def fused_adam_multi_plain(ps, gs, ms, vs, count, lr, b1=0.9, b2=0.95, eps=1e-8,
                           weight_decay=0.0):
    """``fused_adam_plain`` on every leaf in turn."""
    for p, g, m, v in zip(ps, gs, ms, vs, strict=True):
        fused_adam_plain(p, g, m, v, count, lr, b1, b2, eps, weight_decay)


def launch_groups(ps, gs, ms) -> list[list[int]]:
    """The leaves each launch takes, by index: grouped by (p, g, m/v) dtype
    in the order each combination first appears, each group cut into runs of
    at most ``MAX_LEAVES``; leaves without elements take none."""
    groups: dict[tuple, list[int]] = {}
    for i, (p, g, m) in enumerate(zip(ps, gs, ms, strict=True)):
        if p.numel():
            groups.setdefault((p.dtype, g.dtype, m.dtype), []).append(i)
    return [idx[k:k + MAX_LEAVES] for idx in groups.values()
            for k in range(0, len(idx), MAX_LEAVES)]


def _check_leaf(i, p, g, m, v) -> None:
    for name, t in (("p", p), ("g", g), ("m", m), ("v", v)):
        if t.dtype not in _DTYPES:
            raise TypeError(f"fused_adam kernel: {name} of leaf {i} has dtype {t.dtype} "
                            "(float32 or bfloat16)")
        if t.shape != p.shape:
            raise ValueError(f"fused_adam kernel: {name} of leaf {i} must have p's shape "
                             f"{tuple(p.shape)}; got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"fused_adam kernel: {name} of leaf {i} must be contiguous")
        if t.numel() and t.data_ptr() % 16:
            raise ValueError(f"fused_adam kernel: {name} of leaf {i} must start on a 16-byte "
                             "boundary")
    if m.dtype != v.dtype:
        raise TypeError(f"fused_adam kernel: m and v of leaf {i} must share a dtype; got "
                        f"{m.dtype}, {v.dtype}")


def fused_adam_multi_cuda(ps, gs, ms, vs, count, lr, b1=0.9, b2=0.95, eps=1e-8,
                          weight_decay=0.0):
    """Launch the kernel on lists of leaves, one launch per group of
    ``launch_groups``.  Every ``p``, ``m``, ``v`` is updated in place and must
    be contiguous; a ``g`` may have any layout (it is read through a
    contiguous copy if it is not contiguous).  Every leaf is checked before
    the first launch."""
    gs = [g.contiguous() for g in gs]
    leaves = list(zip(ps, gs, ms, vs, strict=True))
    if not leaves:
        return
    ps, gs, ms, vs = (list(t) for t in zip(*leaves, strict=True))
    for i, leaf in enumerate(leaves):
        _check_leaf(i, *leaf)
    device = ps[0].device
    for i, leaf in enumerate(leaves):
        if any(t.device != device or t.device.type != "cuda" for t in leaf):
            raise ValueError(f"fused_adam kernel: leaf {i} lies on "
                             f"{[str(t.device) for t in leaf]}; every leaf must lie on one "
                             f"CUDA device ({device})")
    if count.dtype != torch.int32 or count.numel() != 1 or count.device != device:
        raise ValueError("fused_adam kernel: count must be one int32 on the leaves' device")
    bf = torch.bfloat16
    for idx in launch_groups(ps, gs, ms):
        ptrs = (ctypes.c_longlong * (4 * len(idx)))(
            *[t.data_ptr() for i in idx for t in (ps[i], gs[i], ms[i], vs[i])])
        sizes = (ctypes.c_longlong * len(idx))(*[ps[i].numel() for i in idx])
        p, g, m = ps[idx[0]], gs[idx[0]], ms[idx[0]]
        launch("fused_adam", _ARGTYPES, device, ptrs, sizes, len(idx), count.data_ptr(),
               float(lr), b1, b2, 1.0 - b1, 1.0 - b2, eps, weight_decay, int(p.dtype == bf),
               int(g.dtype == bf), int(m.dtype == bf))

