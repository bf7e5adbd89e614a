"""One AdamW step over one parameter leaf: the ctypes wrapper of
``csrc/fused_adam.cu`` and its plain PyTorch version.

Both update ``p``, ``m`` and ``v`` **in place**: all math in fp32, each
store in its buffer's dtype, weight decay on the old ``p``.  ``count`` is the
post-increment step as an int32 tensor on the leaf's device; the kernel reads
it on the device, so a step never waits for the host.  ``lr`` and the other
hyper-parameters are plain floats passed at every call (trap T6 in
ROADMAP.md: nothing is baked into the kernel).
"""

from __future__ import annotations

import ctypes

import torch

from .build import launch
from .ref import fused_adam_ref

_DTYPES = (torch.float32, torch.bfloat16)
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_float] * 7
             + [ctypes.c_int] * 3)


@torch.no_grad()
def fused_adam_plain(p, g, m, v, count, lr, b1=0.9, b2=0.95, eps=1e-8,
                     weight_decay=0.0):
    """The kernel's arithmetic in PyTorch, written back in place."""
    p2, m2, v2 = fused_adam_ref(p, g, m, v, lr=lr, b1=b1, b2=b2, eps=eps,
                                weight_decay=weight_decay, count=count)
    p.copy_(p2)
    m.copy_(m2)
    v.copy_(v2)


def fused_adam_cuda(p, g, m, v, count, lr, b1=0.9, b2=0.95, eps=1e-8,
                    weight_decay=0.0):
    """Launch the kernel on one leaf.  ``p``, ``m``, ``v`` are updated in
    place and must be contiguous; ``g`` may be any layout (it is read
    through a contiguous copy if it is not contiguous)."""
    g = g.contiguous()
    for name, t in (("p", p), ("g", g), ("m", m), ("v", v)):
        if t.dtype not in _DTYPES:
            raise TypeError(f"fused_adam kernel: {name} has dtype {t.dtype} (float32 or bfloat16)")
        if t.shape != p.shape or t.device != p.device or t.device.type != "cuda":
            raise ValueError(f"fused_adam kernel: {name} must have p's shape {tuple(p.shape)} "
                             f"on one CUDA device; got {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"fused_adam kernel: {name} must be contiguous")
    if m.dtype != v.dtype:
        raise TypeError(f"fused_adam kernel: m and v must share a dtype; got {m.dtype}, {v.dtype}")
    if (count.dtype != torch.int32 or count.numel() != 1 or count.device != p.device):
        raise ValueError("fused_adam kernel: count must be one int32 on p's device")
    bf = torch.bfloat16
    launch("fused_adam", _ARGTYPES, p.device, p.data_ptr(), g.data_ptr(), m.data_ptr(),
           v.data_ptr(), count.data_ptr(), p.numel(), float(lr), b1, b2, 1.0 - b1,
           1.0 - b2, eps, weight_decay, int(p.dtype == bf), int(g.dtype == bf),
           int(m.dtype == bf))
