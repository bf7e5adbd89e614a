"""repro_torch — the PyTorch / CUDA port of the MONET runtime.

Same sub-package names as the JAX package (``configs models kernels training
optim data ckpt launch``) so a reader finds each counterpart.  The package
imports ``torch``, ``numpy`` and the standard library only; it never imports
``jax`` or anything of the JAX package.

Parameters are nested dicts of tensors with the JAX package's keys and the
stacked leading scan dimension, so reference weights and checkpoints drop in
(see ``repro_torch.convert``).
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point allocates on.  The default is the GPU and
    there is no silent fallback: asking for CUDA without a CUDA device raises;
    the CPU is used only when the caller names it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev


DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "int32": torch.int32,
}


def torch_dtype(name) -> torch.dtype:
    """'bfloat16' → torch.bfloat16 (configs carry dtype names as strings)."""
    return name if isinstance(name, torch.dtype) else DTYPES[str(name)]
