"""Core layers: parameter specs, RMSNorm, RoPE, MLP variants.

Parameters are plain nested dicts of tensors.  Every leaf is declared via
``PSpec`` (shape + logical axes + dtype + init), the same declaration the JAX
package uses, so both packages build trees with identical keys and shapes.
The logical axes are carried for the distribution slice; nothing reads them
on a single device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device, torch_dtype


@dataclass(frozen=True)
class PSpec:
    shape: tuple
    axes: tuple                 # logical axes, len == rank
    dtype: str = "bfloat16"
    init: str = "normal"        # normal | zeros | ones | small


def is_pspec(x) -> bool:
    return isinstance(x, PSpec)


def map_specs(fn, spec_tree):
    """Map over the PSpec leaves of a nested dict (keys in sorted order)."""
    if is_pspec(spec_tree):
        return fn(spec_tree)
    return {k: map_specs(fn, spec_tree[k]) for k in sorted(spec_tree)}


def materialize(spec_tree, generator: torch.Generator, device="cuda"):
    """Random-init a PSpec tree: zeros / ones / fan-in scaled normal /
    ``small`` (std 0.02).  Same distributions as the reference's init; the
    draws differ because the generators do."""
    dev = resolve_device(device)

    def make(spec: PSpec):
        dt = torch_dtype(spec.dtype)
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dt, device=dev)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dt, device=dev)
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        scale = 0.02 if spec.init == "small" else 1.0 / math.sqrt(fan_in)
        x = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return (x * scale).to(dt)

    return map_specs(make, spec_tree)


def stack_specs(spec_tree, n: int):
    """Add a leading scan-period dimension to every leaf."""
    return map_specs(
        lambda s: PSpec((n, *s.shape), (None, *s.axes), s.dtype, s.init),
        spec_tree)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def rmsnorm(x, scale, eps: float = 1e-6):
    """fp32 statistics; the normalised value is cast to the input dtype
    *then* multiplied by ``1 + scale`` in that dtype (the model's rounding
    order, which differs from the kernel oracle's fp32 product)."""
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * (1.0 + scale.to(dt))


def rmsnorm_spec(d: int) -> dict:
    return {"scale": PSpec((d,), (None,), "float32", "zeros")}


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (..., S, H, hd); positions: (..., S) int32.  Split-half rotation
    with fp32 angles."""
    hd = x.shape[-1]
    freqs = torch.from_numpy(rope_freqs(hd, theta).astype(np.float32)).to(x.device)
    angles = positions[..., None].float() * freqs            # (..., S, hd/2)
    angles = angles[..., None, :]                            # (..., S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def embed_lookup(table, tokens):
    """Plain gather.  The reference's vocab-sharded masked-gather branch
    belongs to the distribution slice."""
    return table[tokens]


# -- MLP variants ------------------------------------------------------------


def mlp_specs(cfg) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp in ("swiglu", "geglu"):
        return {"wi": PSpec((d, f), ("embed", "ffn")),
                "wg": PSpec((d, f), ("embed", "ffn")),
                "wo": PSpec((f, d), ("ffn", "embed"))}
    if cfg.mlp in ("gelu", "squared_relu"):
        return {"wi": PSpec((d, f), ("embed", "ffn")),
                "wo": PSpec((f, d), ("ffn", "embed"))}
    if cfg.mlp == "none":
        return {}
    raise ValueError(f"unknown mlp kind {cfg.mlp!r}")


def mlp_apply(p: dict, x, cfg):
    """x: (B, S, D) → (B, S, D).  GELU is the tanh approximation, the
    reference's default."""
    if cfg.mlp == "none":
        return torch.zeros_like(x)
    h = x @ p["wi"]
    if cfg.mlp == "swiglu":
        h = F.silu(x @ p["wg"]) * h
    elif cfg.mlp == "geglu":
        h = F.gelu(x @ p["wg"], approximate="tanh") * h
    elif cfg.mlp == "gelu":
        h = F.gelu(h, approximate="tanh")
    elif cfg.mlp == "squared_relu":
        h = torch.square(F.relu(h))
    return h @ p["wo"]
