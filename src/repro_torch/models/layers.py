"""Core layers: parameter specs, RMSNorm, RoPE, MLP variants.

Parameters are plain nested dicts of tensors.  Every leaf is declared via
``PSpec`` (shape + logical axes + dtype + init), the same declaration the JAX
package uses, so both packages build trees with identical keys and shapes.
The logical axes resolve through ``distributed.sharding`` to DTensor
placements under a mesh (``axes_tree``); without a mesh nothing reads them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate

from .. import resolve_device, torch_dtype
from ..core import spans
from ..core.remat_policy import checkpoint_name
from ..distributed.sharding import (P, ax, axis_sizes, block_index, current_mesh, local_map,
                                    placements, prune_pspec, shard, take_in_block)
from ..kernels import ops


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


def abstract(spec_tree):
    """``meta`` tensors of each spec's shape and dtype (no allocation): the
    dry-run's parameters and the trainer's shape templates."""
    return map_specs(lambda s: torch.empty(s.shape, dtype=torch_dtype(s.dtype),
                                           device="meta"), spec_tree)


def axes_tree(spec_tree):
    return map_specs(lambda s: ax(*s.axes), spec_tree)


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


def norm(x, scale, cfg):
    """The model's RMSNorm: the hand-written kernel (``kernels.ops.rmsnorm``:
    fp32 product, one cast) with ``cfg.use_flash``, else ``rmsnorm`` (the
    reference model's rounding order).  The kernel normalises whole rows, so
    on DTensors the normalised dim (and ``scale``) is gathered first where it
    is sharded or partial (the mamba mixer's gated norm over 'ffn').  The
    span ``norm`` (``core/spans.py``)."""
    with spans.span("norm", x) as sp:
        if cfg.use_flash:
            if isinstance(x, DTensor):
                x, scale = _whole_rows(x, scale)
            y = ops.rmsnorm(x, scale, cfg.norm_eps)
        else:
            y = rmsnorm(x, scale, cfg.norm_eps)
        spans.grads(sp, y)
    return y


def _whole_rows(x, scale):
    nd = x.dim()
    want = tuple(Replicate() if (pl.is_partial() or pl.is_shard(nd - 1)) else pl
                 for pl in x.placements)
    if want != tuple(x.placements):
        x = x.redistribute(x.device_mesh, want)
    rep = (Replicate(),) * x.device_mesh.ndim
    if tuple(scale.placements) != rep:
        scale = scale.redistribute(x.device_mesh, rep)
    return x, scale


def rmsnorm_spec(d: int) -> dict:
    return {"scale": PSpec((d,), (None,), "float32", "zeros")}


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


_FREQS: dict = {}


def _device_freqs(hd: int, theta: float, device) -> torch.Tensor:
    """``rope_freqs`` in fp32 on ``device``, copied there once per (hd, theta,
    device): a copy from pageable host memory synchronises the stream, and
    RoPE runs twice a layer in every forward, recompute and decode step."""
    key = (hd, float(theta), torch.device(device))
    if key not in _FREQS:
        with torch.inference_mode(False):   # usable outside inference mode too
            _FREQS[key] = torch.from_numpy(rope_freqs(hd, theta).astype(np.float32)).to(device)
    return _FREQS[key]


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (..., S, H, hd); positions: (..., S) int32.  Split-half rotation
    with fp32 angles."""
    freqs = _device_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs            # (..., S, hd/2)
    angles = angles[..., None, :]                            # (..., S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def embed_lookup(table, tokens, enabled: bool = True):
    """Embedding lookup; vocab-sharded under a mesh with ``enabled``.

    A plain ``table[tokens]`` with the table sharded ('vocab'→model,
    'embed'→data) would gather the whole table first.  Here each model shard
    gathers from its local vocab slice through ``local_map``, with
    out-of-range rows clipped, then masked to zero, and the partial rows are
    summed over 'model': the body's output is declared ``Partial`` over
    'model', and the all-reduce is the ``Partial → Replicate`` redistribute
    that the next ``shard`` issues (an all-reduce inside the body would also
    sum the gradient over 'model' in the backward: funcol's all_reduce
    differentiates to another all_reduce).  Taken under the reference's
    conditions (``enabled``, a mesh with 'model', ``V % model == 0``), else a
    plain gather (of the whole table, on a mesh)."""
    mesh = current_mesh()
    V = table.shape[0]
    if mesh is None or not isinstance(table, DTensor):
        return table[tokens]
    names = mesh.mesh_dim_names
    data_axes = tuple(a for a in ("pod", "data") if a in names)
    tok_spec = prune_pspec(tuple(tokens.shape), P(data_axes or None, None), mesh)
    tok_pl = placements(tok_spec, mesh)
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim, run_check=False)
    if (not enabled or "model" not in names or V % axis_sizes(mesh)["model"] != 0):
        # the plain gather, as XLA partitions the reference's: the whole
        # table on every rank (DTensor's own index over a sharded table fails
        # in torch 2.11)
        whole = tuple(Replicate() for _ in names)
        return local_map(lambda tbl, tok: tbl[tok], (tok_pl,), (whole, tok_pl), mesh)(
            table, tokens)
    # the table enters model-sharded on vocab with the embed dim gathered
    tbl_pl = placements(P("model", None), mesh)
    out_pl = tuple(Partial() if n == "model" else p for n, p in zip(names, tok_pl, strict=True))

    def body(tbl, tok):
        v_loc = tbl.shape[0]
        off = block_index(mesh, tbl_pl, 0) * v_loc
        return take_in_block(tok, off, v_loc, lambda i: tbl[i])

    return local_map(body, (out_pl,), (tbl_pl, tok_pl), mesh)(table, tokens)


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
    h = shard(x @ p["wi"], "batch", "seq", "ffn")
    if cfg.mlp == "swiglu":
        h = F.silu(x @ p["wg"]) * h
    elif cfg.mlp == "geglu":
        h = F.gelu(x @ p["wg"], approximate="tanh") * h
    elif cfg.mlp == "gelu":
        h = F.gelu(h, approximate="tanh")
    elif cfg.mlp == "squared_relu":
        h = torch.square(F.relu(h))
    h = checkpoint_name(h, "mlp_hidden")
    return shard(h @ p["wo"], "batch", "seq", "embed_act")
