"""Deterministic synthetic data pipeline.

``make_batch`` builds concrete tensors from a counter-based hash: batch(step)
is a pure function of (seed, step), so a restart resumes the stream exactly
and any host can materialise any shard without coordination.  numpy does the
hashing, exactly as in the reference, so the batches of the two packages are
bit-identical; only the last step (placing the arrays on a device) differs.

For the modality-stub archs the "frontend" is a hash-embedding producing
frame/patch embeddings.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..configs.base import ModelConfig, ShapeConfig
from ..distributed.sharding import ax


def _philox_u32(ctr: np.ndarray, key: int) -> np.ndarray:
    """Cheap counter-based hash (xorshift-mult), deterministic across hosts."""
    salt = np.uint64((key * 0x9E3779B97F4A7C15) % (1 << 64))
    with np.errstate(over="ignore"):
        x = ctr.astype(np.uint64) + salt
        x ^= x >> np.uint64(33)
        x *= np.uint64(0xFF51AFD7ED558CCD)
        x ^= x >> np.uint64(33)
        x *= np.uint64(0xC4CEB9FE1A85EC53)
        x ^= x >> np.uint64(33)
    return (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def make_tokens(cfg: ModelConfig, batch: int, seq: int, step: int,
                seed: int = 0) -> np.ndarray:
    ctr = (np.arange(batch * seq, dtype=np.uint64) +
           np.uint64(step) * np.uint64(batch * seq))
    toks = _philox_u32(ctr, seed + 1) % np.uint32(cfg.vocab)
    return toks.reshape(batch, seq).astype(np.int32)


def make_embeddings(cfg: ModelConfig, batch: int, seq: int, step: int,
                    seed: int = 0) -> np.ndarray:
    """Stub modality frontend: hashed frame/patch embeddings."""
    toks = make_tokens(cfg, batch, seq, step, seed + 7)
    sub = (toks % 997).astype(np.float32) / 997.0 - 0.5
    emb = np.repeat(sub[..., None], 8, axis=-1)                  # (B,S,8)
    proj = np.linspace(-1, 1, 8 * cfg.d_model, dtype=np.float32)
    proj = proj.reshape(8, cfg.d_model) / np.sqrt(8)
    return (emb @ proj).astype(np.float32)


def make_batch(cfg: ModelConfig, shape: ShapeConfig, step: int,
               seed: int = 0, batch_override: int | None = None,
               seq_override: int | None = None, device="cuda") -> dict:
    """{"inputs", "labels"} as tensors on ``device``.  Copy objective: the
    label at position t is the input token at t; the token stream is i.i.d.,
    so the identity mapping is the learnable signal."""
    dev = resolve_device(device)
    B = batch_override or shape.global_batch
    S = seq_override or shape.seq_len
    toks = torch.from_numpy(make_tokens(cfg, B, S, step, seed))
    if cfg.input_mode == "tokens":
        inputs = toks
    else:
        inputs = torch.from_numpy(make_embeddings(cfg, B, S, step, seed)
                                  ).to(torch.bfloat16)
    return {"inputs": inputs.to(dev), "labels": toks.to(dev)}


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """``meta`` stand-ins for the dry-run (no allocation)."""
    B, S = shape.global_batch, shape.seq_len
    S_in = 1 if shape.kind == "decode" else S
    if cfg.input_mode == "tokens":
        inputs = torch.empty((B, S_in), dtype=torch.int32, device="meta")
    else:
        inputs = torch.empty((B, S_in, cfg.d_model), dtype=torch.bfloat16, device="meta")
    out = {"inputs": inputs}
    if shape.kind == "train":
        out["labels"] = torch.empty((B, S), dtype=torch.int32, device="meta")
    return out


def input_axes(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    if cfg.input_mode == "tokens":
        in_ax = ax("batch", "seq")
    else:
        in_ax = ax("batch", "seq", "embed_act")
    out = {"inputs": in_ax}
    if shape.kind == "train":
        out["labels"] = ax("batch", "seq")
    return out


class SyntheticDataset:
    """Stateless-by-step iterator; ``state`` is just the step counter."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, seed: int = 0,
                 start_step: int = 0, batch_override: int | None = None,
                 seq_override: int | None = None, device="cuda"):
        self.cfg, self.shape, self.seed = cfg, shape, seed
        self.step = start_step
        self._b, self._s = batch_override, seq_override
        self.device = resolve_device(device)

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        b = make_batch(self.cfg, self.shape, self.step, self.seed,
                       self._b, self._s, device=self.device)
        self.step += 1
        return b

    def state(self) -> dict:
        return {"step": self.step, "seed": self.seed}

    @classmethod
    def from_state(cls, cfg, shape, state: dict, **kw) -> "SyntheticDataset":
        return cls(cfg, shape, seed=state["seed"], start_step=state["step"],
                   **kw)
