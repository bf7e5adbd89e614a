"""Model / shape configuration dataclasses (the framework's config system).

Every assigned architecture is a ``ModelConfig``; input shapes are
``ShapeConfig``s.  ``layer_specs()`` expands the per-layer mixer/MoE pattern;
``scan_period()`` finds the smallest repeating block; parameters of that block
are stacked along a leading dimension and the model loops over it, so the
parameter tree has the same keys and shapes as the JAX package's.

This is the port's own copy of ``repro.configs.base``: same fields, same
defaults, no import of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import NamedTuple


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3 style)."""
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_dim: int = 64
    qk_rope_dim: int = 32
    v_head_dim: int = 64

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_dim + self.qk_rope_dim


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 64
    top_k: int = 8
    d_ff_expert: int = 1024
    every: int = 1            # MoE on layers where (idx % every == every-1)
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD mixer."""
    d_state: int = 128
    headdim: int = 64
    expand: int = 2
    conv_width: int = 4
    n_groups: int = 1
    chunk: int = 256


class LayerSpec(NamedTuple):
    mixer: str        # 'attn' | 'local' | 'mla' | 'mamba'
    moe: bool


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 → d_model // n_heads
    mlp: str = "swiglu"          # swiglu | geglu | gelu | squared_relu | none
    pattern: tuple = ("attn",)   # mixer cycle
    window: int = 1024           # sliding-window for 'local'
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    moe: MoEConfig | None = None
    input_mode: str = "tokens"   # tokens | embeddings (modality-stub archs)
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    state_dtype: str = "float32"     # optimizer states (bf16 for ≥100B archs)
    remat: str = "dots"              # "none" = keep all; else recompute the period
    use_flash: bool = False          # hand-written flash-attention kernels
    attn_chunked: bool = False       # online-softmax attention over key chunks
    attn_chunk: int = 1024
    loss_chunk: int = 0              # 0 = auto (chunk when vocab*seq is large)
    scan_unroll: int = 1             # >1: unroll scans (roofline flop counting)
    seq_sharded_acts: bool = False   # SP: shard residual stream over 'model'
                                     # between blocks (saved scan carry /16)
    sharded_embed: bool = False      # vocab-sharded masked-gather embedding
                                     # (read by the distribution slice only;
                                     # the single-device port gathers plainly)
    notes: str = ""

    # -- derived -------------------------------------------------------------

    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def d_inner(self) -> int:
        return (self.ssm.expand * self.d_model) if self.ssm else 0

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm.headdim if self.ssm else 0

    def layer_specs(self) -> list[LayerSpec]:
        out = []
        for i in range(self.n_layers):
            mixer = self.pattern[i % len(self.pattern)]
            moe = bool(self.moe) and (i % self.moe.every == self.moe.every - 1)
            out.append(LayerSpec(mixer, moe))
        return out

    def scan_period(self) -> int:
        """Smallest p with layer_specs repeating at period p."""
        specs = self.layer_specs()
        for p in range(1, len(specs) + 1):
            if all(specs[i] == specs[i % p] for i in range(len(specs))):
                return p
        return len(specs)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, dff, V = self.d_model, self.d_ff, self.vocab
        hd = self.head_dim_
        total = V * d  # embed
        if not self.tie_embeddings:
            total += V * d
        for spec in self.layer_specs():
            if spec.mixer in ("attn", "local"):
                total += d * (self.n_heads * hd) + d * (2 * self.n_kv_heads * hd)
                total += (self.n_heads * hd) * d
            elif spec.mixer == "mla":
                m = self.mla
                total += d * m.q_lora_rank + m.q_lora_rank * \
                    self.n_heads * m.qk_head_dim
                total += d * (m.kv_lora_rank + m.qk_rope_dim)
                total += m.kv_lora_rank * self.n_heads * \
                    (m.qk_nope_dim + m.v_head_dim)
                total += self.n_heads * m.v_head_dim * d
            elif spec.mixer == "mamba":
                s = self.ssm
                di = self.d_inner
                conv_ch = di + 2 * s.n_groups * s.d_state
                nh = di // s.headdim
                total += d * (2 * di + 2 * s.n_groups * s.d_state + nh)
                total += conv_ch * s.conv_width
                total += di * d + 2 * nh
            if spec.moe:
                e = self.moe
                n_mat = 3 if self.mlp in ("swiglu", "geglu") else 2
                total += e.n_experts * n_mat * d * e.d_ff_expert
                total += d * e.n_experts  # router
            elif self.mlp != "none":
                n_mat = 3 if self.mlp in ("swiglu", "geglu") else 2
                total += n_mat * d * dff
            total += 2 * d  # norms
        return total

    def active_param_count(self) -> int:
        """Per-token active parameters (MoE top-k instead of all experts)."""
        if not self.moe:
            return self.param_count()
        total = self.param_count()
        e = self.moe
        n_mat = 3 if self.mlp in ("swiglu", "geglu") else 2
        n_moe_layers = sum(1 for s in self.layer_specs() if s.moe)
        total -= n_moe_layers * (e.n_experts - e.top_k) * n_mat * \
            self.d_model * e.d_ff_expert
        return total


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str              # train | prefill | decode

    @property
    def tokens_per_step(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def reduced(cfg: ModelConfig, layers: int | None = None) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    period = cfg.scan_period()
    n_layers = layers or max(period, 2)
    if n_layers % period:
        n_layers = period * max(1, n_layers // period)
    heads = min(cfg.n_heads, 4)
    kv = min(cfg.n_kv_heads, heads)
    kv = max(1, heads // max(1, heads // kv))
    mla = MLAConfig(32, 16, 8, 8, 8) if cfg.mla else None
    ssm = replace(cfg.ssm, d_state=16, headdim=8) if cfg.ssm else None
    moe = replace(cfg.moe, n_experts=4, top_k=2, d_ff_expert=64) \
        if cfg.moe else None
    return replace(
        cfg, name=f"{cfg.name}-smoke", n_layers=n_layers, d_model=64,
        n_heads=heads, n_kv_heads=kv, head_dim=16, d_ff=128,
        vocab=256, window=32, mla=mla, ssm=ssm, moe=moe,
        state_dtype="float32", remat="none", attn_chunked=False,
        loss_chunk=0,
    )
