"""mamba2-1.3b [ssm]: 48L d_model=2048 attention-free, vocab=50280,
ssm_state=128 — SSD (state-space duality).  [arXiv:2405.21060]"""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=1, n_kv_heads=1, head_dim=64,
    d_ff=0, vocab=50280, mlp="none", pattern=("mamba",),
    ssm=SSMConfig(d_state=128, headdim=64, expand=2, conv_width=4,
                  n_groups=1, chunk=256),
    remat="dots",
    notes="attention-free; long_500k runs (sub-quadratic); FlashAttention "
          "kernel inapplicable — SSD chunked path is the fused hot loop",
)
