"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, MoE 16 experts top-2 — Mamba+attention 1:7
interleave.  [arXiv:2403.19887]"""
from .base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab=65536, mlp="swiglu",
    pattern=("mamba", "mamba", "mamba", "mamba", "attn",
             "mamba", "mamba", "mamba"),
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=24576, every=2),
    ssm=SSMConfig(d_state=128, headdim=64, expand=2, conv_width=4,
                  n_groups=1, chunk=256),
    state_dtype="bfloat16",    # 398B total params: bf16 Adam states to fit HBM
    attn_chunked=True, remat="dots",
    notes="period-8 block (attn at position 4), MoE every 2nd layer; "
          "long_500k runs (9 attn layers only)",
)
