"""olmoe-1b-7b [moe]: 16L d_model=2048 16H (kv=16) d_ff=1024 vocab=50304,
MoE 64 experts top-8.  [arXiv:2409.02060]"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1024, vocab=50304, mlp="swiglu", pattern=("attn",),
    moe=MoEConfig(n_experts=64, top_k=8, d_ff_expert=1024, every=1),
    attn_chunked=True, remat="dots",
)
