"""internvl2-26b [vlm]: 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553 — InternViT + InternLM2 backbone.  The ViT frontend is a STUB:
input_specs() supplies precomputed patch embeddings.  [arXiv:2404.16821]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab=92553, mlp="swiglu", pattern=("attn",),
    input_mode="embeddings",
    attn_chunked=True, remat="dots",
    notes="LM backbone only; vision tower stubbed via precomputed embeddings",
)
