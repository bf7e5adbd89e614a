"""musicgen-medium [audio]: 48L d_model=1536 24H (kv=24) d_ff=6144
vocab=2048 — decoder-only over EnCodec tokens.  The EnCodec frontend is a
STUB: input_specs() supplies precomputed frame embeddings.
[arXiv:2306.05284]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, head_dim=64,
    d_ff=6144, vocab=2048, mlp="gelu", pattern=("attn",),
    input_mode="embeddings",
    attn_chunked=True, remat="dots",
    notes="EnCodec codebook head (vocab=2048); frame embeddings stubbed",
)
