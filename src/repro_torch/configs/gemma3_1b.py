"""gemma3-1b [dense]: 26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144
— 5:1 local:global attention, 128k ctx.  [hf:google/gemma-3-1b-pt]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b", family="dense",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, head_dim=256,
    d_ff=6912, vocab=262144, mlp="geglu",
    pattern=("local", "local", "local", "local", "local", "attn"),
    window=512, rope_theta=1000000.0, tie_embeddings=True,
    attn_chunked=True, remat="dots",
    notes="5 sliding-window (512) layers per 1 global layer; tied embeddings",
)
