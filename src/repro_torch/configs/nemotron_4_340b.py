"""nemotron-4-340b [dense]: 96L d_model=18432 96H (GQA kv=8) d_ff=73728
vocab=256000 — GQA, squared-ReLU MLP.  [arXiv:2402.16819]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b", family="dense",
    n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8, head_dim=192,
    d_ff=73728, vocab=256000, mlp="squared_relu", pattern=("attn",),
    rope_theta=10000.0,
    state_dtype="bfloat16",     # Gopher-style bf16 Adam states: 340B must fit 16GB/chip HBM
    attn_chunked=True, remat="dots",
    notes="squared-ReLU MLP (2 matrices), GQA 96:8",
)
