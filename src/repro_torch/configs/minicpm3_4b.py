"""minicpm3-4b [dense]: 62L d_model=2560 40H d_ff=6400 vocab=73448 — MLA
(multi-head latent attention, compressed KV).  [hf:openbmb/MiniCPM3-4B]"""
from .base import MLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b", family="dense",
    n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40, head_dim=96,
    d_ff=6400, vocab=73448, mlp="swiglu", pattern=("mla",),
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256, qk_nope_dim=64,
                  qk_rope_dim=32, v_head_dim=64),
    attn_chunked=True, remat="dots",
    notes="MLA: cache is the 288-dim latent (c_kv + k_rope), not full KV",
)
