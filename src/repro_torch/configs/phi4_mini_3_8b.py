"""phi4-mini-3.8b [dense]: 32L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=200064 — RoPE SwiGLU GQA [arXiv:2412.08905; hf].  Copy of
``repro.configs.phi4_mini_3_8b``."""
from repro_torch.configs.base import AttnConfig, ModelConfig, reduce_for_smoke

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    d_ff=8192,
    vocab=200064,
    attn=AttnConfig(n_heads=24, kv_heads=8, head_dim=128),
    tie_embeddings=True,
    source="arXiv:2412.08905; hf",
)
SMOKE_CONFIG = reduce_for_smoke(CONFIG)
