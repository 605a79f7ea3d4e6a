"""qwen3-14b [dense]: 40L d_model=5120 40H (GQA kv=8) d_ff=17408
vocab=151936 — qk_norm, GQA [hf:Qwen/Qwen3-8B; hf].  Copy of
``repro.configs.qwen3_14b``.  Only its attention shape is used by the
port so far (the flash-decode kernel's check); its dense model is ROADMAP
A15b."""
from repro_torch.configs.base import AttnConfig, ModelConfig, reduce_for_smoke

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    d_ff=17408,
    vocab=151936,
    attn=AttnConfig(n_heads=40, kv_heads=8, head_dim=128, qk_norm=True,
                    rope_theta=1_000_000.0),
    tie_embeddings=False,
    source="hf:Qwen/Qwen3-8B; hf",
)
SMOKE_CONFIG = reduce_for_smoke(CONFIG)
