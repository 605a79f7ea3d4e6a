"""internlm2-1.8b [dense]: 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92544 — GQA [arXiv:2403.17297; hf].  Copy of
``repro.configs.internlm2_1_8b``."""
from repro_torch.configs.base import AttnConfig, ModelConfig, reduce_for_smoke

CONFIG = ModelConfig(
    name="internlm2-1.8b",
    family="dense",
    n_layers=24,
    d_model=2048,
    d_ff=8192,
    vocab=92544,
    attn=AttnConfig(n_heads=16, kv_heads=8, head_dim=128),
    tie_embeddings=False,
    source="arXiv:2403.17297; hf",
)
SMOKE_CONFIG = reduce_for_smoke(CONFIG)
