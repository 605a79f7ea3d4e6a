"""gemma2-9b [dense]: 42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000
— local+global alternating, logit softcap [arXiv:2408.00118; hf].  Copy of
``repro.configs.gemma2_9b``."""
from repro_torch.configs.base import AttnConfig, ModelConfig, reduce_for_smoke

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    d_ff=14336,
    vocab=256000,
    attn=AttnConfig(n_heads=16, kv_heads=8, head_dim=256,
                    attn_softcap=50.0, window=4096, pattern="local_global"),
    logit_softcap=30.0,
    tie_embeddings=True,
    source="arXiv:2408.00118; hf",
)
SMOKE_CONFIG = reduce_for_smoke(CONFIG)
