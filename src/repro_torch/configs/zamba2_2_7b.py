"""zamba2-2.7b [hybrid]: 54L d_model=2560 32H (GQA kv=32) d_ff=10240
vocab=32000, ssm_state=64 — Mamba2 + shared attn blocks [arXiv:2411.15242;
hf].  Copy of
``repro.configs.zamba2_2_7b``."""
from repro_torch.configs.base import AttnConfig, ModelConfig, SSMConfig, reduce_for_smoke

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    d_ff=10240,
    vocab=32000,
    attn=AttnConfig(n_heads=32, kv_heads=32, head_dim=80),
    ssm=SSMConfig(state_dim=64, version=2, expand=2, conv_width=4,
                  head_dim=64, chunk=128),
    hybrid_attn_every=6,
    tie_embeddings=True,
    source="arXiv:2411.15242; hf",
)
SMOKE_CONFIG = reduce_for_smoke(CONFIG)
