"""arctic-480b [moe]: 35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128e top-2 + dense residual [hf:Snowflake/snowflake-arctic-base; hf].  Copy of
``repro.configs.arctic_480b``."""
from repro_torch.configs.base import AttnConfig, ModelConfig, MoEConfig, reduce_for_smoke

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    d_ff=4864,
    vocab=32000,
    attn=AttnConfig(n_heads=56, kv_heads=8, head_dim=128),
    moe=MoEConfig(n_experts=128, top_k=2, d_ff_expert=4864,
                  dense_residual_d_ff=4864),
    remat="full",
    source="hf:Snowflake/snowflake-arctic-base; hf",
)
SMOKE_CONFIG = reduce_for_smoke(CONFIG)
