"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32e top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base; hf].  Copy of
``repro.configs.granite_moe_1b``."""
from repro_torch.configs.base import AttnConfig, ModelConfig, MoEConfig, reduce_for_smoke

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    d_ff=512,
    vocab=49155,
    attn=AttnConfig(n_heads=16, kv_heads=8, head_dim=64),
    moe=MoEConfig(n_experts=32, top_k=8, d_ff_expert=512),
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
)
SMOKE_CONFIG = reduce_for_smoke(CONFIG)
