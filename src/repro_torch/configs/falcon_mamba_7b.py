"""falcon-mamba-7b [ssm]: 64L d_model=4096 attn-free vocab=65024 ssm_state=16
— mamba1 arch [arXiv:2410.05355; unverified].  Copy of
``repro.configs.falcon_mamba_7b``."""
from repro_torch.configs.base import ModelConfig, SSMConfig, reduce_for_smoke

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    d_ff=0,
    vocab=65024,
    ssm=SSMConfig(state_dim=16, version=1, expand=2, conv_width=4, chunk=128),
    tie_embeddings=False,
    source="arXiv:2410.05355; unverified",
)
SMOKE_CONFIG = reduce_for_smoke(CONFIG)
