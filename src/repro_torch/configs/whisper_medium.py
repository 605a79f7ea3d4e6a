"""whisper-medium [audio]: 24L d_model=1024 16H (kv=16) d_ff=4096 vocab=51865
— enc-dec, conv frontend (stub) [arXiv:2212.04356; unverified].

The modality frontend is a STUB: precomputed frame embeddings
[B, 1500, d_model] (the JAX package's input_specs(); the port takes them as
``extra["frames"]``).  Copy of ``repro.configs.whisper_medium``."""
from repro_torch.configs.base import AttnConfig, ModelConfig, reduce_for_smoke

CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    n_layers=24,
    n_enc_layers=24,
    enc_seq=1500,
    d_model=1024,
    d_ff=4096,
    vocab=51865,
    attn=AttnConfig(n_heads=16, kv_heads=16, head_dim=64),
    act="gelu",
    tie_embeddings=True,
    source="arXiv:2212.04356; unverified",
)
SMOKE_CONFIG = reduce_for_smoke(CONFIG)
