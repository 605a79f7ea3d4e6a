"""llama-3.2-vision-11b [vlm]: 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256 — cross-attn image layers [hf:meta-llama/Llama-3.2-11B-Vision;
unverified].

Vision frontend is a STUB: the JAX package's input_specs() gives patch
embeddings (the port takes them as ``extra["patches"]``).  Copy of
``repro.configs.llama32_vision_11b``."""
from repro_torch.configs.base import AttnConfig, ModelConfig, reduce_for_smoke

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    d_ff=14336,
    vocab=128256,
    attn=AttnConfig(n_heads=32, kv_heads=8, head_dim=128,
                    rope_theta=500_000.0),
    cross_attn_every=5,
    n_patches=1601,
    tie_embeddings=False,
    source="hf:meta-llama/Llama-3.2-11B-Vision; unverified",
)
SMOKE_CONFIG = reduce_for_smoke(CONFIG)
