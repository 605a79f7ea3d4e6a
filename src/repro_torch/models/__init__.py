"""LM scaffolding of the port: every family of the JAX package (dense,
moe, ssm, hybrid, vlm, encdec) behind ``model.build_model``."""
