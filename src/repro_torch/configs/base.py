"""Model / shape configuration system (the port's own copy).

A copy of ``repro.configs.base``, which holds only dataclasses: the port
imports nothing of the JAX package.  One frozen dataclass tree per
architecture; each has a module
``repro_torch.configs.<arch_id>`` exporting ``CONFIG`` plus a reduced
``SMOKE_CONFIG`` for CPU tests.  ``SSMConfig.batch_tp`` is a sharding
layout of the JAX package and has no effect on one card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = [
    "AttnConfig", "MoEConfig", "SSMConfig", "ModelConfig", "ShapeConfig",
    "SHAPES", "reduce_for_smoke",
]


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    n_heads: int
    kv_heads: int
    head_dim: int
    rope_theta: float = 10_000.0
    qk_norm: bool = False
    # gemma2-style attention logit soft-capping
    attn_softcap: Optional[float] = None
    # sliding-window size for local layers; pattern picks which layers
    window: Optional[int] = None
    # one of: "global", "local_global" (alternating, gemma2)
    pattern: str = "global"


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    # snowflake-arctic: dense FFN residual branch in parallel with MoE
    dense_residual_d_ff: Optional[int] = None
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    aux_loss: float = 1e-2
    # token-chunked dispatch: route/dispatch/combine at most this many
    # tokens at once — bounds the dispatch-buffer working set
    # for 1M-token prefill steps the way microbatching bounds training
    token_chunk: int = 131_072


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int
    version: int = 1          # 1 = mamba1 selective scan, 2 = mamba2 SSD
    expand: int = 2           # d_inner = expand * d_model
    conv_width: int = 4
    head_dim: int = 64        # mamba2 heads: d_inner / head_dim
    chunk: int = 128          # chunked-scan block (memory/parallelism knob)
    dt_rank: Optional[int] = None  # mamba1 dt low-rank (default d_model/16)
    # batch-TP (§Perf hillclimb 2): run SSM blocks data-parallel over the
    # full mesh (batch across model axis too, d_inner replicated) instead
    # of TP on d_inner — removes two sequence collectives per layer
    batch_tp: bool = False
    # fused selective-scan kernel (kernels/csrc/mamba_scan.cu on the card,
    # its plain PyTorch version on CPU tensors) in place of the chunked
    # path.  mamba1 only.  Off by default, as in the JAX package.
    use_scan_kernel: bool = False


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str               # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    d_ff: int
    vocab: int
    attn: Optional[AttnConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): one *shared* attention block applied every k layers
    hybrid_attn_every: int = 6
    # encdec (whisper)
    n_enc_layers: int = 0
    enc_seq: int = 1500           # precomputed audio frames (stub frontend)
    # vlm (llama-3.2-vision): cross-attn every k layers; patch embeds (stub)
    cross_attn_every: int = 0
    n_patches: int = 1601
    # output
    logit_softcap: Optional[float] = None
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    act: str = "swiglu"
    # the JAX package's lax.scan over layers; the port always loops over
    # layers in Python, so this has no effect here
    scan_layers: bool = True
    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    loss_chunk: int = 256         # sequence-chunked xent (never materialize
                                  # the full [B, L, V] logits)
    attn_chunk_q: int = 512       # flash-attention chunk sizes
    attn_chunk_k: int = 1024
    remat: str = "full"           # full | dots | none (training only:
                                  # serving runs without it)
    # citation tier from the assignment
    source: str = ""

    @property
    def d_head_total(self) -> int:
        return self.attn.n_heads * self.attn.head_dim if self.attn else 0

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + layers)."""
        d, v = self.d_model, self.vocab
        total = v * d
        if not self.tie_embeddings:
            total += v * d
        per_layer = 0
        if self.family in ("dense", "moe", "vlm", "encdec"):
            a = self.attn
            per_layer += d * a.n_heads * a.head_dim * 2  # q, o
            per_layer += d * a.kv_heads * a.head_dim * 2  # k, v
        if self.family in ("dense", "vlm", "encdec"):
            per_layer += 3 * d * self.d_ff
        if self.family == "moe":
            m = self.moe
            per_layer += m.n_experts * 3 * d * m.d_ff_expert
            if m.dense_residual_d_ff:
                per_layer += 3 * d * m.dense_residual_d_ff
            per_layer += d * m.n_experts  # router
        if self.family in ("ssm", "hybrid"):
            s = self.ssm
            di = s.expand * d
            if s.version == 1:
                dtr = s.dt_rank or max(d // 16, 1)
                per_layer_ssm = (
                    d * di * 2 + s.conv_width * di
                    + di * (dtr + 2 * s.state_dim) + dtr * di + di * d
                )
            else:
                nh = di // s.head_dim
                per_layer_ssm = (
                    d * (2 * di + 2 * s.state_dim * 1 + nh) + s.conv_width * di + di * d
                )
            per_layer += per_layer_ssm
        n_main = self.n_layers
        total += per_layer * n_main
        if self.family == "hybrid" and self.attn is not None:
            a = self.attn
            shared = d * a.n_heads * a.head_dim * 2 + d * a.kv_heads * a.head_dim * 2
            shared += 3 * d * self.d_ff
            total += shared  # one shared block
        if self.family == "encdec":
            # encoder layers + decoder cross-attn
            a = self.attn
            enc = self.n_enc_layers * (
                d * a.n_heads * a.head_dim * 2 + d * a.kv_heads * a.head_dim * 2
                + 3 * d * self.d_ff
            )
            cross = self.n_layers * (
                d * a.n_heads * a.head_dim * 2 + d * a.kv_heads * a.head_dim * 2
            )
            total += enc + cross
        if self.family == "vlm" and self.cross_attn_every:
            a = self.attn
            n_cross = self.n_layers // self.cross_attn_every
            total += n_cross * (
                d * a.n_heads * a.head_dim * 2 + d * a.kv_heads * a.head_dim * 2
            )
        return int(total)

    def active_param_count(self) -> int:
        """MoE: parameters touched per token (for 6*N_active*D flops)."""
        if self.family != "moe":
            return self.param_count()
        m = self.moe
        d = self.d_model
        per_layer = self.d_model * self.attn.n_heads * self.attn.head_dim * 2
        per_layer += d * self.attn.kv_heads * self.attn.head_dim * 2
        per_layer += m.top_k * 3 * d * m.d_ff_expert
        if m.dense_residual_d_ff:
            per_layer += 3 * d * m.dense_residual_d_ff
        per_layer += d * m.n_experts
        return int(self.vocab * d + per_layer * self.n_layers)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def applicable_shapes(cfg: ModelConfig) -> Tuple[str, ...]:
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.family in SUBQUADRATIC_FAMILIES:
        names.append("long_500k")
    return tuple(names)


def reduce_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """Shrink a config to CPU-smoke scale, preserving the family shape."""
    changes = dict(
        n_layers=min(cfg.n_layers, 2),
        d_model=128,
        d_ff=256,
        vocab=512,
        n_enc_layers=min(cfg.n_enc_layers, 2),
        enc_seq=16 if cfg.n_enc_layers else cfg.enc_seq,
        n_patches=16 if cfg.family == "vlm" else cfg.n_patches,
        hybrid_attn_every=2 if cfg.family == "hybrid" else cfg.hybrid_attn_every,
        cross_attn_every=2 if cfg.cross_attn_every else 0,
        loss_chunk=64,
        param_dtype="float32",
        compute_dtype="float32",
        remat="none",
    )
    if cfg.attn:
        changes["attn"] = dataclasses.replace(
            cfg.attn, n_heads=4, kv_heads=2, head_dim=32,
            window=16 if cfg.attn.window else None,
        )
    if cfg.moe:
        changes["moe"] = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=min(cfg.moe.top_k, 2), d_ff_expert=64,
            dense_residual_d_ff=64 if cfg.moe.dense_residual_d_ff else None,
        )
    if cfg.ssm:
        changes["ssm"] = dataclasses.replace(
            cfg.ssm, state_dim=min(cfg.ssm.state_dim, 16), head_dim=32, chunk=16,
        )
    return dataclasses.replace(cfg, **changes)
