"""Encoder-decoder backbone (whisper-medium): init, encode, prefill, decode.

Port of ``repro.models.encdec``.  The audio conv frontend is a stub, as
in the reference: the model takes precomputed frame embeddings
``extra["frames"]`` [B, enc_seq, d_model].  Encoder: bidirectional
self-attention layers over the frames plus learned positions.  Decoder:
causal self-attention, cross-attention to the encoder output, MLP (GELU,
tanh approximation).  Tied embeddings, logits scaled by d_model^-0.5.

``prefill`` encodes the frames, fills every decoder layer's
``cross_k``/``cross_v`` [L, B, enc_seq, KH, Dh] (no ``k_norm``, no RoPE,
as there) and runs the decoder over the prompt.  ``decode_step`` runs
two decode attentions a layer, both on the kernel route (no softcap, no
window): its self-attention over the cache, which it writes in place as
``transformer.decode_step`` does, and its cross-attention over the
``enc_seq`` encoder positions.  ``train_loss`` takes ``batch["frames"]``;
under autograd each encoder and decoder layer is one ``layers.remat``
block of ``cfg.remat``, as the JAX ``_remat`` wraps the scan body.
Copied from the reference: ``prefill``
leaves the self-attention K/V caches zero, so decoding attends over zero
K/V at the prompt's positions.  ``param_specs`` and
``decode_state_specs`` are the JAX tables of logical axes.

**On a mesh** (a ``transformer.MeshPlan`` passed as ``plan``:
``plan.enc`` an encoder layer's shardings, ``plan.layer`` a decoder
layer's), every entry point runs on the rank's local shards as the
decoder-only families do: the rows (``frames`` and ``tokens``) over the
batch axes; every ``fsdp`` weight gathered for its use; each attention
on the rank's heads where ``kv_heads`` divides by ``model``
(``attention.local_attention``), the encoder's bidirectional one and the
decoder's cross-attention through ``attention.tp_cross_attention`` (the
encoder output entering the rank's ``wk``/``wv`` columns); the GELU MLP
over ``mlp`` (``layers.tp_swiglu``); the learned ``enc_pos`` replicated;
the tied ``embed`` over ``vocab`` where the vocabulary divides by
``model`` (whisper-medium's 51,865 does not divide 16: then every rank
holds and computes the whole of it), its logits scaled by
``d_model^-0.5`` (``transformer.logits_of``, the loss through
``transformer.mean_nll``: the rank's part of the global mean).  The
decode state is the rank's shard (``transformer.state_sharding``: the
self and cross caches over the kv heads where they split); ``prefill``
fills the cross caches with the rank's kv heads and ``decode_step``
reads them, two ``flash_decode`` launches a layer on the rank's heads.
The JAX ``constrain`` sites keep their names.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import constrain
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (Initializer, dtype_of, init_mlp,
                                       remat, rms_norm)
from repro_torch.models.transformer import (MeshPlan, _mlp_specs, _slice,
                                            _stack_init, _stack_specs)

__all__ = ["init_params", "param_specs", "encode", "train_loss",
           "init_decode_state", "decode_state_specs", "decode_step",
           "prefill"]

_F32 = torch.float32


def _init_enc_layer(init: Initializer, cfg: ModelConfig):
    return {"ln1": init.zeros((cfg.d_model,)),
            "attn": attn.init_attention(init, cfg.d_model, cfg.attn),
            "ln2": init.zeros((cfg.d_model,)),
            "mlp": init_mlp(init, cfg.d_model, cfg.d_ff, cfg.act)}


def _init_dec_layer(init: Initializer, cfg: ModelConfig):
    return {"ln1": init.zeros((cfg.d_model,)),
            "attn": attn.init_attention(init, cfg.d_model, cfg.attn),
            "ln_cross": init.zeros((cfg.d_model,)),
            "cross": attn.init_attention(init, cfg.d_model, cfg.attn),
            "ln2": init.zeros((cfg.d_model,)),
            "mlp": init_mlp(init, cfg.d_model, cfg.d_ff, cfg.act)}


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device: Optional[torch.device] = None) -> Dict[str, Any]:
    init = Initializer(generator, dtype_of(cfg.param_dtype), device)
    return {
        "embed": init.normal((cfg.vocab, cfg.d_model), 1.0),
        "enc_pos": init.normal((cfg.enc_seq, cfg.d_model), 0.02),
        "enc_layers": _stack_init(_init_enc_layer, init, cfg.n_enc_layers,
                                  cfg),
        "enc_norm": init.zeros((cfg.d_model,)),
        "dec_layers": _stack_init(_init_dec_layer, init, cfg.n_layers, cfg),
        "final_norm": init.zeros((cfg.d_model,)),
    }


def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """Logical axes of every parameter leaf (JAX ``param_specs``)."""
    enc = {"ln1": (None,), "attn": attn.attention_specs(cfg.attn),
           "ln2": (None,), "mlp": _mlp_specs(cfg, cfg.act)}
    dec = {"ln1": (None,), "attn": attn.attention_specs(cfg.attn),
           "ln_cross": (None,), "cross": attn.attention_specs(cfg.attn),
           "ln2": (None,), "mlp": _mlp_specs(cfg, cfg.act)}
    return {"embed": ("vocab", "fsdp"), "enc_pos": (None, None),
            "enc_layers": _stack_specs(enc), "enc_norm": (None,),
            "dec_layers": _stack_specs(dec), "final_norm": (None,)}


def decode_state_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """Logical axes of the decode state (JAX ``decode_state_specs``)."""
    return {"cache_len": ("batch",),
            "k_cache": (None, "batch", "kv_seq", "kv_heads", None),
            "v_cache": (None, "batch", "kv_seq", "kv_heads", None),
            "cross_k": (None, "batch", None, "kv_heads", None),
            "cross_v": (None, "batch", None, "kv_heads", None)}


def _frames(extra, cfg: ModelConfig) -> torch.Tensor:
    if extra is None or "frames" not in extra:
        raise ValueError(f"{cfg.name} (encdec) needs extra['frames'] "
                         f"[B, {cfg.enc_seq}, {cfg.d_model}]")
    return extra["frames"]


def _mlp(h, lp, cfg: ModelConfig, plan: Optional[MeshPlan], sh):
    return tfm._mlp(h, lp["mlp"], cfg, plan, tfm._sh(plan, sh, "mlp"))


def _enc_layer(x, lp, cfg: ModelConfig, plan: Optional[MeshPlan] = None):
    """An encoder layer: bidirectional self-attention (the cross
    attention of its input to itself: no mask, no RoPE), then the MLP."""
    sh = None if plan is None else plan.enc
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    w, a, split = tfm._attn_weights(lp, cfg, plan, sh, "attn")
    h = attn.tp_cross_attention(h, h, w, a, split, tfm._mesh(plan),
                                cfg.attn_chunk_q, cfg.attn_chunk_k)
    x = x + constrain(h, "batch", None, None)
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + _mlp(h, lp, cfg, plan, sh)


def encode(params, frames: torch.Tensor, cfg: ModelConfig,
           plan: Optional[MeshPlan] = None) -> torch.Tensor:
    """frames [B, T, D] (stub frontend output) -> encoder states."""
    t = frames.shape[1]
    x = frames.to(dtype_of(cfg.compute_dtype)) + params["enc_pos"][:t]
    x = constrain(x, "batch", None, None)
    layer = remat(_enc_layer, cfg.remat)
    for i in range(cfg.n_enc_layers):
        x = layer(x, _slice(params["enc_layers"], i), cfg, plan)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _dec_layer(x, lp, enc_out, positions, cfg: ModelConfig,
               plan: Optional[MeshPlan] = None):
    mesh = tfm._mesh(plan)
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    w, a, split = tfm._attn_weights(lp, cfg, plan, None, "attn")
    x = x + attn.tp_self_attention(h, w, a, split, mesh, positions, None,
                                   cfg.attn_chunk_q, cfg.attn_chunk_k)
    h = rms_norm(x, lp["ln_cross"], cfg.norm_eps)
    w, a, split = tfm._attn_weights(lp, cfg, plan, None, "cross")
    x = x + attn.tp_cross_attention(h, enc_out, w, a, split, mesh,
                                    cfg.attn_chunk_q, cfg.attn_chunk_k)
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + _mlp(h, lp, cfg, plan, None)


def _decode_forward(params, tokens, enc_out, cfg: ModelConfig,
                    plan: Optional[MeshPlan] = None):
    x = constrain(tfm._embed(params, tokens, plan), "batch", None, None)
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=x.device)
    layer = remat(_dec_layer, cfg.remat)
    for i in range(cfg.n_layers):
        x = layer(x, _slice(params["dec_layers"], i), enc_out, positions,
                  cfg, plan)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def train_loss(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
               plan: Optional[MeshPlan] = None):
    """Encode ``batch["frames"]``, decode ``tokens``; mean nll over
    ``targets`` (tied embeddings, logits scaled by d_model^-0.5) ->
    (nll, {"nll", "aux": 0}); on a mesh the rank's part of the global
    mean."""
    enc_out = encode(params, _frames(batch, cfg), cfg, plan)
    x = _decode_forward(params, batch["tokens"].long(), enc_out, cfg, plan)
    nll = tfm.mean_nll(params, x, batch, cfg, plan)
    return nll, {"nll": nll, "aux": torch.zeros((), dtype=_F32,
                                                device=nll.device)}


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      device, plan: Optional[MeshPlan] = None
                      ) -> Dict[str, torch.Tensor]:
    """All zero: ``cache_len`` i32[B]; ``k_cache``/``v_cache`` [L, B,
    max_len, KH, Dh] and ``cross_k``/``cross_v`` [L, B, enc_seq, KH, Dh]
    in the compute dtype.  On a mesh, the rank's shard of the state of
    ``batch`` rows over the mesh (``transformer.state_sharding``)."""
    return tfm.init_decode_state(cfg, batch, max_len, device, plan)


def prefill(params, tokens: torch.Tensor, cfg: ModelConfig, max_len: int,
            extra: Optional[Dict[str, torch.Tensor]] = None,
            plan: Optional[MeshPlan] = None):
    """Returns (state, logits [B, V] in the compute dtype).  On a mesh,
    ``tokens`` and the frames are the rank's rows and the state its
    shard."""
    b = tokens.shape[0]
    enc_out = encode(params, _frames(extra, cfg), cfg, plan)
    state = init_decode_state(cfg, b * (1 if plan is None else plan.dp),
                              max_len, tokens.device, plan)
    for i in range(cfg.n_layers):
        w, a, _split = tfm._attn_weights(_slice(params["dec_layers"], i),
                                         cfg, plan, None, "cross")
        attn.fill_cross_kv(state["cross_k"][i], state["cross_v"][i],
                           enc_out, w, a)
    x = _decode_forward(params, tokens, enc_out, cfg, plan)
    state["cache_len"] = torch.full((b,), tokens.shape[1], dtype=torch.int32,
                                    device=tokens.device)
    return state, tfm.logits_of(params, x[:, -1], cfg, plan)


def decode_step(params, state, tokens: torch.Tensor, cfg: ModelConfig,
                extra: Optional[Dict[str, torch.Tensor]] = None,
                plan: Optional[MeshPlan] = None):
    """tokens [B, 1] -> (logits f32[B, V], new_state); writes the
    self-attention caches of ``state`` in place.  ``extra`` is not read
    (the cross K/V is in the state).  On a mesh, the rank's rows over
    the whole vocabulary and its shard of the state."""
    mesh = tfm._mesh(plan)
    x = constrain(tfm._embed(params, tokens, plan), "batch", None, None)
    new_len = state["cache_len"] + 1
    enc_len = torch.full_like(new_len, state["cross_k"].shape[2])
    for i in range(cfg.n_layers):
        lp = _slice(params["dec_layers"], i)
        kc, vc = state["k_cache"][i], state["v_cache"][i]
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        w, a, split = tfm._attn_weights(lp, cfg, plan, None, "attn")
        k_new, v_new = attn.project_new_kv(h, w, a, new_len - 1)
        attn.write_new_kv(kc, vc, k_new, v_new, new_len - 1)
        x = x + attn.tp_decode_attention(h, w, a, split, mesh, kc, vc,
                                         new_len)
        h = rms_norm(x, lp["ln_cross"], cfg.norm_eps)
        w, a, split = tfm._attn_weights(lp, cfg, plan, None, "cross")
        x = x + attn.tp_decode_attention(h, w, a, split, mesh,
                                         state["cross_k"][i],
                                         state["cross_v"][i], enc_len,
                                         use_rope=False)
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + _mlp(h, lp, cfg, plan, None)
    new_state = dict(state)
    new_state["cache_len"] = new_len
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return tfm.logits_of(params, x[:, 0], cfg, plan).to(_F32), new_state
