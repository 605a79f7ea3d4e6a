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
``decode_state_specs`` are the JAX tables of logical axes; encdec does
not run on a mesh yet (``transformer.MESH_FAMILIES``), so the JAX
module's ``constrain`` hints have no counterpart yet.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (Initializer, chunked_cross_entropy,
                                       dtype_of, init_mlp, remat, rms_norm,
                                       swiglu)
from repro_torch.models.transformer import (_mlp_specs, _slice,
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


def _enc_layer(x, lp, positions, cfg: ModelConfig):
    t = x.shape[1]
    a = cfg.attn
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = attn._project_qkv(h, h, lp["attn"], a, positions, positions,
                                use_rope=False)
    h = attn.flash_attention(
        q, k, v, positions, positions, causal=False, window=None,
        cap=a.attn_softcap, chunk_q=min(cfg.attn_chunk_q, t),
        chunk_k=min(cfg.attn_chunk_k, t))
    x = x + h.reshape(x.shape[0], t, -1) @ lp["attn"]["wo"]
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + swiglu(h, lp["mlp"], cfg.act)


def encode(params, frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """frames [B, T, D] (stub frontend output) -> encoder states."""
    t = frames.shape[1]
    x = frames.to(dtype_of(cfg.compute_dtype)) + params["enc_pos"][:t]
    positions = torch.arange(t, dtype=torch.int32, device=x.device)
    layer = remat(_enc_layer, cfg.remat)
    for i in range(cfg.n_enc_layers):
        x = layer(x, _slice(params["enc_layers"], i), positions, cfg)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _dec_layer(x, lp, enc_out, positions, cfg: ModelConfig):
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    x = x + attn.self_attention(h, lp["attn"], cfg.attn, positions,
                                chunk_q=cfg.attn_chunk_q,
                                chunk_k=cfg.attn_chunk_k)
    h = rms_norm(x, lp["ln_cross"], cfg.norm_eps)
    x = x + attn.cross_attention(h, enc_out, lp["cross"], cfg.attn,
                                 chunk_q=cfg.attn_chunk_q,
                                 chunk_k=cfg.attn_chunk_k)
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + swiglu(h, lp["mlp"], cfg.act)


def _decode_forward(params, tokens, enc_out, cfg: ModelConfig):
    x = params["embed"][tokens]
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=x.device)
    layer = remat(_dec_layer, cfg.remat)
    for i in range(cfg.n_layers):
        x = layer(x, _slice(params["dec_layers"], i), enc_out, positions,
                  cfg)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def train_loss(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    """Encode ``batch["frames"]``, decode ``tokens``; mean nll over
    ``targets`` (tied embeddings, logits scaled by d_model^-0.5) ->
    (nll, {"nll", "aux": 0})."""
    enc_out = encode(params, _frames(batch, cfg), cfg)
    x = _decode_forward(params, batch["tokens"].long(), enc_out, cfg)
    nll = chunked_cross_entropy(
        x, params["embed"], batch["targets"], cfg.loss_chunk,
        logit_softcap=cfg.logit_softcap, mask=batch.get("mask"),
        logit_scale=cfg.d_model ** -0.5)
    return nll, {"nll": nll, "aux": torch.zeros((), dtype=_F32,
                                                device=nll.device)}


def _logits(params, x, cfg: ModelConfig):
    return (x * cfg.d_model ** -0.5) @ params["embed"].T


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      device) -> Dict[str, torch.Tensor]:
    a = cfg.attn
    dtype = dtype_of(cfg.compute_dtype)

    def kv(s):
        return torch.zeros((cfg.n_layers, batch, s, a.kv_heads, a.head_dim),
                           dtype=dtype, device=device)

    return {"cache_len": torch.zeros((batch,), dtype=torch.int32,
                                     device=device),
            "k_cache": kv(max_len), "v_cache": kv(max_len),
            "cross_k": kv(cfg.enc_seq), "cross_v": kv(cfg.enc_seq)}


def prefill(params, tokens: torch.Tensor, cfg: ModelConfig, max_len: int,
            extra: Optional[Dict[str, torch.Tensor]] = None):
    """Returns (state, logits [B, V] in the compute dtype)."""
    b = tokens.shape[0]
    enc_out = encode(params, _frames(extra, cfg), cfg)
    state = init_decode_state(cfg, b, max_len, tokens.device)
    a = cfg.attn
    for i in range(cfg.n_layers):
        cross = _slice(params["dec_layers"], i)["cross"]
        for name, w in (("cross_k", "wk"), ("cross_v", "wv")):
            kv = (enc_out @ cross[w]).reshape(b, -1, a.kv_heads, a.head_dim)
            state[name][i] = kv.to(state[name].dtype)
    x = _decode_forward(params, tokens, enc_out, cfg)
    state["cache_len"] = torch.full((b,), tokens.shape[1], dtype=torch.int32,
                                    device=tokens.device)
    return state, _logits(params, x[:, -1], cfg)


def decode_step(params, state, tokens: torch.Tensor, cfg: ModelConfig,
                extra: Optional[Dict[str, torch.Tensor]] = None):
    """tokens [B, 1] -> (logits f32[B, V], new_state); writes the
    self-attention caches of ``state`` in place.  ``extra`` is not read
    (the cross K/V is in the state)."""
    x = params["embed"][tokens]
    new_len = state["cache_len"] + 1
    enc_len = torch.full_like(new_len, state["cross_k"].shape[2])
    a = cfg.attn
    for i in range(cfg.n_layers):
        lp = _slice(params["dec_layers"], i)
        kc, vc = state["k_cache"][i], state["v_cache"][i]
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        k_new, v_new = attn.project_new_kv(h, lp["attn"], a, new_len - 1)
        attn.write_new_kv(kc, vc, k_new, v_new, new_len - 1)
        x = x + attn.decode_attention(h, lp["attn"], a, kc, vc, new_len)
        h = rms_norm(x, lp["ln_cross"], cfg.norm_eps)
        x = x + attn.decode_attention(h, lp["cross"], a, state["cross_k"][i],
                                      state["cross_v"][i], enc_len,
                                      use_rope=False)
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + swiglu(h, lp["mlp"], cfg.act)
    new_state = dict(state)
    new_state["cache_len"] = new_len
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, x[:, 0], cfg).to(_F32), new_state
