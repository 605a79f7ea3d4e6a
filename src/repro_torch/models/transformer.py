"""Decoder-only assembly of the ssm family: init, forward, prefill, decode.

Port of ``repro.models.transformer`` for ``family == "ssm"``
(falcon-mamba-7b); the dense, moe, hybrid and vlm families port with
ROADMAP A15b and raise here.  Parameters keep the JAX tree: per-layer
leaves stacked on a leading ``[n_layers, ...]`` axis, as ``_stack_init``
gives.  The JAX ``lax.scan`` over layers is a Python loop over that
axis; ``scan_layers``, ``remat`` and the sharding hints have no effect,
and the JAX ``extra`` argument (VLM inputs) is dropped: no ported family
reads it.

The prefill copies a behaviour of the reference rather than fixing it:
``prefill`` runs ``forward`` on a fresh decode state and returns that
state with ``cache_len`` set but ``ssm_h`` and ``ssm_conv`` still zero
(the reference's scan drops the final state on both branches), so
decoding after a prefill starts from a zero recurrent state.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import Initializer, dtype_of, rms_norm

__all__ = ["init_params", "forward", "init_decode_state", "decode_step",
           "prefill"]


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "ssm":
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported to "
            "repro_torch yet (ROADMAP A15b); only 'ssm' is")


def _init_ssm_layer(init: Initializer, cfg: ModelConfig):
    return {"ln": init.zeros((cfg.d_model,)),
            "ssm": ssm_mod.init_mamba(init, cfg.d_model, cfg.ssm)}


def _stack_init(fn, init: Initializer, n: int, cfg: ModelConfig):
    """``n`` layers of ``fn`` stacked on a leading axis, drawn one layer
    at a time into preallocated leaves (no second copy of the stack)."""
    first = fn(init, cfg)
    out = _map(lambda x: torch.empty((n,) + tuple(x.shape), dtype=x.dtype,
                                     device=x.device), first)
    for i in range(n):
        layer = first if i == 0 else fn(init, cfg)
        _zip(lambda o, x: o[i].copy_(x), out, layer)
    return out


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _zip(fn, a, b):
    if isinstance(a, dict):
        for k in a:
            _zip(fn, a[k], b[k])
    else:
        fn(a, b)


def layer_params(params: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer ``i``'s parameters (views into the stacked leaves)."""
    return _map(lambda x: x[i], params["layers"])


def init_params(generator: torch.Generator, cfg: ModelConfig
                ) -> Dict[str, Any]:
    """Random parameters on the generator's device, with the JAX tree's
    shapes and dtypes."""
    _check_family(cfg)
    init = Initializer(generator, dtype_of(cfg.param_dtype))
    params: Dict[str, Any] = {
        "embed": init.normal((cfg.vocab, cfg.d_model), 1.0),
        "final_norm": init.zeros((cfg.d_model,)),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = init.normal((cfg.vocab, cfg.d_model),
                                        cfg.d_model ** -0.5)
    params["layers"] = _stack_init(_init_ssm_layer, init, cfg.n_layers, cfg)
    return params


def _ssm_block(x, lp, cfg: ModelConfig):
    h = rms_norm(x, lp["ln"], cfg.norm_eps)
    return x + ssm_mod.mamba_block(h, lp["ssm"], cfg.d_model, cfg.ssm)


def forward(params, tokens: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, L] -> (hidden [B, L, D], aux_loss)."""
    _check_family(cfg)
    x = params["embed"][tokens]
    for i in range(cfg.n_layers):
        x = _ssm_block(x, layer_params(params, i), cfg)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      device) -> Dict[str, torch.Tensor]:
    """``cache_len`` i32[B], ``ssm_h`` f32[L, B, di, N] and ``ssm_conv``
    [L, B, K - 1, di] in the compute dtype, all zero (``max_len`` sizes
    the attention families' caches; the ssm family has none)."""
    _check_family(cfg)
    s = cfg.ssm
    ssm_mod._check_version(s)
    di = s.expand * cfg.d_model
    return {
        "cache_len": torch.zeros((batch,), dtype=torch.int32, device=device),
        "ssm_h": torch.zeros((cfg.n_layers, batch, di, s.state_dim),
                             dtype=torch.float32, device=device),
        "ssm_conv": torch.zeros((cfg.n_layers, batch, s.conv_width - 1, di),
                                dtype=dtype_of(cfg.compute_dtype),
                                device=device),
    }


def _logits(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    unembed = params["embed"] if cfg.tie_embeddings else params["unembed"]
    scale = cfg.d_model ** -0.5 if cfg.tie_embeddings else 1.0
    return (x * scale) @ unembed.T


def decode_step(params, state, tokens: torch.Tensor, cfg: ModelConfig):
    """tokens [B, 1] -> (logits f32[B, V], new_state).  Loops over the
    layers, writing each layer's new ``h``/``conv`` into new stacked
    tensors; the given state is not modified."""
    _check_family(cfg)
    x = params["embed"][tokens]
    nh = torch.empty_like(state["ssm_h"])
    nconv = torch.empty_like(state["ssm_conv"])
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        hn = rms_norm(x, lp["ln"], cfg.norm_eps)
        y, st = ssm_mod.mamba_decode_step(
            hn, {"h": state["ssm_h"][i], "conv": state["ssm_conv"][i]},
            lp["ssm"], cfg.d_model, cfg.ssm)
        x = x + y
        nh[i] = st["h"]
        nconv[i] = st["conv"]
    new_state = dict(state)
    new_state["ssm_h"], new_state["ssm_conv"] = nh, nconv
    new_state["cache_len"] = state["cache_len"] + 1
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _logits(params, x[:, 0], cfg).to(torch.float32)
    if cfg.logit_softcap is not None:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits, new_state


def prefill(params, tokens: torch.Tensor, cfg: ModelConfig, max_len: int):
    """Run the full prompt and build the decode state.  Returns (state,
    logits [B, V] in the compute dtype).  The state's ``ssm_h`` and
    ``ssm_conv`` stay zero, as the reference leaves them."""
    b, l = tokens.shape
    state = init_decode_state(cfg, b, max_len, tokens.device)
    x, _ = forward(params, tokens, cfg)
    state["cache_len"] = torch.full((b,), l, dtype=torch.int32,
                                    device=tokens.device)
    return state, _logits(params, x[:, -1], cfg)
