"""Parameters carried over from the JAX package.

``params_from_numpy`` turns a ``train_flow`` parameter tree given as
numpy arrays (``{"layers": [{"w", "b"}, ...], "out_log_scale",
"feat_mu", "feat_sd"}``) into the port's tree of f32 tensors, leaf for
leaf, so both packages compute the same flow.  ``model_params_from_numpy``
does the same for an LM's ``model.init`` tree, keeping each leaf's dtype;
a bfloat16 leaf (numpy's ml_dtypes type, as ``np.asarray`` of a JAX
array gives it) crosses bit for bit through a ``uint16`` view, without
importing ml_dtypes.  ``train_state_from_numpy`` carries a JAX train
state across (params, the AdamW ``step``/``m``/``v`` or the Adafactor
``step``/``vr``/``vc``, and the state's step), so both packages can
train on from one state.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from repro_torch.kernels.backend import resolve_device

__all__ = ["params_from_numpy", "model_params_from_numpy",
           "train_state_from_numpy"]


def params_from_numpy(tree: Dict[str, Any],
                      device: Optional[Union[str, torch.device]] = None
                      ) -> Dict[str, Any]:
    dev = resolve_device(device)

    def leaf(x):
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(dev)

    out: Dict[str, Any] = {
        "layers": [{"w": leaf(layer["w"]), "b": leaf(layer["b"])}
                   for layer in tree["layers"]],
        "out_log_scale": leaf(tree["out_log_scale"]),
    }
    for k in ("feat_mu", "feat_sd"):
        if k in tree:
            out[k] = leaf(tree[k])
    return out


_NUMPY_DTYPES = ("float32", "float16", "float64")


def _leaf_from_numpy(x, dev: torch.device) -> torch.Tensor:
    x = np.asarray(x)
    # (np.ascontiguousarray makes a 0-d array 1-d: reshape back)
    if x.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(x).view(np.uint16).view(np.int16)
        return torch.from_numpy(bits.reshape(x.shape).copy()).view(
            torch.bfloat16).to(dev)
    if x.dtype.name not in _NUMPY_DTYPES:
        raise ValueError(f"unsupported parameter dtype {x.dtype}")
    return torch.from_numpy(
        np.ascontiguousarray(x).reshape(x.shape).copy()).to(dev)


def model_params_from_numpy(tree: Dict[str, Any], cfg,
                            device: Optional[Union[str, torch.device]] = None
                            ) -> Dict[str, Any]:
    """An LM parameter tree of numpy arrays (the JAX ``model.init`` tree
    of any family: stacked ``[n_layers, ...]`` leaves, ``shared_attn``,
    ``cross_layers``, ``enc_layers`` and ``dec_layers`` included) -> the
    port's tree of tensors on ``device``, leaf for leaf and dtype for
    dtype.  ``cfg`` is the model's ``ModelConfig``; its family must be
    one the port builds."""
    from repro_torch.models.transformer import FAMILIES

    if cfg.family not in FAMILIES + ("encdec",):
        raise ValueError(f"unknown family {cfg.family!r}")
    dev = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return _leaf_from_numpy(t, dev)

    return conv(tree)


def train_state_from_numpy(state, cfg,
                           device: Optional[Union[str, torch.device]] = None):
    """A JAX ``TrainState`` whose leaves are numpy arrays (``jax.tree.map(
    np.asarray, state)``) -> the port's ``TrainState`` on ``device``.
    ``state.opt`` is an AdamW state (fields ``step``, ``m``, ``v``) or an
    Adafactor state (``step``, ``vr``, ``vc``), read by field name; each
    leaf keeps its dtype (bf16 bit for bit)."""
    from repro_torch.train.optimizer import AdafactorState, AdamWState
    from repro_torch.train.train_step import TrainState

    dev = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return _leaf_from_numpy(t, dev)

    def scalar(x):
        return torch.tensor(int(np.asarray(x)), dtype=torch.int32,
                            device=dev)

    opt = state.opt
    if hasattr(opt, "m"):
        new_opt = AdamWState(step=scalar(opt.step), m=conv(opt.m),
                             v=conv(opt.v))
    elif hasattr(opt, "vr"):
        new_opt = AdafactorState(step=scalar(opt.step), vr=conv(opt.vr),
                                 vc=conv(opt.vc))
    else:
        raise ValueError(f"unknown optimizer state {type(opt).__name__}")
    return TrainState(model_params_from_numpy(state.params, cfg, dev),
                      new_opt, scalar(state.step))
