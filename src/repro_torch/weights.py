"""Parameters carried over from the JAX package.

``params_from_numpy`` turns a ``train_flow`` parameter tree given as
numpy arrays (``{"layers": [{"w", "b"}, ...], "out_log_scale",
"feat_mu", "feat_sd"}``) into the port's tree of f32 tensors, leaf for
leaf, so both packages compute the same flow.  ``model_params_from_numpy``
does the same for an LM's ``model.init`` tree, keeping each leaf's dtype;
a bfloat16 leaf (numpy's ml_dtypes type, as ``np.asarray`` of a JAX
array gives it) crosses bit for bit through a ``uint16`` view, without
importing ml_dtypes.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from repro_torch.kernels.backend import resolve_device

__all__ = ["params_from_numpy", "model_params_from_numpy"]


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
    if x.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(x).view(np.uint16).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(dev)
    if x.dtype.name not in _NUMPY_DTYPES:
        raise ValueError(f"unsupported parameter dtype {x.dtype}")
    return torch.from_numpy(np.ascontiguousarray(x).copy()).to(dev)


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
