"""Flow parameters carried over from the JAX package.

``params_from_numpy`` turns a ``train_flow`` parameter tree given as
numpy arrays (``{"layers": [{"w", "b"}, ...], "out_log_scale",
"feat_mu", "feat_sd"}``) into the port's tree of f32 tensors, leaf for
leaf, so both packages compute the same flow.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from repro_torch.kernels.backend import resolve_device

__all__ = ["params_from_numpy"]


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
