"""Device selection shared by the port's entry points.

The JAX package picks interpret or compiled mode per backend; the port
has no interpret mode.  Entry points take ``device=None`` and resolve it
here: ``None`` means the card, and without a card that raises instead of
falling back to the CPU.  ``device="cpu"`` runs every kernel's plain
PyTorch version (the tests use it).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda``; raises when no card is present.  Explicit
    devices pass through (``"cpu"`` selects the plain versions)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
