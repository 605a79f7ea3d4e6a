"""Feature-space expansion (paper Alg 3.1), numpy.

Own copy of ``repro.core.feature``'s host path: lifts 1-D numerical keys
into a d-dimensional feature vector ``[int(x_norm), digit_1, ...,
digit_{d-2}, residual]`` after a scaled min-max normalization, in
float64, cast to the requested dtype (f32 for the kernels).  The
decoder sums the flow's output vector back to a 1-D key.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["KeyNormalizer", "expand_features", "decode_features",
           "feature_scales"]


@dataclasses.dataclass(frozen=True)
class KeyNormalizer:
    """Scaled min-max normalization ``x_norm = (x - mu) / sigma`` with
    ``sigma = (max - min) / scale`` (Alg 3.1 line 2)."""

    mu: float
    sigma: float
    scale: float

    @staticmethod
    def fit(keys: np.ndarray, scale: float = 1e4) -> "KeyNormalizer":
        keys = np.asarray(keys, dtype=np.float64)
        lo = float(keys.min())
        hi = float(keys.max())
        span = hi - lo
        if span <= 0.0:
            span = 1.0
        return KeyNormalizer(mu=lo, sigma=span / scale, scale=scale)

    def normalize(self, keys: np.ndarray) -> np.ndarray:
        return (np.asarray(keys, dtype=np.float64) - self.mu) / self.sigma


def expand_features(keys: np.ndarray, normalizer: KeyNormalizer,
                    dim: int = 2, theta: float = 1e3,
                    dtype=np.float64) -> np.ndarray:
    """Alg 3.1 lines 3-17 over a key batch -> ``[n, dim]``."""
    if dim < 2:
        raise ValueError(f"feature dim must be >= 2, got {dim}")
    x = normalizer.normalize(np.asarray(keys, dtype=np.float64))
    feats = np.empty((x.shape[0], dim), dtype=np.float64)
    x_int = np.floor(x)
    x_float = x - x_int
    feats[:, 0] = x_int
    for k in range(1, dim - 1):
        x_float = x_float * theta
        x_int = np.floor(x_float)
        x_float = x_float - x_int
        feats[:, k] = x_int
    feats[:, dim - 1] = x_float
    return feats.astype(dtype)


def decode_features(z):
    """Alg 3.1 lines 19-22: merge the d-dim flow output into 1-D keys."""
    return z.sum(axis=-1)


def feature_scales(dim: int, theta: float) -> np.ndarray:
    """Per-dimension magnitude scale of the expanded features."""
    scales = np.ones((dim,), dtype=np.float64)
    for k in range(1, dim - 1):
        scales[k] = theta
    return scales
