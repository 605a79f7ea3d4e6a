"""Key datasets (paper §4.1.1), synthetic stand-ins, numpy.

Own copy of the ``repro.data.datasets`` generators, draw for draw, so
both packages see the same keys for a seed:

  longitudes (LTD)  mixture of population clusters over [-180, 180]
  longlat    (LLT)  180*floor(longitude)+latitude compound keys (highly
                    non-linear, the paper's hardest case)
  lognormal  (LGN)  lognormal(0, 2) * 1e9, floored
  ycsb              uniform 64-bit user ids (near-uniform CDF)
  amazon    (AMZN)  book sales ranks: power-law-ish but smoothed
  facebook  (FB)    upsampled user ids: uniform base + heavy clustering
  wikipedia (WIKI)  edit timestamps: near-linear with daily periodicity

``make_dataset`` raises ``KeyError`` on an unknown name.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np

__all__ = ["DATASETS", "make_dataset", "dataset_names",
           "longitudes", "longlat", "lognormal", "ycsb", "amazon",
           "facebook", "wikipedia"]


def _unique_n(raw: np.ndarray, n: int, rng: np.random.Generator,
              pad_scale: float) -> np.ndarray:
    keys = np.unique(raw.astype(np.float64))
    while keys.shape[0] < n:
        extra = rng.uniform(keys.min(), keys.max(), size=n)
        keys = np.unique(np.concatenate([keys, extra]))
    idx = rng.choice(keys.shape[0], size=n, replace=False)
    return np.sort(keys[idx])


def longitudes(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n_clusters = 64
    centers = rng.uniform(-180, 180, n_clusters)
    widths = rng.uniform(0.05, 3.0, n_clusters)
    weights = rng.pareto(1.2, n_clusters) + 0.05
    weights /= weights.sum()
    counts = rng.multinomial(int(n * 1.3), weights)
    parts = [rng.normal(c, w, size=k) for c, w, k in zip(centers, widths, counts)]
    raw = np.clip(np.concatenate(parts), -180.0, 180.0)
    return _unique_n(raw, n, rng, 1.0)


def longlat(n: int, seed: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    lon = longitudes(int(n * 1.3), seed=seed + 100)
    lat = np.clip(rng.normal(20, 30, size=lon.shape[0]), -90, 90)
    raw = 180.0 * np.floor(lon) + lat  # paper's compound transformation
    return _unique_n(raw, n, rng, 1.0)


def lognormal(n: int, seed: int = 2) -> np.ndarray:
    rng = np.random.default_rng(seed)
    raw = np.floor(rng.lognormal(0.0, 2.0, int(n * 1.4)) * 1e9)
    return _unique_n(raw, n, rng, 1e9)


def ycsb(n: int, seed: int = 3) -> np.ndarray:
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 1 << 62, size=int(n * 1.2)).astype(np.float64)
    return _unique_n(raw, n, rng, 1e18)


def amazon(n: int, seed: int = 4) -> np.ndarray:
    rng = np.random.default_rng(seed)
    # sales ranks: dense small ranks, long sparse tail
    raw = np.floor(rng.pareto(0.7, int(n * 1.4)) * 1e5) + rng.integers(
        0, 1 << 22, int(n * 1.4)
    ).astype(np.float64)
    return _unique_n(raw, n, rng, 1e7)


def facebook(n: int, seed: int = 5) -> np.ndarray:
    rng = np.random.default_rng(seed)
    # upsampled user ids: several dense id-allocation epochs + sparse noise
    n_epochs = 24
    starts = np.sort(rng.integers(0, 1 << 40, n_epochs)).astype(np.float64)
    sizes = rng.pareto(1.0, n_epochs) + 0.1
    sizes = (sizes / sizes.sum() * n * 1.3).astype(np.int64)
    parts = []
    for s, m in zip(starts, sizes):
        stride = float(rng.integers(1, 64))
        parts.append(s + np.cumsum(rng.exponential(stride,
                                                   size=max(int(m), 1))))
    raw = np.concatenate(parts)
    return _unique_n(raw, n, rng, 1e12)


def wikipedia(n: int, seed: int = 6) -> np.ndarray:
    rng = np.random.default_rng(seed)
    # edit timestamps: near-uniform in time with diurnal cycles
    t = rng.uniform(0, 3.15e8, int(n * 1.25))  # ~10 years of seconds
    diurnal = 0.35 * np.sin(2 * np.pi * (t % 86400.0) / 86400.0)
    keep = rng.uniform(0, 1, t.shape[0]) < (0.65 + diurnal)
    raw = np.floor(t[keep] * 1e3)
    return _unique_n(raw, n, rng, 1e11)


DATASETS: Dict[str, Callable[..., np.ndarray]] = {
    "longitudes": longitudes,
    "longlat": longlat,
    "lognormal": lognormal,
    "ycsb": ycsb,
    "amazon": amazon,
    "facebook": facebook,
    "wikipedia": wikipedia,
}

# the paper's abbreviations
ALIASES = {"ltd": "longitudes", "llt": "longlat", "lgn": "lognormal",
           "amzn": "amazon", "fb": "facebook", "wiki": "wikipedia",
           "ycsb": "ycsb"}


def dataset_names():
    return list(DATASETS)


def make_dataset(name: str, n: int, seed: int | None = None) -> np.ndarray:
    name = ALIASES.get(name.lower(), name.lower())
    fn = DATASETS[name]
    return fn(n) if seed is None else fn(n, seed=seed)
