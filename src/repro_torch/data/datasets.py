"""Key datasets (paper §4.1.1), synthetic stand-ins, numpy.

Own copy of the ``repro.data.datasets`` generators this port serves so
far, draw for draw, so both packages see the same keys for a seed:

  longitudes (LTD)  mixture of population clusters over [-180, 180]
  longlat    (LLT)  180*floor(longitude)+latitude compound keys (highly
                    non-linear, the paper's hardest case)
  lognormal  (LGN)  lognormal(0, 2) * 1e9, floored

The remaining datasets (ycsb, amazon, facebook, wikipedia) port with
ROADMAP item A13.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np

__all__ = ["DATASETS", "make_dataset", "dataset_names",
           "longitudes", "longlat", "lognormal"]


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


DATASETS: Dict[str, Callable[..., np.ndarray]] = {
    "longitudes": longitudes,
    "longlat": longlat,
    "lognormal": lognormal,
}

ALIASES = {"ltd": "longitudes", "llt": "longlat", "lgn": "lognormal"}


def dataset_names():
    return list(DATASETS)


def make_dataset(name: str, n: int, seed: int | None = None) -> np.ndarray:
    name = ALIASES.get(name.lower(), name.lower())
    if name not in DATASETS:
        raise NotImplementedError(
            f"dataset {name!r} is not ported yet (ROADMAP A13)")
    fn = DATASETS[name]
    return fn(n) if seed is None else fn(n, seed=seed)
