"""Conflict degree and tail conflict degree (paper Defs 3.1, 3.2), numpy.

Own copy of ``repro.core.conflict`` (the port imports nothing of the
JAX package).

The conflict degree of slot j under a fitted linear model M over keys X is
``|{x in X : round(M(x)) == j}|``.  The tail conflict degree at tail percent
gamma is the ``floor(m * gamma)``-th smallest (== (1-gamma) tail largest)
among the m non-zero conflict degrees.  It quantifies how near-uniform a key
set is and drives (1) the NF switching decision and (2) AFLI's bucket /
dense-node capacity.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

__all__ = [
    "LinearModel",
    "fit_linear_model",
    "conflict_degrees",
    "tail_conflict_degree",
    "dataset_tail_conflict",
    "should_use_flow",
    "accept_candidate",
]


@dataclasses.dataclass(frozen=True)
class LinearModel:
    """pos = slope * key + intercept."""

    slope: float
    intercept: float

    def __call__(self, keys: np.ndarray) -> np.ndarray:
        return self.slope * np.asarray(keys, dtype=np.float64) + self.intercept


def fit_linear_model(
    keys: np.ndarray, positions: np.ndarray | None = None
) -> LinearModel:
    """Least-squares fit keys -> positions (default positions = 0..n-1).

    Uses the closed form on centered data for numerical stability with
    large-magnitude keys (f64 throughout).
    """
    keys = np.asarray(keys, dtype=np.float64)
    n = keys.shape[0]
    if positions is None:
        positions = np.arange(n, dtype=np.float64)
    else:
        positions = np.asarray(positions, dtype=np.float64)
    if n == 1:
        return LinearModel(slope=0.0, intercept=float(positions[0]))
    km = keys.mean()
    pm = positions.mean()
    dk = keys - km
    var = float(np.dot(dk, dk))
    if var <= 0.0 or not np.isfinite(var):
        return LinearModel(slope=0.0, intercept=float(pm))
    slope = float(np.dot(dk, positions - pm)) / var
    if not np.isfinite(slope):
        slope = 0.0
    return LinearModel(slope=slope, intercept=float(pm - slope * km))


def conflict_degrees(keys: np.ndarray, model: LinearModel) -> np.ndarray:
    """Def 3.1: per-slot conflict counts (only slots with degree > 0).

    Returns the (unsorted) array of conflict degrees of occupied slots.
    """
    keys = np.asarray(keys, dtype=np.float64)
    pred = np.rint(model(keys)).astype(np.int64)
    # bincount over a shifted range; slots with zero hits are dropped per Def 3.2
    pred -= pred.min()
    counts = np.bincount(pred)
    return counts[counts > 0]


def tail_conflict_degree(
    degrees: np.ndarray, gamma: float = 0.99
) -> int:
    """Def 3.2: the floor(m*gamma)-th largest-from-the-bottom conflict degree.

    With the paper's worked example (m=1000, gamma=0.99 -> t=990), the tail
    conflict degree is the 990th value in ascending order, i.e. the 99th
    percentile of per-slot conflicts.
    """
    degrees = np.asarray(degrees)
    m = degrees.shape[0]
    if m == 0:
        return 1
    t = int(np.floor(m * gamma))
    t = min(max(t, 1), m)
    return int(np.sort(degrees)[t - 1])


def dataset_tail_conflict(keys: np.ndarray, gamma: float = 0.99) -> int:
    """Tail conflict degree of a key set under its own global linear fit."""
    keys = np.sort(np.asarray(keys, dtype=np.float64))
    model = fit_linear_model(keys)
    if model.slope == 0.0:
        return int(keys.shape[0])
    return tail_conflict_degree(conflict_degrees(keys, model), gamma)


def should_use_flow(
    original_keys: np.ndarray,
    transformed_keys: np.ndarray,
    gamma: float = 0.99,
) -> Tuple[bool, int, int]:
    """Paper §3.2.2 switching mechanism.

    Transforms are only kept when they strictly reduce the tail conflict
    degree; returns (use_flow, tail_original, tail_transformed).
    """
    tail_orig = dataset_tail_conflict(original_keys, gamma)
    tail_flow = dataset_tail_conflict(transformed_keys, gamma)
    return tail_flow < tail_orig, tail_orig, tail_flow


def accept_candidate(tail_serving: int, tail_candidate: int,
                     decay: float = 0.1) -> bool:
    """Online analogue of the reference AutoSwitch's ``kConflictsDecay``
    margin: a candidate transform may replace the serving one only when
    its tail conflict degree beats the serving tail *strictly* AND by at
    least ``decay * tail_serving`` — marginal wins are noise (the tails
    are measured on a drifting sample) and a re-key fold is not free, so
    ties and near-ties keep serving untouched."""
    ts = int(tail_serving)
    tc = int(tail_candidate)
    return tc < ts and (ts - tc) >= ts * float(decay)
