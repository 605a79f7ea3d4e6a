"""RMI baseline (Kraska et al., SIGMOD 2018) — static 2-stage recursive
model index over a sorted array, with last-mile binary search.

Used for Table-1-style diagnostics (#predictions, #errors) and read-only
comparisons; the updatable baselines are ALEX/LIPP/PGM/BTree.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.index.base import BaseIndex
from repro_torch.core.conflict import fit_linear_model

__all__ = ["RMI"]


class RMI(BaseIndex):
    name = "rmi"

    def __init__(self, n_leaf_models: int = 4096):
        self.n_leaf = n_leaf_models
        self.keys = np.empty(0, np.float64)
        self.payloads = np.empty(0, np.int64)
        # root: rank ~ slope*key+intercept scaled into leaf id
        self.root = (0.0, 0.0)
        self.leaf_slope = np.empty(0, np.float64)
        self.leaf_intercept = np.empty(0, np.float64)
        self.leaf_err = np.empty(0, np.int64)
        # telemetry (paper Table 1)
        self.n_predictions = 0
        self.n_pred_errors = 0

    def bulkload(self, keys: np.ndarray, payloads: np.ndarray) -> None:
        keys = np.asarray(keys, dtype=np.float64)
        payloads = np.asarray(payloads, dtype=np.int64)
        order = np.argsort(keys, kind="stable")
        self.keys, self.payloads = keys[order], payloads[order]
        n = self.keys.shape[0]
        m = min(self.n_leaf, max(1, n // 64))
        self.n_leaf = m
        root = fit_linear_model(self.keys, np.arange(n, dtype=np.float64) * (m / max(n, 1)))
        self.root = (root.slope, root.intercept)
        leaf_of = np.clip(np.floor(root(self.keys)).astype(np.int64), 0, m - 1)
        # keys are sorted & root slope >= 0, so leaf_of is nondecreasing
        self.leaf_slope = np.zeros(m, np.float64)
        self.leaf_intercept = np.zeros(m, np.float64)
        self.leaf_err = np.zeros(m, np.int64)
        starts = np.searchsorted(leaf_of, np.arange(m), side="left")
        ends = np.searchsorted(leaf_of, np.arange(m), side="right")
        for j in range(m):
            lo, hi = int(starts[j]), int(ends[j])
            if hi <= lo:
                self.leaf_intercept[j] = lo
                continue
            mdl = fit_linear_model(self.keys[lo:hi], np.arange(lo, hi, dtype=np.float64))
            self.leaf_slope[j] = mdl.slope
            self.leaf_intercept[j] = mdl.intercept
            pred = np.rint(mdl(self.keys[lo:hi])).astype(np.int64)
            err = np.abs(pred - np.arange(lo, hi))
            self.leaf_err[j] = int(err.max()) if err.size else 0

    def _predict(self, key: float) -> tuple[int, int]:
        slope, intercept = self.root
        j = int(np.clip(np.floor(slope * key + intercept), 0, self.n_leaf - 1))
        pred = int(np.rint(self.leaf_slope[j] * key + self.leaf_intercept[j]))
        self.n_predictions += 2
        return pred, int(self.leaf_err[j])

    def lookup(self, key: float) -> Optional[int]:
        n = self.keys.shape[0]
        if n == 0:
            return None
        pred, err = self._predict(key)
        lo = max(0, pred - err - 1)
        hi = min(n, pred + err + 2)
        j = lo + int(np.searchsorted(self.keys[lo:hi], key, side="left"))
        if j < n and self.keys[j] == key:
            if j != pred:
                self.n_pred_errors += abs(j - pred)
            return int(self.payloads[j])
        return None

    def insert(self, key: float, payload: int) -> None:
        raise NotImplementedError("RMI is a static index (paper: read-only)")

    def size_bytes(self) -> int:
        return (
            self.keys.nbytes + self.payloads.nbytes
            + self.leaf_slope.nbytes + self.leaf_intercept.nbytes + self.leaf_err.nbytes
        )

    def stats(self):
        return {
            "n_leaf_models": float(self.n_leaf),
            "max_leaf_err": float(self.leaf_err.max() if self.leaf_err.size else 0),
            "size_bytes": float(self.size_bytes()),
        }
