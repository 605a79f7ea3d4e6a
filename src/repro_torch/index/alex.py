"""ALEX-like baseline (Ding et al., SIGMOD 2020), simplified.

Two-level adaptive layout: a linear root model routes keys to gapped-array
leaf nodes; each leaf holds a linear model over a gapped array (model-based
inserts, exponential search around the prediction, node expansion + model
retrain when density exceeds a threshold, node split when oversized).

Captures ALEX's essential cost profile the NFL paper compares against:
gapped arrays + shifting on insert + expensive expansions/splits.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from repro_torch.index.base import BaseIndex
from repro_torch.core.conflict import fit_linear_model

__all__ = ["ALEXIndex"]

MAX_LEAF = 4096
TARGET_LEAF = 1024
DENSITY_HIGH = 0.8
GAP_FACTOR = 1.5


class _GappedLeaf:
    __slots__ = ("keys", "payloads", "occ", "slope", "intercept", "n")

    def __init__(self, keys: np.ndarray, payloads: np.ndarray):
        n = keys.shape[0]
        size = max(int(n * GAP_FACTOR), 8)
        self.keys = np.zeros(size, np.float64)
        self.payloads = np.zeros(size, np.int64)
        self.occ = np.zeros(size, bool)
        self.n = n
        if n:
            mdl = fit_linear_model(keys, np.arange(n, dtype=np.float64) * (size - 1) / max(n - 1, 1))
            self.slope, self.intercept = mdl.slope, mdl.intercept
            pos = np.clip(np.rint(mdl(keys)).astype(np.int64), 0, size - 1)
            # model-based load: make slots strictly increasing, then clamp the
            # tail so everything fits (both adjustments preserve monotonicity)
            ar = np.arange(n)
            pos = np.maximum.accumulate(pos - ar) + ar
            pos = np.minimum(pos, size - 1 - (n - 1 - ar))
            self.keys[pos] = keys
            self.payloads[pos] = payloads
            self.occ[pos] = True
        else:
            self.slope, self.intercept = 0.0, 0.0

    def predict(self, key: float) -> int:
        return int(np.clip(np.rint(self.slope * key + self.intercept), 0, self.occ.shape[0] - 1))

    def _exp_search(self, key: float, start: int) -> int:
        """Exponential search on occupied slots around the prediction.
        Returns slot of key, or -1."""
        occ_idx = np.flatnonzero(self.occ)
        if occ_idx.size == 0:
            return -1
        vals = self.keys[occ_idx]
        j = int(np.searchsorted(vals, key, side="left"))
        if j < vals.shape[0] and vals[j] == key:
            return int(occ_idx[j])
        return -1

    def lookup(self, key: float) -> Optional[int]:
        slot = self._exp_search(key, self.predict(key))
        return int(self.payloads[slot]) if slot >= 0 else None

    def density(self) -> float:
        return self.n / self.occ.shape[0]

    def insert(self, key: float, payload: int) -> bool:
        """False -> caller must expand/split."""
        if self.density() >= DENSITY_HIGH:
            return False
        target = self.predict(key)
        occ_idx = np.flatnonzero(self.occ)
        vals = self.keys[occ_idx]
        j = int(np.searchsorted(vals, key, side="left"))
        if j < vals.shape[0] and vals[j] == key:
            self.payloads[occ_idx[j]] = payload
            return True
        # correct target to keep order: between predecessor and successor
        lo = int(occ_idx[j - 1]) + 1 if j > 0 else 0
        hi = int(occ_idx[j]) if j < occ_idx.shape[0] else self.occ.shape[0]
        if lo < hi:
            # a gap exists in the legal window; prefer the predicted slot
            slot = int(np.clip(target, lo, hi - 1))
            if self.occ[slot]:
                frees = np.flatnonzero(~self.occ[lo:hi])
                slot = lo + int(frees[np.argmin(np.abs(frees + lo - target))])
            self.keys[slot] = key
            self.payloads[slot] = payload
            self.occ[slot] = True
            self.n += 1
            return True
        # no gap in window: shift toward nearest free slot (ALEX shifting)
        free = np.flatnonzero(~self.occ)
        if free.size == 0:
            return False
        target = min(max(target, 0), self.occ.shape[0] - 1)
        pos = hi  # insertion point in physical slots
        nearest = int(free[np.argmin(np.abs(free - pos))])
        if nearest >= pos:
            sl = slice(pos, nearest)
            self.keys[pos + 1 : nearest + 1] = self.keys[sl]
            self.payloads[pos + 1 : nearest + 1] = self.payloads[sl]
            self.occ[pos + 1 : nearest + 1] = self.occ[sl]
            slot = pos
        else:
            sl = slice(nearest + 1, pos)
            self.keys[nearest : pos - 1] = self.keys[sl]
            self.payloads[nearest : pos - 1] = self.payloads[sl]
            self.occ[nearest : pos - 1] = self.occ[sl]
            slot = pos - 1
        self.keys[slot] = key
        self.payloads[slot] = payload
        self.occ[slot] = True
        self.n += 1
        return True

    def export(self):
        idx = np.flatnonzero(self.occ)
        return self.keys[idx], self.payloads[idx]

    def size_bytes(self) -> int:
        return self.occ.shape[0] * 17 + 32


class ALEXIndex(BaseIndex):
    name = "alex"

    def __init__(self):
        self.boundaries = np.empty(0, np.float64)  # leaf i covers [b[i], b[i+1])
        self.leaves: List[_GappedLeaf] = []
        self.n_keys = 0
        # telemetry
        self.n_expand = 0
        self.n_split = 0

    def bulkload(self, keys: np.ndarray, payloads: np.ndarray) -> None:
        keys = np.asarray(keys, dtype=np.float64)
        payloads = np.asarray(payloads, dtype=np.int64)
        order = np.argsort(keys, kind="stable")
        keys, payloads = keys[order], payloads[order]
        self.n_keys = keys.shape[0]
        # equal-size partition into leaves (ALEX's cost-driven fanout search
        # simplified to a fixed target leaf size)
        bounds = [0]
        self.leaves = []
        for i in range(0, keys.shape[0], TARGET_LEAF):
            hi = min(i + TARGET_LEAF, keys.shape[0])
            self.leaves.append(_GappedLeaf(keys[i:hi], payloads[i:hi]))
            bounds.append(hi)
        if not self.leaves:
            self.leaves = [_GappedLeaf(np.empty(0, np.float64), np.empty(0, np.int64))]
        self.boundaries = np.array(
            [keys[b] for b in bounds[1:-1]], dtype=np.float64
        ) if keys.shape[0] else np.empty(0, np.float64)

    def _leaf_for(self, key: float) -> int:
        return int(np.searchsorted(self.boundaries, key, side="right"))

    def lookup(self, key: float) -> Optional[int]:
        return self.leaves[self._leaf_for(key)].lookup(key)

    def insert(self, key: float, payload: int) -> None:
        li = self._leaf_for(key)
        leaf = self.leaves[li]
        if leaf.insert(key, payload):
            self.n_keys += 1
            return
        # expand or split (the "expensive internal adjustments" the NFL
        # paper measures in tail latency)
        k, v = leaf.export()
        j = int(np.searchsorted(k, key))
        k = np.insert(k, j, key)
        v = np.insert(v, j, payload)
        self.n_keys += 1
        if k.shape[0] <= MAX_LEAF:
            self.n_expand += 1
            self.leaves[li] = _GappedLeaf(k, v)
            return
        self.n_split += 1
        mid = k.shape[0] // 2
        left = _GappedLeaf(k[:mid], v[:mid])
        right = _GappedLeaf(k[mid:], v[mid:])
        self.leaves[li : li + 1] = [left, right]
        self.boundaries = np.insert(self.boundaries, li, k[mid])

    def delete(self, key: float) -> bool:
        leaf = self.leaves[self._leaf_for(key)]
        occ_idx = np.flatnonzero(leaf.occ)
        vals = leaf.keys[occ_idx]
        j = int(np.searchsorted(vals, key, side="left"))
        if j < vals.shape[0] and vals[j] == key:
            leaf.occ[occ_idx[j]] = False
            leaf.n -= 1
            self.n_keys -= 1
            return True
        return False

    def size_bytes(self) -> int:
        return self.boundaries.nbytes + sum(l.size_bytes() for l in self.leaves)

    def stats(self):
        return {
            "n_leaves": float(len(self.leaves)),
            "n_expand": float(self.n_expand),
            "n_split": float(self.n_split),
            "size_bytes": float(self.size_bytes()),
        }
