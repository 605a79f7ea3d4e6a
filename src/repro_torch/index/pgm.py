"""PGM-Index baseline (Ferragina & Vinciguerra, VLDB 2020).

Static layer: optimal-ish piecewise linear approximation with error bound
``epsilon`` built by the shrinking-cone streaming algorithm (single pass,
O(n)); levels are built recursively on segment start keys until one segment
remains.  Lookup descends the levels, each time binary-searching a +/-eps
window — the paper's "provable worst-case bounds".

Dynamic layer: LSM-style logarithmic method, as in the PGM paper's dynamic
variant (and as observed by the NFL paper: "The high insertion performance
of PGM-Index benefits from the LSM-Tree structure, where a small buffer of
size 128 is used to receive new insertions").  Inserts go to a small sorted
buffer; on overflow, geometrically growing static PGM levels are merged.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from repro_torch.index.base import BaseIndex

__all__ = ["PGMIndex", "build_segments"]


def build_segments(keys: np.ndarray, eps: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Shrinking-cone PLA: segments (first_key, slope, intercept) with
    |predicted_rank - rank| <= eps for every key in the segment.

    Returns (seg_keys, slopes, intercepts) where intercept is the rank of
    the segment's first key and predictions are slope*(k-first)+intercept.
    """
    n = keys.shape[0]
    seg_keys, slopes, intercepts = [], [], []
    i = 0
    while i < n:
        x0 = keys[i]
        lo, hi = -np.inf, np.inf
        j = i + 1
        while j < n:
            dx = keys[j] - x0
            if dx <= 0:
                j += 1
                continue
            dy = j - i
            s_hi = (dy + eps) / dx
            s_lo = (dy - eps) / dx
            new_lo = max(lo, s_lo)
            new_hi = min(hi, s_hi)
            if new_lo > new_hi:
                break
            lo, hi = new_lo, new_hi
            j += 1
        if j == i + 1:
            slope = 0.0
        else:
            slope = (lo + hi) / 2.0
            if not np.isfinite(slope):
                slope = 0.0
        seg_keys.append(x0)
        slopes.append(slope)
        intercepts.append(float(i))
        i = j
    return (
        np.asarray(seg_keys, dtype=np.float64),
        np.asarray(slopes, dtype=np.float64),
        np.asarray(intercepts, dtype=np.float64),
    )


class _StaticPGM:
    def __init__(self, keys: np.ndarray, payloads: np.ndarray, eps: int):
        self.keys = keys
        self.payloads = payloads
        self.eps = eps
        self.levels: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        lvl_keys = keys
        while True:
            segs = build_segments(lvl_keys, eps)
            self.levels.append(segs)
            if segs[0].shape[0] <= 1:
                break
            lvl_keys = segs[0]
        self.levels.reverse()  # root first

    def _predict(self, key: float) -> int:
        """Descend levels; returns approximate rank in self.keys."""
        seg_idx = 0
        for li, (skeys, slopes, intercepts) in enumerate(self.levels):
            last = li == len(self.levels) - 1
            if li == 0:
                j = 0 if skeys.shape[0] == 1 else self._search_level(li, key, 0, skeys.shape[0])
            else:
                j = seg_idx
            pred = slopes[j] * (key - skeys[j]) + intercepts[j]
            pred_i = int(pred)
            if last:
                return pred_i
            nxt_keys = self.levels[li + 1][0]
            n = nxt_keys.shape[0]
            # clamp the eps-window INTO the next level (a wildly-off parent
            # prediction on a tiny LSM run must not index past the end)
            lo = min(max(0, pred_i - self.eps), n - 1)
            hi = min(n, max(pred_i + self.eps + 2, lo + 1))
            seg_idx = lo + max(
                0, int(np.searchsorted(nxt_keys[lo:hi], key, side="right")) - 1
            )
            seg_idx = min(seg_idx, n - 1)
        return 0

    def _search_level(self, li: int, key: float, lo: int, hi: int) -> int:
        skeys = self.levels[li][0]
        return max(0, int(np.searchsorted(skeys[lo:hi], key, side="right")) - 1 + lo)

    def lookup(self, key: float) -> Optional[int]:
        if self.keys.shape[0] == 0:
            return None
        pred = self._predict(key)
        lo = max(0, pred - self.eps)
        hi = min(self.keys.shape[0], pred + self.eps + 2)
        j = lo + int(np.searchsorted(self.keys[lo:hi], key, side="left"))
        if j < self.keys.shape[0] and self.keys[j] == key:
            return int(self.payloads[j])
        return None

    def size_bytes(self) -> int:
        total = self.keys.nbytes + self.payloads.nbytes
        for skeys, slopes, intercepts in self.levels:
            total += skeys.nbytes + slopes.nbytes + intercepts.nbytes
        return total

    def n_segments(self) -> int:
        return self.levels[-1][0].shape[0] if self.levels else 0


class PGMIndex(BaseIndex):
    name = "pgm"

    def __init__(self, eps: int = 64, buffer_size: int = 128, level_ratio: int = 8):
        self.eps = eps
        self.buffer_size = buffer_size
        self.level_ratio = level_ratio
        self.buf_keys: List[float] = []
        self.buf_payloads: List[int] = []
        self.lsm: List[Optional[_StaticPGM]] = []

    def bulkload(self, keys: np.ndarray, payloads: np.ndarray) -> None:
        keys = np.asarray(keys, dtype=np.float64)
        payloads = np.asarray(payloads, dtype=np.int64)
        order = np.argsort(keys, kind="stable")
        self.lsm = [_StaticPGM(keys[order], payloads[order], self.eps)]

    def lookup(self, key: float) -> Optional[int]:
        # newest first: buffer, then LSM levels small->large
        for bk, bv in zip(self.buf_keys, self.buf_payloads):
            if bk == key:
                return bv
        for lvl in self.lsm:
            if lvl is None:
                continue
            r = lvl.lookup(key)
            if r is not None:
                return r
        return None

    def insert(self, key: float, payload: int) -> None:
        self.buf_keys.append(key)
        self.buf_payloads.append(payload)
        if len(self.buf_keys) >= self.buffer_size:
            self._flush()

    def _flush(self) -> None:
        keys = np.asarray(self.buf_keys, dtype=np.float64)
        payloads = np.asarray(self.buf_payloads, dtype=np.int64)
        order = np.argsort(keys, kind="stable")
        keys, payloads = keys[order], payloads[order]
        self.buf_keys, self.buf_payloads = [], []
        carry = _StaticPGM(keys, payloads, self.eps)
        # logarithmic method: merge equal-ish sized runs geometrically
        slot = 0
        cap = self.buffer_size
        while True:
            if slot >= len(self.lsm):
                self.lsm.append(carry)
                return
            if self.lsm[slot] is None:
                self.lsm[slot] = carry
                return
            if self.lsm[slot].keys.shape[0] > cap * self.level_ratio:
                # big level: keep carry here, don't merge into the huge run
                self.lsm.insert(slot, carry)
                return
            other = self.lsm[slot]
            self.lsm[slot] = None
            mk = np.concatenate([carry.keys, other.keys])
            mv = np.concatenate([carry.payloads, other.payloads])
            order = np.argsort(mk, kind="stable")
            carry = _StaticPGM(mk[order], mv[order], self.eps)
            slot += 1
            cap *= self.level_ratio

    def delete(self, key: float) -> bool:
        # tombstone-free simplification: physical delete from whichever run
        for i, bk in enumerate(self.buf_keys):
            if bk == key:
                del self.buf_keys[i]
                del self.buf_payloads[i]
                return True
        return False  # static runs are immutable; benchmark mixes avoid this

    def size_bytes(self) -> int:
        total = 24 * len(self.buf_keys)
        for lvl in self.lsm:
            if lvl is not None:
                total += lvl.size_bytes()
        return total

    def stats(self):
        segs = sum(l.n_segments() for l in self.lsm if l is not None)
        return {
            "levels": float(sum(1 for l in self.lsm if l is not None)),
            "segments": float(segs),
            "size_bytes": float(self.size_bytes()),
        }
