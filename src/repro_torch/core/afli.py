"""AFLI — After-Flow Learned Index (paper §3.3), the paper's pointer tree.

Own copy of ``repro.core.afli`` (the port imports nothing of the JAX
package), expression for expression, so both packages build bit-equal
trees from the same records.  The tree lives on the host in numpy and
Python and is probed key by key: it runs no kernel.

* **Model node**: linear model + entry array; entries are EMPTY, DATA,
  BUCKET-pointer or CHILD-pointer slots; keys sit at *precise* predicted
  positions (no local search in model nodes).
* **Bucket**: tiny conflict buffer (max size = tail conflict degree, clamped
  to a preset threshold, default <= 6).  Linear (default) or ordered mode.
* **Dense node**: gapped sorted array for locally indistinguishable keys
  (slope-0 fits).  Max gaps = tail conflict degree.
* **Modelling** (Alg 3.2): rebuild a full bucket / dense node into a model
  node; run-collection of consecutive over-conflicted slots into a shared
  child (duplicated node pointers).

NFL positions by *transformed* keys but answers queries on *original*
keys (the transform is deterministic, but f32 rounding can collide), so
every record carries both a positioning key ``pkey`` and an identity key
``ikey``; order and placement use pkey, equality uses ikey.  Standalone
(no flow), pkey == ikey.

Dense nodes keep an explicit occupancy mask instead of the paper's
fill-with-predecessor trick (the same semantics; the space accounting
counts the mask).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.conflict import (
    conflict_degrees,
    fit_linear_model,
    tail_conflict_degree,
)

__all__ = ["AFLI", "AFLIConfig", "AFLIStats"]

EMPTY, DATA, BUCKET, CHILD = 0, 1, 2, 3


@dataclasses.dataclass(frozen=True)
class AFLIConfig:
    gamma: float = 0.99          # tail percent for the tail conflict degree
    max_bucket: int = 6          # preset threshold range cap (paper §4.1.3)
    min_bucket: int = 2
    alpha: float = 1.2           # space amplification factor (Alg 3.2 line 7)
    ordered_buckets: bool = False
    dense_fallback: int = 16     # below this size a degenerate fit -> dense


class _Bucket:
    __slots__ = ("pkeys", "ikeys", "payloads", "cap", "ordered")

    def __init__(self, cap: int, ordered: bool):
        self.pkeys: List[float] = []
        self.ikeys: List[float] = []
        self.payloads: List[int] = []
        self.cap = cap
        self.ordered = ordered

    def full(self) -> bool:
        return len(self.pkeys) >= self.cap

    def insert(self, pk: float, ik: float, pv: int) -> None:
        if self.ordered:
            # insertion-sort by pkey (paper: "ordered mode")
            lo = 0
            while lo < len(self.pkeys) and self.pkeys[lo] < pk:
                lo += 1
            self.pkeys.insert(lo, pk)
            self.ikeys.insert(lo, ik)
            self.payloads.insert(lo, pv)
        else:
            self.pkeys.append(pk)
            self.ikeys.append(ik)
            self.payloads.append(pv)

    def lookup(self, ik: float) -> Optional[int]:
        for i, k in enumerate(self.ikeys):
            if k == ik:
                return self.payloads[i]
        return None

    def delete(self, ik: float) -> bool:
        for i, k in enumerate(self.ikeys):
            if k == ik:
                del self.pkeys[i]
                del self.ikeys[i]
                del self.payloads[i]
                return True
        return False

    def size_bytes(self) -> int:
        return 24 * self.cap + 16


class _DenseNode:
    """Ordered, gapped array. Binary search by pkey."""

    __slots__ = ("pkeys", "ikeys", "payloads", "occ", "n")

    def __init__(self, pk: np.ndarray, ik: np.ndarray, pv: np.ndarray, gaps: int):
        n = pk.shape[0]
        size = n + max(int(gaps), 1)
        self.pkeys = np.empty(size, dtype=np.float64)
        self.ikeys = np.empty(size, dtype=np.float64)
        self.payloads = np.empty(size, dtype=np.int64)
        self.occ = np.zeros(size, dtype=bool)
        # place keys evenly gapped (Alg 3.2 line 4)
        slots = np.floor(np.linspace(0, size - 1, num=n)).astype(np.int64) if n else np.empty(0, np.int64)
        self.pkeys[slots] = pk
        self.ikeys[slots] = ik
        self.payloads[slots] = pv
        self.occ[slots] = True
        self.n = n

    def full(self) -> bool:
        return self.n >= self.occ.shape[0]

    def _search(self, pk: float) -> int:
        """Index of first occupied slot with pkey >= pk (dense rank search)."""
        occ_idx = np.flatnonzero(self.occ)
        vals = self.pkeys[occ_idx]
        j = int(np.searchsorted(vals, pk, side="left"))
        return j, occ_idx, vals

    def lookup(self, pk: float, ik: float) -> Optional[int]:
        j, occ_idx, vals = self._search(pk)
        # scan the run of equal pkeys comparing identity keys
        while j < vals.shape[0] and vals[j] == pk:
            slot = occ_idx[j]
            if self.ikeys[slot] == ik:
                return int(self.payloads[slot])
            j += 1
        return None

    def insert(self, pk: float, ik: float, pv: int) -> bool:
        """Returns False when full (caller must Modelling-rebuild)."""
        if self.full():
            return False
        size = self.occ.shape[0]
        j, occ_idx, vals = self._search(pk)
        # target = physical slot of the successor key; `size` when the new
        # key goes after everything (conceptual one-past-the-end)
        if j < occ_idx.shape[0]:
            target = int(occ_idx[j])
        else:
            target = int(occ_idx[-1]) + 1 if occ_idx.size else 0
        if target < size and not self.occ[target]:
            self._write(target, pk, ik, pv)
            return True
        # shift towards the nearest gap (paper: "shift the data to the
        # closest empty slot, then insert")
        free = np.flatnonzero(~self.occ)
        if free.size == 0:
            return False
        nearest = int(free[np.argmin(np.abs(free - min(target, size - 1)))])
        if nearest > target:
            # gap right of the successor: move [target, nearest) right one,
            # the new key takes the successor's old slot
            sl = slice(target, nearest)
            self.pkeys[target + 1 : nearest + 1] = self.pkeys[sl]
            self.ikeys[target + 1 : nearest + 1] = self.ikeys[sl]
            self.payloads[target + 1 : nearest + 1] = self.payloads[sl]
            self.occ[target + 1 : nearest + 1] = self.occ[sl]
            self._write(target, pk, ik, pv)
        else:
            # gap left of the predecessors: slide (nearest, target) left one
            # and place the new key at target-1 (for target == size this
            # slides the whole occupied tail, freeing the last slot)
            sl = slice(nearest + 1, target)
            self.pkeys[nearest : target - 1] = self.pkeys[sl]
            self.ikeys[nearest : target - 1] = self.ikeys[sl]
            self.payloads[nearest : target - 1] = self.payloads[sl]
            self.occ[nearest : target - 1] = self.occ[sl]
            self._write(target - 1, pk, ik, pv)
        return True

    def _write(self, slot: int, pk: float, ik: float, pv: int) -> None:
        self.pkeys[slot] = pk
        self.ikeys[slot] = ik
        self.payloads[slot] = pv
        self.occ[slot] = True
        self.n += 1

    def delete(self, pk: float, ik: float) -> bool:
        j, occ_idx, vals = self._search(pk)
        while j < vals.shape[0] and vals[j] == pk:
            slot = occ_idx[j]
            if self.ikeys[slot] == ik:
                self.occ[slot] = False
                self.n -= 1
                return True
            j += 1
        return False

    def export(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        idx = np.flatnonzero(self.occ)
        return self.pkeys[idx], self.ikeys[idx], self.payloads[idx]

    def size_bytes(self) -> int:
        return self.occ.shape[0] * 25 + 16


class _ModelNode:
    __slots__ = ("slope", "intercept", "size", "etype", "pkeys", "ikeys",
                 "payloads", "ptrs")

    def __init__(self, slope: float, intercept: float, size: int):
        self.slope = slope
        self.intercept = intercept
        self.size = size
        self.etype = np.zeros(size, dtype=np.uint8)
        self.pkeys = np.zeros(size, dtype=np.float64)
        self.ikeys = np.zeros(size, dtype=np.float64)
        self.payloads = np.zeros(size, dtype=np.int64)
        self.ptrs: List[object] = [None] * size

    def predict(self, pk: float) -> int:
        pos = int(np.rint(self.slope * pk + self.intercept))
        if pos < 0:
            return 0
        if pos >= self.size:
            return self.size - 1
        return pos

    def size_bytes(self) -> int:
        return self.size * 33 + 32


class AFLIStats:
    def __init__(self):
        self.height = 0
        self.n_model = 0
        self.n_dense = 0
        self.n_bucket = 0
        self.n_data_slots = 0
        self.n_empty_slots = 0
        self.size_bytes = 0

    def as_dict(self):
        return dict(height=self.height, n_model=self.n_model,
                    n_dense=self.n_dense, n_bucket=self.n_bucket,
                    n_data_slots=self.n_data_slots,
                    n_empty_slots=self.n_empty_slots,
                    size_bytes=self.size_bytes)


class AFLI:
    """After-Flow Learned Index over (pkey, ikey, payload) records."""

    def __init__(self, config: AFLIConfig | None = None):
        self.cfg = config or AFLIConfig()
        self.root: object | None = None
        self.d_tail: int = self.cfg.min_bucket
        self.n_keys: int = 0

    # ------------------------------------------------------------- bulkload
    def bulkload(
        self,
        pkeys: np.ndarray,
        payloads: np.ndarray,
        ikeys: np.ndarray | None = None,
    ) -> None:
        pk = np.asarray(pkeys, dtype=np.float64)
        pv = np.asarray(payloads, dtype=np.int64)
        ik = pk.copy() if ikeys is None else np.asarray(ikeys, dtype=np.float64)
        order = np.argsort(pk, kind="stable")
        pk, ik, pv = pk[order], ik[order], pv[order]
        self.n_keys = pk.shape[0]
        # tail conflict degree from the global fit (paper BulkLoad op)
        if pk.shape[0] >= 2:
            model = fit_linear_model(pk)
            if model.slope > 0:
                d = tail_conflict_degree(conflict_degrees(pk, model), self.cfg.gamma)
            else:
                d = self.cfg.max_bucket
        else:
            d = self.cfg.min_bucket
        self.d_tail = int(np.clip(d, self.cfg.min_bucket, self.cfg.max_bucket))
        self.root = self._modelling(pk, ik, pv)

    # ------------------------------------------------------------ modelling
    def _modelling(self, pk: np.ndarray, ik: np.ndarray, pv: np.ndarray,
                   depth: int = 0) -> object:
        """Alg 3.2. Inputs sorted by pkey."""
        n = pk.shape[0]
        cfg = self.cfg
        if n == 0:
            return _DenseNode(pk, ik, pv, gaps=self.d_tail)
        # scaled positions: spread ranks by the space amplification factor
        model = fit_linear_model(pk, positions=np.arange(n, dtype=np.float64) * cfg.alpha)
        if model.slope <= 0.0 or n < 2:
            return _DenseNode(pk, ik, pv, gaps=self.d_tail)
        pred = np.rint(model(pk)).astype(np.int64)
        first, last = int(pred[0]), int(pred[-1])
        if last == first:
            # all keys mapped to one position (Alg 3.2 line 2)
            return _DenseNode(pk, ik, pv, gaps=self.d_tail)
        size = min(max(int(np.floor(n * cfg.alpha)), 2), last - first + 1)
        # compress model into [0, size)
        scale = (size - 1) / (last - first)
        slope = model.slope * scale
        intercept = (model.intercept - first) * scale
        node = _ModelNode(slope, intercept, size)
        pred = np.clip(np.rint(slope * pk + intercept).astype(np.int64), 0, size - 1)
        # conflict degrees per final slot
        slots, counts = np.unique(pred, return_counts=True)
        i = 0  # running index into pk (keys sorted -> slots nondecreasing)
        s = 0
        while s < slots.shape[0]:
            slot = int(slots[s])
            d = int(counts[s])
            if d == 1:
                node.etype[slot] = DATA
                node.pkeys[slot] = pk[i]
                node.ikeys[slot] = ik[i]
                node.payloads[slot] = pv[i]
                i += 1
                s += 1
            elif d < self.d_tail:
                b = _Bucket(self.d_tail, cfg.ordered_buckets)
                for j in range(i, i + d):
                    b.insert(pk[j], ik[j], pv[j])
                node.etype[slot] = BUCKET
                node.ptrs[slot] = b
                i += d
                s += 1
            else:
                # run-collect consecutive over-conflicted slots (lines 18-22)
                run_end = s + 1
                total = d
                while (
                    run_end < slots.shape[0]
                    and int(slots[run_end]) == int(slots[run_end - 1]) + 1
                    and int(counts[run_end]) >= self.d_tail
                ):
                    total += int(counts[run_end])
                    run_end += 1
                sub_pk = pk[i : i + total]
                sub_ik = ik[i : i + total]
                sub_pv = pv[i : i + total]
                if total == n or depth > 64:
                    # the run covers every key in this node: recursing would
                    # refit the same model on the same keys forever.  Buffer
                    # them in a dense node instead (guard; DESIGN.md §8).
                    child = _DenseNode(sub_pk, sub_ik, sub_pv, gaps=self.d_tail)
                else:
                    child = self._modelling(sub_pk, sub_ik, sub_pv, depth + 1)
                last_slot = int(slots[run_end - 1])
                for p in range(slot, last_slot + 1):
                    node.etype[p] = CHILD
                    node.ptrs[p] = child  # duplicated node pointers
                i += total
                s = run_end
        return node

    # -------------------------------------------------------------- lookup
    def lookup(self, pkey: float, ikey: float | None = None) -> Optional[int]:
        ik = pkey if ikey is None else ikey
        node = self.root
        while node is not None:
            if isinstance(node, _ModelNode):
                slot = node.predict(pkey)
                t = node.etype[slot]
                if t == EMPTY:
                    return None
                if t == DATA:
                    return int(node.payloads[slot]) if node.ikeys[slot] == ik else None
                if t == BUCKET:
                    return node.ptrs[slot].lookup(ik)
                node = node.ptrs[slot]
            else:  # dense
                return node.lookup(pkey, ik)
        return None

    # -------------------------------------------------------------- insert
    def insert(self, pkey: float, payload: int, ikey: float | None = None) -> None:
        ik = pkey if ikey is None else ikey
        if self.root is None:
            self.root = _DenseNode(
                np.array([pkey]), np.array([ik]), np.array([payload], dtype=np.int64),
                gaps=self.d_tail,
            )
            self.n_keys = 1
            return
        self.root = self._insert_into(self.root, pkey, ik, payload)
        self.n_keys += 1

    def _insert_into(self, node: object, pk: float, ik: float, pv: int) -> object:
        """Insert and return the (possibly replaced) node."""
        if isinstance(node, _DenseNode):
            if node.insert(pk, ik, pv):
                return node
            # full: Modelling rebuild with the new key merged in (Fig 6)
            opk, oik, opv = node.export()
            j = int(np.searchsorted(opk, pk))
            npk = np.insert(opk, j, pk)
            nik = np.insert(oik, j, ik)
            npv = np.insert(opv, j, pv)
            return self._modelling(npk, nik, npv)

        assert isinstance(node, _ModelNode)
        slot = node.predict(pk)
        t = node.etype[slot]
        if t == EMPTY:
            node.etype[slot] = DATA
            node.pkeys[slot] = pk
            node.ikeys[slot] = ik
            node.payloads[slot] = pv
            return node
        if t == DATA:
            if node.ikeys[slot] == ik:  # unique keys: overwrite payload
                node.payloads[slot] = pv
                return node
            b = _Bucket(self.d_tail, self.cfg.ordered_buckets)
            b.insert(node.pkeys[slot], node.ikeys[slot], int(node.payloads[slot]))
            b.insert(pk, ik, pv)
            node.etype[slot] = BUCKET
            node.ptrs[slot] = b
            return node
        if t == BUCKET:
            b: _Bucket = node.ptrs[slot]
            if not b.full():
                b.insert(pk, ik, pv)
                return node
            # Modelling the bucket into a child model node (Fig 6)
            bpk = np.array(b.pkeys + [pk], dtype=np.float64)
            bik = np.array(b.ikeys + [ik], dtype=np.float64)
            bpv = np.array(b.payloads + [pv], dtype=np.int64)
            order = np.argsort(bpk, kind="stable")
            child = self._modelling(bpk[order], bik[order], bpv[order])
            node.etype[slot] = CHILD
            node.ptrs[slot] = child
            return node
        # CHILD: recurse; replacement must be written through all duplicated
        # pointer slots (paper: duplicated node pointers share one child)
        child = node.ptrs[slot]
        new_child = self._insert_into(child, pk, ik, pv)
        if new_child is not child:
            for p in range(node.size):
                if node.ptrs[p] is child:
                    node.ptrs[p] = new_child
        return node

    # ------------------------------------------------------- update/delete
    def update(self, pkey: float, payload: int, ikey: float | None = None) -> bool:
        ik = pkey if ikey is None else ikey
        node = self.root
        while node is not None:
            if isinstance(node, _ModelNode):
                slot = node.predict(pkey)
                t = node.etype[slot]
                if t == EMPTY:
                    return False
                if t == DATA:
                    if node.ikeys[slot] == ik:
                        node.payloads[slot] = payload
                        return True
                    return False
                if t == BUCKET:
                    b = node.ptrs[slot]
                    for i, k in enumerate(b.ikeys):
                        if k == ik:
                            b.payloads[i] = payload
                            return True
                    return False
                node = node.ptrs[slot]
            else:
                j, occ_idx, vals = node._search(pkey)
                while j < vals.shape[0] and vals[j] == pkey:
                    slot = occ_idx[j]
                    if node.ikeys[slot] == ik:
                        node.payloads[slot] = payload
                        return True
                    j += 1
                return False
        return False

    def delete(self, pkey: float, ikey: float | None = None) -> bool:
        ik = pkey if ikey is None else ikey
        node = self.root
        while node is not None:
            if isinstance(node, _ModelNode):
                slot = node.predict(pkey)
                t = node.etype[slot]
                if t == EMPTY:
                    return False
                if t == DATA:
                    if node.ikeys[slot] == ik:
                        node.etype[slot] = EMPTY
                        self.n_keys -= 1
                        return True
                    return False
                if t == BUCKET:
                    ok = node.ptrs[slot].delete(ik)
                    if ok:
                        self.n_keys -= 1
                    return ok
                node = node.ptrs[slot]
            else:
                ok = node.delete(pkey, ik)
                if ok:
                    self.n_keys -= 1
                return ok
        return False

    # --------------------------------------------------------------- stats
    def stats(self) -> AFLIStats:
        st = AFLIStats()

        def walk(node, depth):
            st.height = max(st.height, depth)
            if isinstance(node, _DenseNode):
                st.n_dense += 1
                st.size_bytes += node.size_bytes()
                return
            st.n_model += 1
            st.size_bytes += node.size_bytes()
            seen = set()
            for slot in range(node.size):
                t = node.etype[slot]
                if t == EMPTY:
                    st.n_empty_slots += 1
                elif t == DATA:
                    st.n_data_slots += 1
                elif t == BUCKET:
                    st.n_bucket += 1
                    st.size_bytes += node.ptrs[slot].size_bytes()
                elif t == CHILD:
                    child = node.ptrs[slot]
                    if id(child) not in seen:
                        seen.add(id(child))
                        walk(child, depth + 1)

        if self.root is not None:
            walk(self.root, 1)
        return st
