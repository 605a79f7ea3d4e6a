"""B+Tree baseline (paper baseline #4: Google cpp-btree stand-in).

Array-based nodes (numpy key arrays + python child lists), bottom-up
bulkload, top-down search with ``searchsorted``, leaf splits on insert.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from repro_torch.index.base import BaseIndex

__all__ = ["BTree"]

ORDER = 64  # max keys per node


class _Leaf:
    __slots__ = ("keys", "payloads")

    def __init__(self, keys: np.ndarray, payloads: np.ndarray):
        self.keys = keys
        self.payloads = payloads


class _Inner:
    __slots__ = ("keys", "children")

    def __init__(self, keys: np.ndarray, children: List[object]):
        # children[i] covers keys < keys[i] <= children[i+1]
        self.keys = keys
        self.children = children


class BTree(BaseIndex):
    name = "btree"

    def __init__(self, order: int = ORDER):
        self.order = order
        self.root: object | None = None
        self.height = 0
        self.n_keys = 0

    def bulkload(self, keys: np.ndarray, payloads: np.ndarray) -> None:
        keys = np.asarray(keys, dtype=np.float64)
        payloads = np.asarray(payloads, dtype=np.int64)
        order_idx = np.argsort(keys, kind="stable")
        keys, payloads = keys[order_idx], payloads[order_idx]
        self.n_keys = keys.shape[0]
        fill = max(self.order // 2, 1)
        leaves: List[object] = [
            _Leaf(keys[i : i + fill].copy(), payloads[i : i + fill].copy())
            for i in range(0, keys.shape[0], fill)
        ] or [_Leaf(np.empty(0, np.float64), np.empty(0, np.int64))]
        level: List[object] = leaves
        seps = [l.keys[0] for l in leaves]
        self.height = 1
        while len(level) > 1:
            nxt, nxt_seps = [], []
            for i in range(0, len(level), fill):
                group = level[i : i + fill]
                gseps = seps[i : i + fill]
                nxt.append(_Inner(np.asarray(gseps[1:], dtype=np.float64), group))
                nxt_seps.append(gseps[0])
            level, seps = nxt, nxt_seps
            self.height += 1
        self.root = level[0]

    def _find_leaf(self, key: float) -> _Leaf:
        node = self.root
        while isinstance(node, _Inner):
            j = int(np.searchsorted(node.keys, key, side="right"))
            node = node.children[j]
        return node

    def lookup(self, key: float) -> Optional[int]:
        leaf = self._find_leaf(key)
        j = int(np.searchsorted(leaf.keys, key, side="left"))
        if j < leaf.keys.shape[0] and leaf.keys[j] == key:
            return int(leaf.payloads[j])
        return None

    def insert(self, key: float, payload: int) -> None:
        if self.root is None:
            self.root = _Leaf(np.array([key]), np.array([payload], dtype=np.int64))
            self.height = 1
            self.n_keys = 1
            return
        path: List[_Inner] = []
        slots: List[int] = []
        node = self.root
        while isinstance(node, _Inner):
            j = int(np.searchsorted(node.keys, key, side="right"))
            path.append(node)
            slots.append(j)
            node = node.children[j]
        leaf: _Leaf = node
        j = int(np.searchsorted(leaf.keys, key, side="left"))
        if j < leaf.keys.shape[0] and leaf.keys[j] == key:
            leaf.payloads[j] = payload
            return
        leaf.keys = np.insert(leaf.keys, j, key)
        leaf.payloads = np.insert(leaf.payloads, j, payload)
        self.n_keys += 1
        if leaf.keys.shape[0] <= self.order:
            return
        # split the leaf and propagate
        mid = leaf.keys.shape[0] // 2
        right = _Leaf(leaf.keys[mid:].copy(), leaf.payloads[mid:].copy())
        sep = float(right.keys[0])
        leaf.keys = leaf.keys[:mid].copy()
        leaf.payloads = leaf.payloads[:mid].copy()
        child: object = right
        while path:
            parent = path.pop()
            j = slots.pop()
            parent.keys = np.insert(parent.keys, j, sep)
            parent.children.insert(j + 1, child)
            if parent.keys.shape[0] <= self.order:
                return
            mid = parent.keys.shape[0] // 2
            sep_new = float(parent.keys[mid])
            rnode = _Inner(parent.keys[mid + 1 :].copy(), parent.children[mid + 1 :])
            parent.keys = parent.keys[:mid].copy()
            parent.children = parent.children[: mid + 1]
            child, sep = rnode, sep_new
        self.root = _Inner(np.array([sep], dtype=np.float64), [self.root, child])
        self.height += 1

    def delete(self, key: float) -> bool:
        leaf = self._find_leaf(key)
        j = int(np.searchsorted(leaf.keys, key, side="left"))
        if j < leaf.keys.shape[0] and leaf.keys[j] == key:
            leaf.keys = np.delete(leaf.keys, j)
            leaf.payloads = np.delete(leaf.payloads, j)
            self.n_keys -= 1
            return True  # no rebalancing on delete (lazy deletion)
        return False

    def size_bytes(self) -> int:
        total = 0
        stack = [self.root] if self.root is not None else []
        while stack:
            node = stack.pop()
            if isinstance(node, _Inner):
                total += node.keys.nbytes + 8 * len(node.children) + 16
                stack.extend(node.children)
            else:
                total += node.keys.nbytes + node.payloads.nbytes + 16
        return total

    def stats(self):
        return {"height": float(self.height), "size_bytes": float(self.size_bytes())}
