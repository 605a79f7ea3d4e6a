"""Common interface for all indexes benchmarked against NFL.

Every index exposes batched operations over (key: f64, payload: i64)
records — the same surface the paper's harness drives.  ``lookup_batch``
returns -1 for missing keys.
"""

from __future__ import annotations

import abc
from typing import Dict

import numpy as np

__all__ = ["BaseIndex"]


class BaseIndex(abc.ABC):
    name: str = "base"

    @abc.abstractmethod
    def bulkload(self, keys: np.ndarray, payloads: np.ndarray) -> None:
        ...

    @abc.abstractmethod
    def lookup(self, key: float) -> int | None:
        ...

    @abc.abstractmethod
    def insert(self, key: float, payload: int) -> None:
        ...

    def lookup_batch(self, keys: np.ndarray) -> np.ndarray:
        out = np.empty(len(keys), dtype=np.int64)
        lk = self.lookup
        for i, k in enumerate(keys):
            r = lk(float(k))
            out[i] = -1 if r is None else r
        return out

    def insert_batch(self, keys: np.ndarray, payloads: np.ndarray) -> None:
        ins = self.insert
        for k, v in zip(keys, payloads):
            ins(float(k), int(v))

    def stats(self) -> Dict[str, float]:
        return {}

    def size_bytes(self) -> int:
        return 0
