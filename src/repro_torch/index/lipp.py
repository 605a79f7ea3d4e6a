"""LIPP-like baseline (Wu et al., VLDB 2021), simplified.

LIPP places every key at its precisely predicted position and resolves any
conflict by *immediately creating a child node* — no buckets, no local
search.  We realize this as the AFLI machinery with the tail conflict degree
pinned to 2: conflict degree 1 -> data slot, >= 2 -> child node.  The one
deviation (noted in DESIGN.md) is that a fresh 2-key conflict transits
through a capacity-2 bucket for exactly one insert before becoming a node;
structurally the resulting trees match LIPP's (deep on high-conflict data —
which is precisely the behaviour the NFL paper contrasts against).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.afli import AFLI, AFLIConfig
from repro_torch.index.base import BaseIndex

__all__ = ["LIPPIndex"]


class LIPPIndex(BaseIndex):
    name = "lipp"

    def __init__(self, alpha: float = 1.2):
        self._afli = AFLI(AFLIConfig(max_bucket=2, min_bucket=2, alpha=alpha))

    def bulkload(self, keys: np.ndarray, payloads: np.ndarray) -> None:
        self._afli.bulkload(np.asarray(keys, np.float64), np.asarray(payloads, np.int64))

    def lookup(self, key: float) -> Optional[int]:
        return self._afli.lookup(key)

    def insert(self, key: float, payload: int) -> None:
        self._afli.insert(key, payload)

    def delete(self, key: float) -> bool:
        return self._afli.delete(key)

    def size_bytes(self) -> int:
        return self._afli.stats().size_bytes

    def stats(self):
        st = self._afli.stats().as_dict()
        return {k: float(v) for k, v in st.items()}
