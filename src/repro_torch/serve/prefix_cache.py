"""NFL-backed page table / prefix-cache lookup, PyTorch.

Port of ``repro.serve.prefix_cache``.  A paged KV cache needs a map
``(sequence, block) -> physical page``.  The lookup key is built the way
the paper builds its hardest dataset (longlat:
``180*floor(longitude)+latitude``): a *composite* numeric key
``seq_id * MAX_BLOCKS + block_no``.  Session ids come in bursts and block
numbers are small and dense, so the keys are heavily clustered, the
regime where the Numerical NF helps and plain learned indexes degrade
(paper Table 1).

For prefix *content* reuse the same index maps 64-bit prefix hashes
(near-uniform: the paper's switching mechanism declines the flow for
those).

The flow trains on the table's device and positions keys through
``core.flow.transform_keys`` (f32 flow on the params' device, f64 sum
decode on the host), as the reference does.  ``FlatAFLI`` serves each
``lookup`` call on its flow-off rung, positioned by the f32 of those
keys: one ``fused_lookup`` launch per call on the card.  Inserts are
log-structured with amortized rebuilds, and every ``retrain_every``-th
rebuild re-fits the flow.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.core.conflict import should_use_flow
from repro_torch.core.flat_afli import FlatAFLI, FlatAFLIConfig
from repro_torch.core.flow import FlowConfig, transform_keys
from repro_torch.core.train_flow import FlowTrainConfig, train_flow
from repro_torch.kernels.backend import resolve_device

__all__ = ["NFLPageTable", "composite_key", "prefix_hash", "MAX_BLOCKS"]

MAX_BLOCKS = 1 << 20


def composite_key(seq_ids: np.ndarray, block_nos: np.ndarray) -> np.ndarray:
    """(seq, block) -> composite f64 key (exact for seq_id < 2^32)."""
    return (np.asarray(seq_ids, np.float64) * MAX_BLOCKS
            + np.asarray(block_nos, np.float64))


def prefix_hash(tokens: np.ndarray) -> float:
    """FNV-1a over a token block -> f64-representable 53-bit key."""
    h = np.uint64(0xCBF29CE484222325)
    for t in np.asarray(tokens, np.uint64).ravel():
        h = np.uint64((int(h) ^ int(t)) * 0x100000001B3 & 0xFFFFFFFFFFFFFFFF)
    return float(int(h) >> 11)  # 53 bits: exact in f64


@dataclasses.dataclass
class _FlowState:
    params: dict
    normalizer: object
    cfg: FlowConfig
    enabled: bool


class NFLPageTable:
    """Two-stage NFL (Numerical NF + FlatAFLI) over page-table keys, on
    ``device`` (the card unless the caller asks for the CPU)."""

    def __init__(self, flow_cfg: Optional[FlowConfig] = None,
                 index_cfg: Optional[FlatAFLIConfig] = None,
                 retrain_every: int = 8,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self.flow_cfg = flow_cfg or FlowConfig()
        self.index = FlatAFLI(index_cfg or FlatAFLIConfig(),
                              device=self.device)
        self._flow: Optional[_FlowState] = None
        self._keys = np.empty(0, np.float64)
        self._pages = np.empty(0, np.int64)
        self._retrain_every = retrain_every
        self._builds = 0

    # ------------------------------------------------------------- fitting
    def bulkload(self, keys: np.ndarray, pages: np.ndarray) -> None:
        keys = np.asarray(keys, np.float64)
        pages = np.asarray(pages, np.int64)
        self._keys, self._pages = keys, pages
        params, norm, _ = train_flow(
            keys, self.flow_cfg,
            FlowTrainConfig(epochs=1,
                            sample_frac=min(1.0, 65536 / max(len(keys), 1))),
            device=self.device)
        z = transform_keys(params, norm, keys, self.flow_cfg)
        use, _, _ = should_use_flow(keys, z)
        self._flow = _FlowState(params, norm, self.flow_cfg, bool(use))
        if use:
            self.index.build(z, pages, ikeys=keys)
        else:
            self.index.build(keys, pages)
        self._builds += 1

    def _transform(self, keys: np.ndarray) -> np.ndarray:
        if self._flow is not None and self._flow.enabled:
            return transform_keys(self._flow.params, self._flow.normalizer,
                                  keys, self._flow.cfg)
        return np.asarray(keys, np.float64)

    # ------------------------------------------------------------- queries
    def lookup(self, keys: np.ndarray) -> np.ndarray:
        """Batched page lookup, one point-read launch; -1 = miss."""
        keys = np.asarray(keys, np.float64)
        if self.index.arrays is None:
            return np.full(keys.shape[0], -1, np.int64)
        pk = self._transform(keys)
        if self._flow is not None and self._flow.enabled:
            return self.index.lookup_batch(pk, ikeys=keys)
        return self.index.lookup_batch(pk)

    def insert(self, keys: np.ndarray, pages: np.ndarray) -> None:
        keys = np.asarray(keys, np.float64)
        pages = np.asarray(pages, np.int64)
        self._keys = np.concatenate([self._keys, keys])
        self._pages = np.concatenate([self._pages, pages])
        if self.index.arrays is None:
            self.bulkload(self._keys, self._pages)
            return
        pk = self._transform(keys)
        if self._flow is not None and self._flow.enabled:
            self.index.insert_batch(pk, pages, ikeys=keys)
        else:
            self.index.insert_batch(pk, pages)
        # periodic re-fit of the flow on distribution shift
        if (self.index.n_rebuilds
                and self.index.n_rebuilds % self._retrain_every == 0):
            self.bulkload(self._keys, self._pages)

    def stats(self) -> dict:
        st = dict(self.index.stats())
        st["flow_enabled"] = bool(self._flow and self._flow.enabled)
        st["builds"] = self._builds
        return st
