"""Paged KV cache: fixed-size pages + the NFL page table.

Port of ``repro.serve.kv_cache``.  The pools are device tensors
[L, n_pages, page, KH, Dh] on the cache's device (the card unless the
caller asks for the CPU); the host-side allocator hands out pages from a
free list and registers the ``(seq, block) -> page`` mapping in an
``NFLPageTable`` on the same device.  ``gather_kv`` materialises a
sequence's logically contiguous view: one batched page-table lookup,
then one ``index_select`` along the page axis of each pool.  ``append``
writes one token's K/V [L, KH, Dh] in place.

On a mesh (``mesh=``) the pools are placed by the model's
``decode_state_specs``: ``kv_heads`` over ``model`` where the heads
divide (``guarded_spec``), and ``batch`` over the data axes, which here
means that each data rank's cache holds the pages of the sequences it
serves.  A rank keeps only its shard: ``kv_heads`` counts its heads and
``append`` takes its heads' K/V.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.kernels.backend import resolve_device
from repro_torch.serve.prefix_cache import NFLPageTable, composite_key

__all__ = ["PagedKVCache", "PagedKVConfig"]


@dataclasses.dataclass(frozen=True)
class PagedKVConfig:
    n_pages: int
    page_size: int = 64
    n_layers: int = 2
    kv_heads: int = 2
    head_dim: int = 32
    dtype: torch.dtype = torch.bfloat16


class PagedKVCache:
    def __init__(self, cfg: PagedKVConfig,
                 device: Optional[Union[str, torch.device]] = None,
                 mesh=None):
        if mesh is not None:
            from repro_torch.dist.sharding import NamedSharding, guarded_spec

            shape = (cfg.n_layers, cfg.n_pages, cfg.page_size,
                     cfg.kv_heads, cfg.head_dim)
            spec = guarded_spec(shape, (None, None, None, "kv_heads", None),
                                mesh)
            cfg = dataclasses.replace(cfg, kv_heads=NamedSharding(
                mesh, spec).local_shape(shape)[3])
        self.cfg = cfg
        self.mesh = mesh
        self.device = resolve_device(device)
        shape = (cfg.n_layers, cfg.n_pages, cfg.page_size, cfg.kv_heads,
                 cfg.head_dim)
        self.k_pool = torch.zeros(shape, dtype=cfg.dtype, device=self.device)
        self.v_pool = torch.zeros(shape, dtype=cfg.dtype, device=self.device)
        self._free: List[int] = list(range(cfg.n_pages - 1, -1, -1))
        self.table = NFLPageTable(device=self.device)
        self._seq_blocks: Dict[int, List[int]] = {}  # seq -> pages, ordered
        self._seq_len: Dict[int, int] = {}

    # ----------------------------------------------------------- allocation
    def free_pages(self) -> int:
        return len(self._free)

    def register_sequence(self, seq_id: int) -> None:
        self._seq_blocks.setdefault(seq_id, [])
        self._seq_len.setdefault(seq_id, 0)

    def _grow(self, seq_id: int, new_len: int) -> None:
        blocks = self._seq_blocks[seq_id]
        need = (new_len + self.cfg.page_size - 1) // self.cfg.page_size
        new_keys, new_pages = [], []
        while len(blocks) < need:
            if not self._free:
                raise MemoryError("KV page pool exhausted")
            page = self._free.pop()
            new_keys.append(composite_key(
                np.array([seq_id]), np.array([len(blocks)]))[0])
            new_pages.append(page)
            blocks.append(page)
        if new_pages:
            self.table.insert(np.asarray(new_keys), np.asarray(new_pages))
        self._seq_len[seq_id] = new_len

    def append(self, seq_id: int, layer_k: torch.Tensor,
               layer_v: torch.Tensor) -> None:
        """Append one token's K/V ([L, KH, Dh]) to a sequence."""
        pos = self._seq_len[seq_id]
        self._grow(seq_id, pos + 1)
        page = self._seq_blocks[seq_id][pos // self.cfg.page_size]
        slot = pos % self.cfg.page_size
        self.k_pool[:, page, slot] = layer_k.to(self.device, self.cfg.dtype)
        self.v_pool[:, page, slot] = layer_v.to(self.device, self.cfg.dtype)

    def release(self, seq_id: int) -> None:
        for page in self._seq_blocks.pop(seq_id, []):
            self._free.append(page)
        self._seq_len.pop(seq_id, None)
        # page-table entries become stale; the NFL index tolerates stale
        # payloads (identity keys are never reused: seq ids are monotonic)

    # -------------------------------------------------------------- access
    def lookup_pages(self, seq_id: int, n_blocks: int) -> np.ndarray:
        """Batched NFL page-table probe for a sequence's first n blocks."""
        keys = composite_key(np.full(n_blocks, seq_id), np.arange(n_blocks))
        return self.table.lookup(keys)

    def gather_kv(self, seq_id: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """Contiguous [L, len, KH, Dh] view of a sequence's cache."""
        c = self.cfg
        n = self._seq_len[seq_id]
        if n == 0:
            z = torch.zeros((c.n_layers, 0, c.kv_heads, c.head_dim),
                            dtype=c.dtype, device=self.device)
            return z, z, 0
        n_blocks = (n + c.page_size - 1) // c.page_size
        pages = self.lookup_pages(seq_id, n_blocks)
        if (pages < 0).any():
            raise RuntimeError(f"page table lost a mapping of sequence "
                               f"{seq_id}")
        idx = torch.as_tensor(pages, dtype=torch.int64, device=self.device)
        out = []
        for pool in (self.k_pool, self.v_pool):
            out.append(pool.index_select(1, idx).reshape(
                c.n_layers, -1, c.kv_heads, c.head_dim)[:, :n])
        return out[0], out[1], n

    def stats(self) -> dict:
        return {
            "free_pages": len(self._free),
            "used_pages": self.cfg.n_pages - len(self._free),
            "sequences": len(self._seq_blocks),
            "table": self.table.stats(),
        }
