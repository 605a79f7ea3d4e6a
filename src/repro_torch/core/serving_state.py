"""Device-resident serving state of one ``FlatAFLI``, PyTorch.

Port of ``repro.core.serving_state``:

* **pack once** — the tree pools are packed to kernel layout
  (``to_kernel_args``, exact sizes) and moved to the device once per
  build or fold (a fold packs its pools beside the old ones and swaps
  them in), never per call;
* **bucketed tiers** — the run and delta tiers and the range path's scan
  pool live in persistent device buffers sized to power-of-two
  capacities, with the live length in a device i32[1], so a tier that
  grows by appends is reallocated a logarithmic number of times.  A
  refresh writes the live prefix in place by slice assignment.  Rows
  past the live length hold ``+inf`` keys, so the kernel's fixed-round
  lower bound never lands in stale data.  ``preallocate`` pins each
  capacity from the write path's configured bounds at build and at fold
  swap, so a steady write window reallocates nothing.  The write path
  refreshes the tier it changed right away, so reads find every tier
  resident; the scan pool is refreshed only at build and fold swap;
* **one router per scan pool** — the streamed rung reads the scan
  pool's buffers and a router of its tile heads; the router is rebuilt
  only when the pool's buffers change (build, fold swap, capacity
  growth: the tier's ``generation``, which a counter reset leaves
  alone) and reused by every other read.

The traversal depth bound and the duplicate windows are passed to the
kernel as they are: the card compiles nothing per shape, so the JAX
package's ratchets (which only keep its traced shapes stable) have no
counterpart.

Counted throughout (uploads, bytes, repacks, pack reuse).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["ServingState", "DeviceTier", "pow2_bucket"]

_MIN_CAPACITY = 128


def pow2_bucket(n: int, floor: int = _MIN_CAPACITY) -> int:
    """Smallest power-of-two bucket >= max(n, floor)."""
    n = max(int(n), int(floor))
    return 1 << max(n - 1, 0).bit_length()


class DeviceTier:
    """One sorted write tier in a persistent bucketed device buffer:
    pk f32 (+inf padded) / hi i32 / lo i32 (identity bit views) / pv i32
    at bucket capacity, plus the live length as a device i32[1]."""

    def __init__(self, device: torch.device):
        self.device = device
        self.capacity = 0
        self.length = 0
        self.window = 1            # longest run of equal keys
        self.pk = self.hi = self.lo = self.pv = self.plen = None
        self.min_capacity = 0
        self.generation = 0        # bumped by every write; never reset
        self.uploads = 0
        self.upload_bytes = 0
        self.repacks = 0

    @property
    def iters(self) -> int:
        """Binary-search rounds covering the capacity bucket."""
        return max(self.capacity, 1).bit_length()

    def _alloc(self, cap: int) -> None:
        """(Re)allocate at capacity ``cap``, keeping the live rows."""
        dev = self.device
        old = (self.pk, self.hi, self.lo, self.pv)
        self.pk = torch.full((cap,), float("inf"), dtype=torch.float32,
                             device=dev)
        self.hi = torch.zeros(cap, dtype=torch.int32, device=dev)
        self.lo = torch.zeros(cap, dtype=torch.int32, device=dev)
        self.pv = torch.full((cap,), -1, dtype=torch.int32, device=dev)
        n = self.length if old[0] is not None else 0
        for new, prev in zip((self.pk, self.hi, self.lo, self.pv), old):
            if n:
                new[:n] = prev[:n]
        if self.plen is None:
            self.plen = torch.zeros(1, dtype=torch.int32, device=dev)
        self.capacity = cap
        self.generation += 1
        self.repacks += 1

    def refresh(self, pk: np.ndarray, hi: np.ndarray, lo: np.ndarray,
                pv: np.ndarray, window: int) -> None:
        """Adopt a new live tier state (sorted host mirror): an in-place
        prefix write within the bucket, a reallocation past it.  Rows
        that the old state used and the new one does not are reset to
        padding."""
        n = int(pk.shape[0])
        need = max(pow2_bucket(n + 1), self.min_capacity)
        self.window = int(window)
        if self.pk is None or need > self.capacity:
            self._alloc(max(need, self.capacity))
        m = max(n, self.length)
        ppk = np.full(m, np.inf, np.float32)
        ppk[:n] = pk
        phi = np.zeros(m, np.uint32)
        phi[:n] = hi
        plo = np.zeros(m, np.uint32)
        plo[:n] = lo
        ppv = np.full(m, -1, np.int32)
        ppv[:n] = pv
        if m:
            self.pk[:m] = torch.from_numpy(ppk).to(self.device)
            self.hi[:m] = torch.from_numpy(phi.view(np.int32)).to(self.device)
            self.lo[:m] = torch.from_numpy(plo.view(np.int32)).to(self.device)
            self.pv[:m] = torch.from_numpy(ppv).to(self.device)
        self.plen.fill_(n)
        self.length = n
        self.generation += 1
        self.uploads += 1
        self.upload_bytes += 16 * m + 4


_EMPTY = (np.empty(0, np.float32), np.empty(0, np.uint32),
          np.empty(0, np.uint32), np.empty(0, np.int32))


class ServingState:
    """Packed tree pools, the run and delta tiers and the scan pool of
    one ``FlatAFLI`` on one device."""

    def __init__(self, device: torch.device):
        self.device = device
        self.tree_pools = None
        self.run = DeviceTier(device)
        self.delta = DeviceTier(device)
        self.scan = DeviceTier(device)
        self.tree_packs = 0
        self.tier_reuses = 0
        self.scan_reuses = 0
        self._router = None
        self._router_for = None    # the scan pool's generation
        self.router_builds = 0
        self.stream_reuses = 0

    def pack_tree(self, arrays):
        """Pack a static structure's pools for the kernels (a fold packs
        its new pools here, beside the ones serving)."""
        self.tree_packs += 1
        return arrays.to_kernel_args(self.device)

    def set_tree(self, arrays, pools=None) -> None:
        """Adopt a (re)built static structure: pack it once, or take the
        pools a fold packed already."""
        self.tree_pools = self.pack_tree(arrays) if pools is None else pools

    def set_scan(self, pk, hi, lo, pv, window: int) -> None:
        """Adopt the (re)built structure's rank-ordered scan pool.  Called
        only at build and fold swap, off the serve path."""
        self.scan.refresh(pk, hi, lo, pv, window)

    def _scan_pool(self):
        """The scan tier's buffers as a ``ScanPool``; before the first
        build the pool is empty."""
        from repro_torch.kernels.range_scan import ScanPool

        if self.scan.pk is None:
            self.scan.refresh(*_EMPTY, window=1)
        s = self.scan
        return ScanPool(pk=s.pk, hi=s.hi, lo=s.lo, pv=s.pv, plen=s.plen)

    def scan_pack(self):
        """The resident ``ScanPack``; before the first build the pool is
        empty and every range resolves from the write tiers alone."""
        from repro_torch.kernels.range_scan import ScanPack

        pool = self._scan_pool()
        self.scan_reuses += 1
        return ScanPack(pool=pool, iters=self.scan.iters)

    def stream_pack(self):
        """The resident ``StreamPack``: the scan pool's buffers (shared
        with ``scan_pack``), its router and its window.  The router is
        rebuilt only when the pool's ``generation`` changes.
        Before the first build the pool is empty and every read resolves
        from the write tiers alone."""
        from repro_torch.kernels.streamed_lookup import (StreamPack,
                                                         build_router)

        pool = self._scan_pool()
        s = self.scan
        if self._router_for != s.generation:
            self._router = build_router(s.pk)
            self._router_for = s.generation
            self.router_builds += 1
        else:
            self.stream_reuses += 1
        return StreamPack(pool=pool, router=self._router, window=s.window)

    def preallocate(self, *, delta_floor: int, run_floor: int,
                    scan_floor: int) -> None:
        """Pin the capacity buckets from the write path's configured
        bounds and allocate them now, keeping live rows."""
        for t, floor in ((self.delta, delta_floor), (self.run, run_floor),
                         (self.scan, scan_floor)):
            t.min_capacity = max(t.min_capacity, pow2_bucket(floor))
            if t.pk is None:
                t.refresh(*_EMPTY, window=1)
            elif t.capacity < t.min_capacity:
                t._alloc(t.min_capacity)

    def reset_tiers(self) -> None:
        """Drop tier contents (new build); buffers stay."""
        for t in (self.run, self.delta):
            if t.pk is not None:
                t.refresh(*_EMPTY, window=1)

    def tier_pack(self):
        """The resident ``TierPack`` (None while both tiers are empty)."""
        from repro_torch.kernels.fused_lookup import TierPack, TierPools

        if not (self.run.length or self.delta.length):
            return None
        for t in (self.run, self.delta):
            if t.pk is None:
                t.refresh(*_EMPTY, window=1)
        self.tier_reuses += 1
        r, d = self.run, self.delta
        return TierPack(
            pools=TierPools(run_pk=r.pk, run_hi=r.hi, run_lo=r.lo,
                            run_pv=r.pv, run_len=r.plen,
                            dl_pk=d.pk, dl_hi=d.hi, dl_lo=d.lo,
                            dl_pv=d.pv, dl_len=d.plen),
            run_iters=r.iters, run_window=r.window,
            delta_iters=d.iters, delta_window=d.window)

    def reset_stats(self) -> None:
        """Zero the counters (packs, uploads, repacks, reuses, router
        builds); the gauges (capacities, windows, pool bytes) describe
        resident state and stay."""
        for t in (self.run, self.delta, self.scan):
            t.uploads = t.upload_bytes = t.repacks = 0
        self.tree_packs = 0
        self.tier_reuses = 0
        self.scan_reuses = 0
        self.router_builds = 0
        self.stream_reuses = 0

    def stats(self) -> dict:
        return {
            "tree_packs": self.tree_packs,
            "tier_reuses": self.tier_reuses,
            "scan_reuses": self.scan_reuses,
            "tier_uploads": self.run.uploads + self.delta.uploads,
            "tier_upload_bytes": (self.run.upload_bytes
                                  + self.delta.upload_bytes),
            "tier_repacks": self.run.repacks + self.delta.repacks,
            "scan_uploads": self.scan.uploads,
            "scan_upload_bytes": self.scan.upload_bytes,
            "scan_repacks": self.scan.repacks,
            "router_builds": self.router_builds,
            "stream_reuses": self.stream_reuses,
            "run_capacity": self.run.capacity,
            "delta_capacity": self.delta.capacity,
            "scan_capacity": self.scan.capacity,
            "run_window": self.run.window,
            "delta_window": self.delta.window,
            "scan_window": self.scan.window,
            "pool_bytes": (self.tree_pools.nbytes()
                           if self.tree_pools is not None else 0),
        }
