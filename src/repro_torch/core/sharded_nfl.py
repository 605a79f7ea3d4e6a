"""Sharded key-space serving: P ``FlatAFLI`` shards (DESIGN.md §13).

Port of ``repro.core.sharded_nfl.ShardedFlatAFLI``.  The positioning-key
domain (z-space when the flow is on) is split into P contiguous shards
at equal-mass quantiles of the build's positioning keys
(``kernels.shard_dispatch.choose_boundaries``), and each shard is a
complete ``FlatAFLI`` with its own pools, write tiers and incremental
fold, built on its own device (``dist.sharding.shard_mesh``: shard ``s``
on ``cuda:(s mod device_count)``; on one card every shard shares it).

Serving a batch is three steps:

1. **route** — with the flow on, one ``nf_forward`` launch (the routine
   that positioned every build and write, so the routed z is bit-equal
   to the z each shard was built with) and a ``searchsorted`` over the
   P-1 boundaries on the card (``route_flow``); flow off, and for every
   write, the same binning on the host (``route``);
2. **fan out** — each shard's segment goes to that shard's fused kernels.
   Point reads are dispatched for every shard before any is finished,
   each on the shard's own CUDA stream: the stream first waits on the
   current stream (so it sees every earlier write), then takes the
   segment's upload, the kernel and the copy of its payloads into
   pinned host memory (the shard's pools and tiers, lazily made for an
   unbuilt shard, are taken on the current stream before that, in
   ``FlatAFLI._launch``);
3. **gather** — the parts come back in shard order and the inverse of
   the stable shard-major plan (``fanout_plan``) restores input order.
   A range that straddles a boundary is split into one sub-range per
   touched shard (``split_ranges``), and the sub-results are merged in
   shard order, which is z order.

Writes are routed the same way, and each shard's delta, run and fold
advance on their own, so a fold on a busy shard is paid for by the
writes routed to it.  A write to a shard (insert, delete, a repair, a
rebuild) first makes the current stream wait on that shard's stream, so
a read still in flight reads the state it was dispatched into, and no
tier buffer is rewritten or freed under it.  That is an ordering on the
device, not a host sync.

Not ported yet (ROADMAP A11), and raising ``NotImplementedError``: the
cross-shard re-key and the boundary migration (``start_reflow``,
``start_reshard``), their load gauges (``load_snapshot``), and the
serving telemetry and drift signals.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.flat_afli import (FlatAFLI, FlatAFLIConfig, _ids64,
                                        split_key_bits)
from repro_torch.dist.sharding import shard_mesh
from repro_torch.kernels.shard_dispatch import (choose_boundaries,
                                                fanout_plan, route,
                                                route_flow, split_ranges)

__all__ = ["ShardedFlatAFLI"]

# per-shard serving-state gauges: they take the largest shard's value
# when the shards' serving blocks are summed (a summed capacity describes
# no buffer anywhere)
_GAUGES = {"run_capacity", "delta_capacity", "scan_capacity", "run_window",
           "delta_window", "scan_window"}


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP A11)")


class ShardedFlatAFLI:
    """P-way key-space-partitioned ``FlatAFLI`` behind the ``FlatAFLI``
    serving surface: ``NFL`` drives it as it drives the single index
    (``build`` / ``lookup_batch(_flow)(_async)`` / ``insert_batch`` /
    ``delete_batch`` / ``scan_batch(_flow)`` / ``contains_batch`` /
    ``verify_serve_flow`` / ``rebuild`` / ``stats``).

    ``devices``: one device per shard (wrapped round-robin if shorter);
    by default ``shard_mesh(n_shards, device)``.  ``streams`` holds each
    shard's CUDA stream (None on the CPU); setting an entry to None
    serves that shard on the current stream."""

    def __init__(self, cfg: FlatAFLIConfig | None = None,
                 n_shards: int = 2,
                 devices: Optional[Sequence[Union[str, torch.device]]] = None,
                 device: Optional[Union[str, torch.device]] = None):
        self.cfg = cfg or FlatAFLIConfig()
        self.n_shards = max(int(n_shards), 1)
        if devices is None:
            self.devices = shard_mesh(self.n_shards, device)
        else:
            devs = [torch.device(d) for d in devices]
            self.devices = [devs[s % len(devs)] for s in range(self.n_shards)]
        self.device = self.devices[0]         # where the router runs
        self.shards: List[FlatAFLI] = [FlatAFLI(self.cfg, device=d)
                                       for d in self.devices]
        self.streams = [torch.cuda.Stream(device=d) if d.type == "cuda"
                        else None for d in self.devices]
        self.boundaries = np.empty(0, np.float32)   # f32[P-1], host copy
        self._boundaries_dev = None                 # the router's copy
        self._serve_flow = None
        self._router = {
            "point_batches": 0, "point_queries": 0,
            "write_batches": 0, "write_keys": 0,
            "range_batches": 0, "range_queries": 0,
            "range_subqueries": 0, "straddling_ranges": 0,
            "per_shard_points": [0] * self.n_shards,
            "per_shard_writes": [0] * self.n_shards,
            "per_shard_ranges": [0] * self.n_shards,
        }

    # ------------------------------------------------------------ helpers
    def _write_barrier(self, s: int) -> None:
        """Order a write to shard ``s`` after the reads in flight on its
        stream (a device-side wait, not a host sync)."""
        st = self.streams[s]
        if st is not None:
            torch.cuda.current_stream(st.device).wait_stream(st)

    def _set_boundaries(self, boundaries: np.ndarray) -> None:
        self.boundaries = np.asarray(boundaries, np.float32)
        self._boundaries_dev = (
            torch.from_numpy(self.boundaries.copy()).to(self.device)
            if self.boundaries.shape[0] else None)

    def _route_points(self, z32: np.ndarray) -> np.ndarray:
        return route(z32, self.boundaries)

    def _route_flow(self, feats: np.ndarray, packed_w, shapes):
        return route_flow(feats, packed_w, shapes, self._boundaries_dev,
                          self.device)

    def start_reflow(self, transform_fn, serve_flow, on_swap) -> bool:
        raise _not_ported("the cross-shard re-key (start_reflow)")

    def start_reshard(self, lo: int, hi: int, on_swap,
                      on_abort=None) -> bool:
        raise _not_ported("the boundary migration (start_reshard)")

    def load_snapshot(self) -> dict:
        raise _not_ported("the migration's load gauges (load_snapshot)")

    def serving_telemetry(self) -> dict:
        raise _not_ported("serving_telemetry")

    def drift_signals(self) -> dict:
        raise _not_ported("drift_signals")

    def reset_telemetry(self) -> None:
        raise _not_ported("reset_telemetry")

    # -------------------------------------------------------------- build
    def build(self, pkeys: np.ndarray, payloads: np.ndarray,
              ikeys: np.ndarray | None = None) -> None:
        """Partition the bulk-load keys at the quantiles of their f32
        positioning keys and build one ``FlatAFLI`` per shard on its
        device.  Partitioning compares the f32 keys the router compares,
        so build placement and query routing agree exactly.  An empty
        shard stays unbuilt: its reads miss through the pre-build path
        and its writes buffer in its tiers."""
        pk64 = np.asarray(pkeys, dtype=np.float64)
        ik64 = pk64 if ikeys is None else np.asarray(ikeys, dtype=np.float64)
        pv = np.asarray(payloads, dtype=np.int64)
        pk32 = pk64.astype(np.float32)
        self._set_boundaries(
            choose_boundaries(np.sort(pk32, kind="stable"), self.n_shards))
        segs, _inv = fanout_plan(self._route_points(pk32), self.n_shards)
        for s, seg in enumerate(segs):
            self._write_barrier(s)
            if seg.shape[0]:
                self.shards[s].build(pk64[seg], pv[seg], ikeys=ik64[seg])

    def set_serve_flow(self, normalizer, flow_cfg, packed_w, shapes) -> None:
        """Register the serve-path flow for the router.  Not forwarded to
        the shards: sharded serving computes z once at the router (the
        NF kernel that positioned the build) and probes every shard on
        the non-flow route, so no shard runs an in-kernel NF whose
        placement a fold would have to verify again."""
        self._serve_flow = (normalizer, flow_cfg, packed_w, shapes)

    def verify_serve_flow(self, feats: np.ndarray, ikeys: np.ndarray,
                          packed_w, shapes, payloads: np.ndarray) -> int:
        """§8 for the sharded route: every built key through the serve
        path (router, then the shard's fused lookup).  A key it cannot
        resolve is shadowed into the shard the router targets (a run
        append under the served z, and its identity added to that
        shard's live set), and a copy of it that another shard keeps is
        tombstoned there, so routing can never surface as a miss.
        Returns the number of repaired keys (0 in practice: router z and
        build z come from the same NF routine)."""
        z, sids = self._route_flow(feats, packed_w, shapes)
        res = self._fanout_points_async(z, ikeys, sids)()
        pv = np.asarray(payloads)
        wrong = res != pv.astype(res.dtype)
        if not wrong.any():
            return 0
        ik64 = np.asarray(ikeys, dtype=np.float64)
        hi, lo = split_key_bits(ik64)
        ids = _ids64(hi, lo)
        for s in np.unique(sids[wrong]).tolist():
            m = wrong & (sids == s)
            idx = self.shards[s]
            self._write_barrier(s)
            idx._append_run(z[m], hi[m], lo[m], pv[m].astype(np.int32))
            idx._add_ids(ids[m])
        for t, other in enumerate(self.shards):
            stale = wrong & (sids != t)
            stale[stale] = other._has(ids[stale])
            if stale.any():
                self._write_barrier(t)
                other.delete_batch(z[stale].astype(np.float64),
                                   ikeys=ik64[stale])
        return int(wrong.sum())

    def contains_batch(self, ikeys: np.ndarray) -> np.ndarray:
        """Exact membership by 64-bit identity across all shards: the
        key bits are split once and tested against each shard's live
        set."""
        hi, lo = split_key_bits(np.asarray(ikeys, dtype=np.float64))
        ids = _ids64(hi, lo)
        out = np.zeros(ids.shape[0], bool)
        for idx in self.shards:
            out |= idx._has(ids)
        return out

    # ------------------------------------------------------------- points
    def _fanout_points_async(self, z32: np.ndarray, ik64: np.ndarray,
                             sids: np.ndarray):
        """Dispatch every shard's segment of the positioning keys ``z32``
        before finishing any, each on its shard's stream, and return a
        finisher that gathers the parts in input order."""
        segs, inv = fanout_plan(sids, self.n_shards)
        ik64 = np.asarray(ik64, dtype=np.float64)
        finishers = []
        for s, seg in enumerate(segs):
            c = int(seg.shape[0])
            self._router["per_shard_points"][s] += c
            if c:
                finishers.append(self.shards[s].lookup_batch_async(
                    z32[seg], ikeys=ik64[seg], stream=self.streams[s]))
        n = int(sids.shape[0])

        def finish() -> np.ndarray:
            parts = [f() for f in finishers]
            if not parts:
                return np.full(n, -1, np.int32)
            return np.concatenate(parts)[inv]

        return finish

    def lookup_batch_async(self, keys: np.ndarray,
                           ikeys: np.ndarray | None = None):
        """Non-blocking ``lookup_batch``: route, fan out to every shard,
        and return the gather as a finisher."""
        k64 = np.asarray(keys, dtype=np.float64)
        ik64 = k64 if ikeys is None else np.asarray(ikeys, dtype=np.float64)
        z32 = k64.astype(np.float32)
        sids = self._route_points(z32)
        self._router["point_batches"] += 1
        self._router["point_queries"] += int(k64.shape[0])
        return self._fanout_points_async(z32, ik64, sids)

    def lookup_batch(self, keys: np.ndarray,
                     ikeys: np.ndarray | None = None) -> np.ndarray:
        """Batched point lookups; ``keys`` are positioning keys (raw keys
        when the flow is off)."""
        return self.lookup_batch_async(keys, ikeys)()

    def lookup_batch_flow_async(self, feats: np.ndarray, ikeys: np.ndarray,
                                packed_w, shapes):
        """Non-blocking ``lookup_batch_flow``: one router launch, then
        every shard's kernel in flight on return."""
        z, sids = self._route_flow(feats, packed_w, shapes)
        self._router["point_batches"] += 1
        self._router["point_queries"] += int(z.shape[0])
        return self._fanout_points_async(z, ikeys, sids)

    def lookup_batch_flow(self, feats: np.ndarray, ikeys: np.ndarray,
                          packed_w, shapes) -> np.ndarray:
        """Flow-on point serving: the router's NF launch bins the batch,
        then the per-shard fused kernels probe by the routed z (no NF in
        the shard kernels); identity resolution and the tier probes work
        as on the single index."""
        return self.lookup_batch_flow_async(feats, ikeys, packed_w,
                                            shapes)()

    # ------------------------------------------------------------- writes
    def insert_batch(self, keys: np.ndarray, payloads: np.ndarray,
                     ikeys: np.ndarray | None = None) -> None:
        """Route the batch and append per shard: each shard's delta, run
        and fold advance on their own, so a fold on one shard is paid for
        only by the inserts routed there."""
        k64 = np.asarray(keys, dtype=np.float64)
        ik64 = k64 if ikeys is None else np.asarray(ikeys, dtype=np.float64)
        pv = np.asarray(payloads, dtype=np.int32)
        segs, _inv = fanout_plan(self._route_points(k64.astype(np.float32)),
                                 self.n_shards)
        self._router["write_batches"] += 1
        self._router["write_keys"] += int(k64.shape[0])
        for s, seg in enumerate(segs):
            c = int(seg.shape[0])
            self._router["per_shard_writes"][s] += c
            if not c:
                continue
            self._write_barrier(s)
            self.shards[s].insert_batch(k64[seg], pv[seg], ikeys=ik64[seg])

    def delete_batch(self, keys: np.ndarray,
                     ikeys: np.ndarray | None = None) -> np.ndarray:
        """Tombstone deletes, routed like inserts; per-key success flags
        in input order."""
        k64 = np.asarray(keys, dtype=np.float64)
        ik64 = k64 if ikeys is None else np.asarray(ikeys, dtype=np.float64)
        segs, inv = fanout_plan(self._route_points(k64.astype(np.float32)),
                                self.n_shards)
        self._router["write_batches"] += 1
        self._router["write_keys"] += int(k64.shape[0])
        parts = []
        for s, seg in enumerate(segs):
            c = int(seg.shape[0])
            self._router["per_shard_writes"][s] += c
            if not c:
                continue
            self._write_barrier(s)
            parts.append(self.shards[s].delete_batch(k64[seg],
                                                     ikeys=ik64[seg]))
        if not parts:
            return np.zeros(k64.shape[0], bool)
        return np.concatenate(parts)[inv]

    # ------------------------------------------------------------- ranges
    def scan_batch(self, lo_keys: np.ndarray, hi_keys: np.ndarray,
                   cap: int | None = None):
        """Batched ``[lo, hi)`` range scans across shards (§12 per
        shard, §13 split and merge)."""
        lo32 = np.asarray(lo_keys, dtype=np.float64).astype(np.float32)
        hi32 = np.asarray(hi_keys, dtype=np.float64).astype(np.float32)
        return self._fanout_scan(lo32, hi32, cap)

    def scan_batch_flow(self, feats_lo: np.ndarray, feats_hi: np.ndarray,
                        packed_w, shapes, cap: int | None = None):
        """Flow-on ranges: both endpoint batches ride one router NF
        launch, then split, fan out and merge in z-space."""
        n = np.asarray(feats_lo).shape[0]
        z, _ = self._route_flow(np.concatenate([feats_lo, feats_hi]),
                                packed_w, shapes)
        return self._fanout_scan(z[:n], z[n:], cap)

    def _fanout_scan(self, zlo32: np.ndarray, zhi32: np.ndarray,
                     cap: int | None):
        """Split straddling ranges at the boundaries, scan each shard,
        merge the sub-results in z order (DESIGN.md §13).

        The sub-ranges tile ``[zlo, zhi)`` and shard order is z order, so
        each query's live lanes are its sub-scans' lanes concatenated in
        shard order, while each sub-scan's candidates stay bounded by
        ``cap``.  ``totals`` sums the sub-scans' candidate totals;
        ``counts`` is cut at ``cap``.  Once a sub-range is truncated,
        the later sub-ranges of its query are dropped from the lanes
        (they would leave a gap in z order) but still counted in
        ``totals``, so the query reads as truncated either way."""
        cap = int(cap if cap is not None else self.cfg.scan_cap)
        n = int(zlo32.shape[0])
        qid, sid, sub_lo, sub_hi = split_ranges(zlo32, zhi32,
                                                self.boundaries)
        m = int(qid.shape[0])
        self._router["range_batches"] += 1
        self._router["range_queries"] += n
        self._router["range_subqueries"] += m
        spans = np.bincount(qid, minlength=n)
        self._router["straddling_ranges"] += int((spans > 1).sum())
        out = np.full((n, cap), -1, np.int32)
        if not m:
            return out, np.zeros(n, np.int32), np.zeros(n, np.int32)
        # a query with one sub-range takes its sub-scan's row as it is
        # (-1 past its count); only straddling queries are merged
        one = spans[qid] == 1
        multi = np.flatnonzero(~one)
        row = np.empty(m, np.int64)
        row[multi] = np.arange(multi.shape[0])
        multi_pv = np.empty((multi.shape[0], cap), np.int32)
        sub_cnt = np.empty(m, np.int32)
        sub_tot = np.empty(m, np.int64)
        segs, _inv = fanout_plan(sid, self.n_shards)
        for s, seg in enumerate(segs):
            c = int(seg.shape[0])
            self._router["per_shard_ranges"][s] += c
            if not c:
                continue
            pv_s, cnt_s, tot_s = self.shards[s].scan_batch(
                sub_lo[seg].astype(np.float64),
                sub_hi[seg].astype(np.float64), cap=cap)
            sub_cnt[seg] = cnt_s
            sub_tot[seg] = tot_s
            o = one[seg]
            out[qid[seg[o]]] = pv_s[o, :cap]
            multi_pv[row[seg[~o]]] = pv_s[~o, :cap]
        # merge: a query's sub-ranges are consecutive and shard ascending
        # (z ascending); each one's lanes start after the lanes of the
        # earlier ones of its query
        qm, cnt_m, tot_m = qid[multi], sub_cnt[multi], sub_tot[multi]
        first = np.searchsorted(qm, qm)
        trunc = tot_m > cap
        a = np.cumsum(trunc) - trunc
        eff = np.where(a - a[first] > 0, 0, cnt_m)
        csum = np.cumsum(eff) - eff
        dest = (csum - csum[first])[:, None] + np.arange(cap)[None, :]
        keep = (np.arange(cap)[None, :] < eff[:, None]) & (dest < cap)
        out[np.broadcast_to(qm[:, None], keep.shape)[keep],
            dest[keep]] = multi_pv[keep]
        cnt = (np.bincount(qid[one], weights=sub_cnt[one], minlength=n)
               + np.minimum(np.bincount(qm, weights=eff, minlength=n), cap))
        tot = np.bincount(qid, weights=sub_tot, minlength=n)
        return out, cnt.astype(np.int32), np.clip(
            tot, 0, np.iinfo(np.int32).max).astype(np.int32)

    # ---------------------------------------------------------------- misc
    def rebuild(self) -> None:
        """Fold every shard's write tiers into its tree now (maintenance
        and test hook; serving relies on the per-shard folds)."""
        for s, idx in enumerate(self.shards):
            self._write_barrier(s)
            idx.rebuild()

    @property
    def n_keys(self) -> int:
        return int(sum(idx.n_keys for idx in self.shards))

    @property
    def n_shadowed(self) -> int:
        return int(sum(idx.n_shadowed for idx in self.shards))

    @property
    def n_rebuilds(self) -> int:
        return int(sum(idx.n_rebuilds for idx in self.shards))

    def stats(self) -> dict:
        """The shards' ``stats()`` (with each shard's AutoSwitch verdict),
        their serving blocks summed (gauges: the largest shard's), and
        the router's fan-out counters."""
        per = []
        for idx in self.shards:
            st = idx.stats()
            st["autoswitch"] = dict(idx.autoswitch)
            per.append(st)
        serving: dict = {}
        for st in per:
            for k, v in st["serving"].items():
                serving[k] = (max(serving.get(k, 0), v) if k in _GAUGES
                              else serving.get(k, 0) + v)
        return {
            "n_shards": self.n_shards,
            "n_keys": self.n_keys,
            "boundaries": self.boundaries.tolist(),
            "devices": [str(d) for d in self.devices],
            "fold_active": any(st["fold_active"] for st in per),
            "n_rebuilds": self.n_rebuilds,
            "n_shadowed": self.n_shadowed,
            "max_depth": max((st["max_depth"] for st in per), default=1),
            "delta_len": sum(st["delta_len"] for st in per),
            "run_len": sum(st["run_len"] for st in per),
            "serving": serving,
            "router": {k: (list(v) if isinstance(v, list) else v)
                       for k, v in self._router.items()},
            "shards": per,
        }
