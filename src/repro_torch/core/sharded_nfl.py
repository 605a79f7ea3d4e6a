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

Two structural episodes move the shards while they serve (DESIGN.md
§14 sharded form, §18), each coordinated here and built by bounded
folds (``flat_afli._Fold``) into fresh candidate ``FlatAFLI`` objects
while the old shards keep serving:

* the **cross-shard re-key** (``start_reflow``): every shard is frozen
  (its live keys snapshotted, its tiers held, its own fold dropped), all
  live identities are re-keyed under the candidate transform (on the
  card, the NF kernel), the P-1 boundaries are re-derived from the new
  z, and one candidate a shard is folded under the write calls' budget;
  the swap re-keys the writes held since the freeze, then publishes
  shards, boundaries and serve flow in one block;
* the **boundary migration** (``start_reshard``): a window of shards
  ``[lo, hi]`` is frozen, its new interior boundaries are the
  load-weighted quantiles of its keys (``_note_load``'s decayed
  per-shard gauges, read by ``load_snapshot``), and its candidates fold
  under the budget of reads and writes; the swap routes the held writes
  by the new interior boundaries and splices them into the boundary
  vector by value (``_refresh_boundaries``).

Before a swap drops a shard, the current stream waits on that shard's
stream, so a read still in flight there finishes before the caching
allocator can hand the shard's pools to new work.  The router's
boundaries are published as a new device tensor, never written in place.

``serving_telemetry`` (with each shard's load gauges) and
``drift_signals`` aggregate the shards' blocks (counters summed, gauges
the largest shard's) for ``NFL.dispatch_stats`` and its drift
telemetry.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.conflict import (conflict_degrees, fit_linear_model,
                                       should_use_flow, tail_conflict_degree)
from repro_torch.core.flat_afli import (TOMBSTONE, FlatAFLI, FlatAFLIConfig,
                                        _Fold, _ids64, _upload,
                                        split_key_bits)
from repro_torch.dist.sharding import shard_mesh
from repro_torch.kernels.shard_dispatch import (choose_boundaries,
                                                fanout_plan,
                                                refresh_boundaries, route,
                                                route_flow, split_ranges)

__all__ = ["ShardedFlatAFLI"]

# per-shard serving-state gauges: they take the largest shard's value
# when the shards' serving blocks are summed (a summed capacity describes
# no buffer anywhere)
_GAUGES = {"run_capacity", "delta_capacity", "scan_capacity", "run_window",
           "delta_window", "scan_window", "static_max_depth",
           "static_dense_window"}


def _seed_candidate(parent: "ShardedFlatAFLI", cand: FlatAFLI, spk, shi,
                    slo, spv) -> _Fold:
    """Configure a fresh candidate ``FlatAFLI`` over its snapshot segment
    (sorted f32 positioning keys ``spk`` and their identities and
    payloads) and start its fold.  A candidate is built by the fold
    alone, never by ``build()``, so the two things a build decides land
    here: the conflict bucket tail, fitted on the candidate's own keys,
    and the AutoSwitch verdict over its identities and positioning
    keys.  The candidate has no serve flow: a shard is probed by the
    routed z, so its fold verifies on the non-flow route only."""
    cfg = parent.cfg
    model = fit_linear_model(spk.astype(np.float64))
    if spk.shape[0] >= 2 and model.slope > 0:
        d = tail_conflict_degree(
            conflict_degrees(spk.astype(np.float64), model), cfg.gamma)
    else:
        d = cfg.max_bucket
    cand.d_tail = int(np.clip(d, cfg.min_bucket, cfg.max_bucket))
    use, t_orig, t_new = should_use_flow(_ids64(shi, slo).view(np.float64),
                                         spk, cfg.gamma)
    cand.autoswitch = {"use_flow": bool(use), "tail_original": int(t_orig),
                       "tail_transformed": int(t_new)}
    return _Fold(cand, spk, shi, slo, spv.astype(np.int64))


class _Episode:
    """What the cross-shard re-key and the boundary migration share: one
    fresh candidate ``FlatAFLI`` per slot of the window ``[lo, hi]``, each
    folded from its snapshot segment, advanced round robin under the
    caller's budget, and the swap that lands the writes held since the
    freeze in the candidates and drops the old shards."""

    def _freeze(self, s: int):
        """Snapshot shard ``s``'s live keys and hold its tiers: its delta
        keeps taking writes, but no fold or merge of its own may consume
        what the snapshot owns.  The shard's own fold is dropped (the
        candidate supersedes it); its new pools were never installed, so
        the shard serves its old ones.  The snapshot's merge rewrites the
        shard's tiers in place, or reallocates them and frees the old
        buffers, on the current stream, so that stream first waits for
        the reads in flight on the shard's stream."""
        self.parent._write_barrier(s)
        idx = self.parent.shards[s]
        snap = idx._snapshot_live()
        idx._fold = None
        idx._tier_hold = True
        return snap

    def _seed(self, pk, hi, lo, pv, boundaries):
        """Route the sorted snapshot by ``boundaries`` into the window's
        slots and start a candidate fold for each non-empty one."""
        parent = self.parent
        k = self.hi - self.lo + 1
        segs, _inv = fanout_plan(route(pk, boundaries), k)
        self.candidates = [FlatAFLI(parent.cfg,
                                    device=parent.devices[self.lo + j])
                           for j in range(k)]
        self.folds: List[Optional[_Fold]] = []
        self.ids = []
        for j, seg in enumerate(segs):
            self.ids.append(np.unique(_ids64(hi[seg], lo[seg])))
            self.folds.append(_seed_candidate(
                parent, self.candidates[j], pk[seg], hi[seg], lo[seg],
                pv[seg]) if seg.shape[0] else None)

    def tick(self, budget: int) -> bool:
        """Advance the pending candidate folds round robin, each an equal
        share of ``budget``; returns True once the swap has happened."""
        pending = [(j, f) for j, f in enumerate(self.folds) if f is not None]
        if pending:
            share = max(budget // len(pending), 1)
            for j, f in pending:
                if f.tick(share):
                    self.folds[j] = None
        if any(f is not None for f in self.folds):
            return False
        self._swap()
        return True

    def _land_held(self, transform_fn, boundaries) -> None:
        """Land the writes the window's old shards took since the freeze
        in the candidates: one copy per identity (each old delta keeps
        the newest, and an identity routes to one old shard), positioned
        under ``transform_fn`` (None: as they are) and routed by
        ``boundaries``.  Then each candidate adopts its live identities
        (its snapshot segment's, plus the held inserts, less the held
        tombstones); its tiers are current, the run shipped by its
        fold's swap and the delta by the append."""
        parent = self.parent
        k = self.hi - self.lo + 1
        held = [idx for idx in parent.shards[self.lo:self.hi + 1]
                if idx._delta_pk.shape[0]]
        if held:
            hi = np.concatenate([idx._delta_hi for idx in held])
            lo = np.concatenate([idx._delta_lo for idx in held])
            pv = np.concatenate([idx._delta_pv for idx in held])
            if transform_fn is None:
                pk = np.concatenate([idx._delta_pk for idx in held])
            else:
                pk = np.asarray(transform_fn(_ids64(hi, lo).view(np.float64)),
                                np.float64).astype(np.float32)
            segs, _inv = fanout_plan(route(pk, boundaries), k)
            for j, seg in enumerate(segs):
                if not seg.shape[0]:
                    continue
                self.candidates[j]._append_delta(pk[seg], hi[seg], lo[seg],
                                                 pv[seg].astype(np.int32))
                u = _ids64(hi[seg], lo[seg])
                dead = pv[seg] == TOMBSTONE
                self.ids[j] = np.setdiff1d(np.union1d(self.ids[j], u[~dead]),
                                           u[dead], assume_unique=True)
        for j, cand in enumerate(self.candidates):
            cand._ids = self.ids[j]
            cand.n_keys = int(self.ids[j].shape[0])

    def _drop_old(self) -> None:
        """Order the current stream after every read in flight on the
        window's shard streams, so the pools and tiers the old shards
        free are reused only after those reads have finished."""
        for s in range(self.lo, self.hi + 1):
            self.parent._write_barrier(s)


class _ShardedReflow(_Episode):
    """Cross-shard atomic re-key (DESIGN.md §14, sharded form).

    Re-keying each shard in place would move keys across the old
    boundaries under the new transform, and the router and the pools
    would disagree.  So the re-key is global:

    1. **freeze** every shard (``_Episode._freeze``);
    2. **re-partition**: every live identity through ``transform_fn``
       (on the card, the NF kernel), new boundaries at the equal-mass
       quantiles of the new z (``choose_boundaries``), each key routed
       to its new slot;
    3. **rebuild**: one candidate fold a non-empty slot, advanced by the
       write calls' budget while the old shards and boundaries serve;
    4. **swap**: the held writes are re-keyed and routed by the new
       boundaries into the candidates, then shards, boundaries and serve
       flow change in one block, so no query sees new boundaries with
       old pools or the reverse.
    """

    def __init__(self, parent: "ShardedFlatAFLI", transform_fn, serve_flow,
                 on_swap):
        self.parent = parent
        self.transform_fn = transform_fn
        self.serve_flow = serve_flow
        self.on_swap = on_swap
        self.lo, self.hi = 0, parent.n_shards - 1
        snaps = [self._freeze(s) for s in range(parent.n_shards)]
        hi = np.concatenate([sn[1] for sn in snaps])
        lo = np.concatenate([sn[2] for sn in snaps])
        pv = np.concatenate([np.asarray(sn[3], np.int64) for sn in snaps])
        pk = np.asarray(transform_fn(_ids64(hi, lo).view(np.float64)),
                        np.float64).astype(np.float32)
        order = np.argsort(pk, kind="stable")
        pk, hi, lo, pv = pk[order], hi[order], lo[order], pv[order]
        self.boundaries_new = (choose_boundaries(pk, parent.n_shards)
                               if pk.shape[0] else np.empty(0, np.float32))
        self._seed(pk, hi, lo, pv, self.boundaries_new)

    def _swap(self) -> None:
        parent = self.parent
        self._land_held(self.transform_fn, self.boundaries_new)
        self._drop_old()
        # ---- the flip: one assignment block, no query in between
        parent.shards = self.candidates
        parent._set_boundaries(self.boundaries_new)
        parent._serve_flow = self.serve_flow
        parent.n_reflows += 1
        self.on_swap()


class _ShardedReshard(_Episode):
    """Boundary migration of one window of shards ``[lo, hi]`` (DESIGN.md
    §18): a hot shard sheds domain to its neighbours, or a cold one
    absorbs it, while every shard outside the window serves untouched.

    The episode has the re-key's four steps, scoped to the window and
    with no transform: positioning keys do not move, only the boundaries
    between them, so the snapshot and the held writes route as they
    are.  The new interior boundaries are the quantiles of the window's
    keys weighted by load: each key carries ``1 + load / n`` of its
    source shard (its decayed reads and writes spread over its ``n``
    keys), so balanced load gives the equal-mass split and a read-hot
    shard splits finer.  The window's keys lie in ``[B[lo-1], B[hi])``,
    so the outer boundaries, and every other shard's domain, stay
    bit-identical.  The swap routes the held writes by the new interior
    boundaries, replaces the window's shards and splices the boundary
    values (the vector keeps its length), then levels the window's load
    gauges (their total kept): they described the old domains.

    A failure in the freeze or a fold aborts the episode: the window is
    released and serving goes on over the old shards and boundaries
    (nothing was published; ``_snapshot_live`` merges a delta into its
    shard's run, never out of it).  ``parent._reshard_fault`` injects
    one: ``"snapshot"`` in the freeze of the window's second shard,
    ``"fold"`` in every fold tick.
    """

    def __init__(self, parent: "ShardedFlatAFLI", lo: int, hi: int, on_swap,
                 on_abort=None):
        self.parent = parent
        self.lo, self.hi = int(lo), int(hi)
        self.on_swap = on_swap
        self.on_abort = on_abort
        k = self.hi - self.lo + 1
        snaps, wts = [], []
        for s in range(self.lo, self.hi + 1):
            if s > self.lo and parent._reshard_fault == "snapshot":
                raise RuntimeError("injected fault: reshard snapshot")
            snap = self._freeze(s)
            load = (float(parent._load_reads[s])
                    + float(parent._load_writes[s]))
            n = snap[0].shape[0]
            wts.append(np.full(n, 1.0 + load / max(n, 1), np.float64))
            snaps.append(snap)
        pk = np.concatenate([sn[0] for sn in snaps]).astype(np.float32)
        hi_ = np.concatenate([sn[1] for sn in snaps])
        lo_ = np.concatenate([sn[2] for sn in snaps])
        pv = np.concatenate([np.asarray(sn[3], np.int64) for sn in snaps])
        wt = np.concatenate(wts)
        order = np.argsort(pk, kind="stable")
        pk, hi_, lo_, pv, wt = (pk[order], hi_[order], lo_[order], pv[order],
                                wt[order])
        if pk.shape[0]:
            cw = np.cumsum(wt)
            targets = cw[-1] * (np.arange(1, k, dtype=np.float64) / k)
            cut = np.clip(np.searchsorted(cw, targets, side="left"), 0,
                          pk.shape[0] - 1)
            self.interior = np.ascontiguousarray(pk[cut], np.float32)
        else:
            # an empty window: the splice writes the values it finds
            self.interior = parent.boundaries[self.lo:self.hi].copy()
        self._seed(pk, hi_, lo_, pv, self.interior)

    def tick(self, budget: int) -> bool:
        if self.parent._reshard_fault == "fold":
            raise RuntimeError("injected fault: reshard candidate fold")
        return super().tick(budget)

    def _swap(self) -> None:
        parent = self.parent
        self._land_held(None, self.interior)
        self._drop_old()
        # ---- the flip: one assignment block, no query in between
        parent.shards[self.lo:self.hi + 1] = self.candidates
        parent._refresh_boundaries(self.interior, self.lo)
        for g in (parent._load_reads, parent._load_writes):
            g[self.lo:self.hi + 1] = g[self.lo:self.hi + 1].mean()
        parent.n_reshards += 1
        self.on_swap()


def _aggregate(blocks) -> dict:
    """Sum the shards' serving blocks; a gauge takes the largest shard's
    value (a summed capacity describes no buffer anywhere)."""
    out: dict = {}
    for block in blocks:
        for k, v in block.items():
            out[k] = (max(out.get(k, 0), v) if k in _GAUGES
                      else out.get(k, 0) + v)
    return out


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
        self._reflow: Optional[_ShardedReflow] = None    # §14 episode
        self._reshard: Optional[_ShardedReshard] = None  # §18 episode
        self.n_reflows = 0
        self.n_reshards = 0
        self.n_reshard_aborts = 0
        self._reshard_fault: Optional[str] = None  # fault seam (tests)
        # §18 load gauges: decayed per-shard key mass of routed reads and
        # writes, decaying together on a clock of routed keys (not wall
        # time), so they are deterministic under test.  State, not
        # counters: reset_telemetry() leaves them alone
        self.load_window_keys = 4096
        self._load_reads = np.zeros(self.n_shards, np.float64)
        self._load_writes = np.zeros(self.n_shards, np.float64)
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
        """Publish the router's boundaries: the host copy, and a new
        device tensor (never a write into the one a router launch may be
        reading), uploaded without a host sync."""
        self.boundaries = np.asarray(boundaries, np.float32)
        self._boundaries_dev = (
            _upload(self.boundaries, np.float32, self.device)
            if self.boundaries.shape[0] else None)

    def _route_points(self, z32: np.ndarray) -> np.ndarray:
        return route(z32, self.boundaries)

    def _route_flow(self, feats: np.ndarray, packed_w, shapes):
        return route_flow(feats, packed_w, shapes, self._boundaries_dev,
                          self.device)

    # ---------------------------------------------- §14 cross-shard re-key
    def _reflow_tick(self, n_batch: int) -> None:
        """Advance a re-key in flight by a write call's budget (writes
        fund a re-key, reads never do)."""
        if self._reflow is not None and self._reflow.tick(
                self.cfg.fold_budget(n_batch)):
            self._reflow = None

    def start_reflow(self, transform_fn, serve_flow, on_swap) -> bool:
        """Begin the coordinated cross-shard re-key (DESIGN.md §14): the
        freeze and the re-partition now, then the candidates fold under
        the write calls' budget while the old shards and boundaries
        serve, and the swap changes shards, boundaries and serve flow at
        once.  ``transform_fn(ik64) -> z`` maps raw identity keys to the
        new positioning keys; ``serve_flow`` is the new serve context or
        None; ``on_swap()`` runs once, after the swap.  Returns False
        while a re-key or a migration is in flight."""
        if self._reflow is not None or self._reshard is not None:
            return False
        self._reflow = _ShardedReflow(self, transform_fn, serve_flow,
                                      on_swap)
        self._reflow_tick(1)    # nothing live to fold: swaps now
        return True

    # ------------------------------------------------ §18 load and migration
    def _note_load(self, segs, *, write: bool) -> None:
        """Fold one routed batch into the load gauges: a batch of n keys
        decays every gauge by ``exp(-n / load_window_keys)`` and adds its
        per-shard counts, so a gauge is a key mass over a horizon of
        about ``load_window_keys`` routed keys."""
        counts = np.array([int(seg.shape[0]) for seg in segs], np.float64)
        n = float(counts.sum())
        if n <= 0.0:
            return
        d = float(np.exp(-n / float(max(self.load_window_keys, 1))))
        self._load_reads *= d
        self._load_writes *= d
        if write:
            self._load_writes += counts
        else:
            self._load_reads += counts

    def load_snapshot(self) -> dict:
        """The migration trigger's input (``ReshardManager``'s
        ``load_snapshot``): the decayed per-shard read and write gauges
        and the live key counts."""
        return {"reads": self._load_reads.tolist(),
                "writes": self._load_writes.tolist(),
                "n_keys": [int(idx.n_keys) for idx in self.shards],
                "window_keys": int(self.load_window_keys)}

    def start_reshard(self, lo: int, hi: int, on_swap,
                      on_abort=None) -> bool:
        """Begin the boundary migration of the shard window ``[lo, hi]``
        (DESIGN.md §18): the freeze and the re-partition now, then the
        window's candidates fold under the budget of reads and writes
        while every shard serves over the old boundaries, and the swap
        changes the window's shards and splices the boundaries at once.
        Returns False while a re-key or another migration is in flight,
        or for a window of one shard; raises if the freeze fails (the
        window released, nothing published)."""
        if self._reshard is not None or self._reflow is not None:
            return False
        lo = max(int(lo), 0)
        hi = min(int(hi), self.n_shards - 1)
        if hi <= lo:
            return False
        try:
            self._reshard = _ShardedReshard(self, lo, hi, on_swap, on_abort)
        except Exception:
            self._release(lo, hi)
            raise
        self._reshard_tick(1)   # an empty window swaps now
        return True

    def _release(self, lo: int, hi: int) -> None:
        """Roll a migration back: release the window's tier holds and
        count the abort (the old shards and boundaries never stopped
        serving)."""
        for s in range(lo, hi + 1):
            self.shards[s]._tier_hold = False
        self.n_reshard_aborts += 1

    def _reshard_tick(self, n_batch: int) -> None:
        """Advance a migration in flight by a call's budget.  Reads fund
        a migration as writes do (read skew is its trigger, and a
        read-only hot shard must still migrate).  A fold that raises
        aborts the episode: the window is released, shards and
        boundaries stay as they were, and ``on_abort`` is told."""
        r = self._reshard
        if r is None:
            return
        try:
            done = r.tick(self.cfg.fold_budget(n_batch))
        except Exception:
            self._reshard = None
            self._release(r.lo, r.hi)
            if r.on_abort is not None:
                r.on_abort()
            return
        if done:
            self._reshard = None

    def _refresh_boundaries(self, interior: np.ndarray, lo: int) -> None:
        """The migration's boundary splice: write the window's new
        interior boundaries into the f32[P-1] vector by value
        (``shard_dispatch.refresh_boundaries`` checks the order) and
        publish it.  The length never changes."""
        self._set_boundaries(
            refresh_boundaries(self.boundaries, interior, lo))

    def serving_telemetry(self) -> dict:
        """The serving slice of ``NFL.dispatch_stats()``: the shards'
        serving blocks aggregated, each shard's own, and the router's
        fan-out counters; each shard's block carries its load gauges."""
        per = [idx.serving_telemetry() for idx in self.shards]
        for s, t in enumerate(per):
            t["load"] = {"reads": float(self._load_reads[s]),
                         "writes": float(self._load_writes[s])}
        return {
            "serving": _aggregate(t["serving"] for t in per),
            "shards": per,
            "router": {k: (list(v) if isinstance(v, list) else v)
                       for k, v in self._router.items()},
        }

    def drift_signals(self) -> dict:
        """The shards' drift signals aggregated as the serving telemetry
        is (gauges the worst shard, counters summed), with the per-shard
        breakdown, so a drifting sub-distribution is attributable, and
        the state and counts of the re-key and the migration."""
        per = [idx.drift_signals() for idx in self.shards]
        return {
            "max_depth": max(p["max_depth"] for p in per),
            "static_max_depth": max(p["static_max_depth"] for p in per),
            "static_dense_window": max(p["static_dense_window"]
                                       for p in per),
            "run_window": max(p["run_window"] for p in per),
            "delta_window": max(p["delta_window"] for p in per),
            "delta_len": sum(p["delta_len"] for p in per),
            "run_len": sum(p["run_len"] for p in per),
            "run_ratio": max(p["run_ratio"] for p in per),
            "fold_active": any(p["fold_active"] for p in per),
            "reflow_active": self._reflow is not None,
            "reshard_active": self._reshard is not None,
            "n_rebuilds": sum(p["n_rebuilds"] for p in per),
            "n_reflows": int(self.n_reflows),
            "n_reshards": int(self.n_reshards),
            "n_reshard_aborts": int(self.n_reshard_aborts),
            "autoswitch": [p["autoswitch"] for p in per],
            "shards": per,
        }

    def reset_telemetry(self) -> None:
        """Zero each shard's serving counters and the router's fan-out
        counters (gauges, the load gauges among them, stay)."""
        for idx in self.shards:
            idx.reset_telemetry()
        for k, v in self._router.items():
            self._router[k] = [0] * self.n_shards if isinstance(v, list) \
                else 0

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
        self._note_load(segs, write=False)
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
        and return the gather as a finisher.  A migration in flight is
        advanced after the fan-out, while the batch's kernels run."""
        k64 = np.asarray(keys, dtype=np.float64)
        ik64 = k64 if ikeys is None else np.asarray(ikeys, dtype=np.float64)
        z32 = k64.astype(np.float32)
        sids = self._route_points(z32)
        self._router["point_batches"] += 1
        self._router["point_queries"] += int(k64.shape[0])
        finish = self._fanout_points_async(z32, ik64, sids)
        self._reshard_tick(int(k64.shape[0]))
        return finish

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
        finish = self._fanout_points_async(z, ikeys, sids)
        self._reshard_tick(int(z.shape[0]))
        return finish

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
        self._note_load(segs, write=True)
        self._router["write_batches"] += 1
        self._router["write_keys"] += int(k64.shape[0])
        for s, seg in enumerate(segs):
            c = int(seg.shape[0])
            self._router["per_shard_writes"][s] += c
            if not c:
                continue
            self._write_barrier(s)
            self.shards[s].insert_batch(k64[seg], pv[seg], ikeys=ik64[seg])
        self._reflow_tick(int(k64.shape[0]))
        self._reshard_tick(int(k64.shape[0]))

    def delete_batch(self, keys: np.ndarray,
                     ikeys: np.ndarray | None = None) -> np.ndarray:
        """Tombstone deletes, routed like inserts; per-key success flags
        in input order."""
        k64 = np.asarray(keys, dtype=np.float64)
        ik64 = k64 if ikeys is None else np.asarray(ikeys, dtype=np.float64)
        segs, inv = fanout_plan(self._route_points(k64.astype(np.float32)),
                                self.n_shards)
        self._note_load(segs, write=True)
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
        self._reflow_tick(int(k64.shape[0]))
        self._reshard_tick(int(k64.shape[0]))
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
        self._note_load(segs, write=False)
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
        and test hook; serving relies on the per-shard folds).  A
        migration or a re-key in flight is driven to its swap (or its
        abort) first: folding the old shards would waste their work."""
        while self._reshard is not None:
            self._reshard_tick(1 << 50)
        while self._reflow is not None:
            self._reflow_tick(1 << 50)
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
        their serving blocks summed (gauges: the largest shard's), the
        re-key's and the migration's state and counts, the load gauges,
        and the router's fan-out counters."""
        per = []
        for idx in self.shards:
            st = idx.stats()
            st["autoswitch"] = dict(idx.autoswitch)
            per.append(st)
        serving = _aggregate(st["serving"] for st in per)
        return {
            "n_shards": self.n_shards,
            "n_keys": self.n_keys,
            "boundaries": self.boundaries.tolist(),
            "devices": [str(d) for d in self.devices],
            "fold_active": any(st["fold_active"] for st in per),
            "reflow_active": self._reflow is not None,
            "reshard_active": self._reshard is not None,
            "n_rebuilds": self.n_rebuilds,
            "n_reflows": self.n_reflows,
            "n_reshards": self.n_reshards,
            "n_reshard_aborts": self.n_reshard_aborts,
            "load": self.load_snapshot(),
            "n_shadowed": self.n_shadowed,
            "max_depth": max((st["max_depth"] for st in per), default=1),
            "delta_len": sum(st["delta_len"] for st in per),
            "run_len": sum(st["run_len"] for st in per),
            "serving": serving,
            "router": {k: (list(v) if isinstance(v, list) else v)
                       for k, v in self._router.items()},
            "shards": per,
        }
