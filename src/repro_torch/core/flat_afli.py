"""FlatAFLI — the flattened AFLI index, served by the port's kernels.

Port of ``repro.core.flat_afli`` for the read path.  The structure is the
JAX package's, bit for bit: model nodes with f32 precise placement,
conflict buckets, dense nodes, all flattened into structure-of-arrays
pools; every record carries its 64-bit key identity as a (hi, lo) u32
pair.  The host builder (``_Builder``) is numpy and produces the same
arrays as the JAX package's builder on the same input, but places each
node's slots with array operations instead of a per-slot Python loop,
so a bulk load of tens of millions of keys takes seconds.

Serving: the pools are packed once per build into a ``ServingState`` on
the index's device, and every lookup is one ``ops.fused_lookup`` launch
that also probes the write tiers: the fused rung (the tree), or, when
``pool_budget`` is set and the tree pools' bytes exceed it, the streamed
rung (the scan pool in router-bracketed tiles).  ``_self_verify`` and
``verify_serve_flow`` look every built key up through the fused rung
and shadow any key it cannot find into the run tier (keyed by the served
positioning key).  With the kernel's slot arithmetic rounding exactly as
the builder's does, the shadow set is expected to be empty; the net
stays.

Writes are log-structured and tiered, as in the JAX package: a batch
lands in the active delta (last write wins by identity), a full delta
merges into the compacted run, and a deletion appends a TOMBSTONE (-2)
that masks every older copy of its identity.  When the run outgrows
``rebuild_frac`` of the live keys, a bounded-step fold (``_Fold``)
rebuilds the tree from a snapshot while the old tree and the frozen tiers
keep serving, and swaps the new tree in.  Range scans
(``scan_batch``) are one ``ops.fused_range_scan`` launch over the
static keys in rank order (the scan pool) merged with both tiers.

The set of live identities is a sorted ``uint64`` array, updated per
batch with array operations.

Point reads are asynchronous underneath: ``lookup_batch_async`` (and
its flow twin) launches the kernel and the copy of its payloads into
pinned host memory, on the current stream or a given one, and returns a
finisher; ``lookup_batch`` is that finisher called at once.

Not ported yet: re-flow (``start_reflow``) and the tier hold that the
sharded re-key and boundary migration put on a shard (ROADMAP A11).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.conflict import (conflict_degrees, fit_linear_model,
                                       should_use_flow, tail_conflict_degree)
from repro_torch.core.feature import expand_features
from repro_torch.core.serving_state import ServingState
from repro_torch.kernels import ops
from repro_torch.kernels.backend import resolve_device
from repro_torch.kernels.fused_lookup import (BUCKET, CHILD, DATA, EMPTY,
                                              KIND_DENSE, KIND_MODEL,
                                              TOMBSTONE, KernelPools)

__all__ = ["FlatAFLI", "FlatAFLIConfig", "FlatArrays", "TOMBSTONE",
           "split_key_bits"]


def split_key_bits(keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """f64 keys -> exact (hi, lo) uint32 identity pair."""
    bits = np.asarray(keys, dtype=np.float64).view(np.uint64)
    return ((bits >> np.uint64(32)).astype(np.uint32),
            (bits & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def _max_equal_run(sorted_vals: np.ndarray) -> int:
    """Longest run of equal values in a sorted array (f32 collision bound)."""
    if sorted_vals.shape[0] == 0:
        return 0
    change = np.flatnonzero(np.diff(sorted_vals) != 0)
    edges = np.concatenate([[-1], change, [sorted_vals.shape[0] - 1]])
    return int(np.diff(edges).max())


def _ids64(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """(hi, lo) u32 identity bits -> u64 identity words."""
    return (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)


def _dedup_newest(pk: np.ndarray, hi: np.ndarray, lo: np.ndarray,
                  pv: np.ndarray):
    """Last-write-wins by 64-bit identity (input order is age order,
    oldest first), then a stable re-sort by positioning key."""
    u64 = _ids64(hi, lo)
    order = np.argsort(u64, kind="stable")
    su = u64[order]
    keep = order[np.append(su[1:] != su[:-1], True)]
    pk, hi, lo, pv = pk[keep], hi[keep], lo[keep], pv[keep]
    order = np.argsort(pk, kind="stable")
    return pk[order], hi[order], lo[order], pv[order]


def _upload(x: np.ndarray, dtype, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` (u32 identity halves as their int32 bit
    views), copied on the current stream without a stream sync: the
    driver stages a pageable source before the copy call returns, so the
    array may go at once, and the host does not wait for the stream's
    earlier work."""
    x = np.ascontiguousarray(x)
    x = x.view(np.int32) if x.dtype == np.uint32 else x.astype(dtype,
                                                               copy=False)
    t = torch.from_numpy(x)
    if device.type != "cuda":
        return t
    return t.to(device, non_blocking=True)


@contextlib.contextmanager
def _on_stream(stream, wait: bool = True):
    """Enqueue the block's device work on ``stream`` (None: the current
    stream), after the current stream's work so far when ``wait``."""
    if stream is None:
        yield
        return
    if wait:
        stream.wait_stream(torch.cuda.current_stream(stream.device))
    with torch.cuda.stream(stream):
        yield


def _fetch_async(t: torch.Tensor):
    """Start copying ``t`` to the host (on the card: into a pinned
    buffer, non-blocking, on the current stream) and return a finisher
    that waits for the copy and returns the numpy array.  The array is
    copied out of the pinned buffer, so a caller that keeps results does
    not keep pinned memory."""
    if t.device.type != "cuda":
        return t.numpy
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(t.device))

    def finish():
        done.synchronize()
        return host.numpy().copy()

    return finish


def _tier_window(pk_pool: np.ndarray) -> int:
    """Probe window of one sorted tier: its longest run of equal
    positioning keys (at least 1)."""
    return max(_max_equal_run(pk_pool), 1)


@dataclasses.dataclass(frozen=True)
class FlatAFLIConfig:
    """Build, write-path and serving settings of one ``FlatAFLI``.

    ``pool_budget`` is the card's counterpart of the JAX package's
    ``vmem_budget``: live point reads take the streamed rung when the
    packed tree pools exceed that many bytes (``0`` streams every live
    read).  Its default, ``None``, never streams: the card holds the
    pools in device memory, so no residency limit forces a rung.  Bytes
    do not predict the faster rung either: ``chip_smoke.py`` times both
    rungs on the same batches, and the streamed rung is the slower one
    on the larger index and the faster one on the smaller (PERF.md
    section 7).  ROADMAP A9b replaces this budget with a criterion the
    index can observe."""

    gamma: float = 0.99
    max_bucket: int = 6
    min_bucket: int = 2
    alpha: float = 1.2
    max_depth: int = 16
    dense_search_iters: int = 24      # binary-search rounds (2^24 max dense)
    rebuild_frac: float = 0.25        # run / live keys that starts a fold
    delta_cap: int = 4096             # active-delta bound before run merge
    fold_step_keys: int = 4096        # fold work unit and verify chunk (keys)
    fold_work_factor: float = 8.0     # fold work per write call, x batch
    scan_cap: int = 128               # range-scan output lanes per query
    pool_budget: Optional[int] = None  # tree-pool bytes above which live
                                       # reads stream; None: never


class FlatArrays(NamedTuple):
    """Host structure-of-arrays (numpy), as the builder emits it."""

    node_kind: np.ndarray        # u8[N]   model / dense
    node_slope: np.ndarray       # f32[N]
    node_intercept: np.ndarray   # f32[N]
    node_offset: np.ndarray      # i32[N]  start into entry pool
    node_size: np.ndarray        # i32[N]
    etype: np.ndarray            # u8[P]
    ekey: np.ndarray             # f32[P]  positioning key of DATA entries
    ehi: np.ndarray              # u32[P]  identity bits
    elo: np.ndarray              # u32[P]
    epayload: np.ndarray         # i32[P]
    echild: np.ndarray           # i32[P]  bucket id / child node id
    bkey: np.ndarray             # f32[B, cap]
    bhi: np.ndarray              # u32[B, cap]
    blo: np.ndarray              # u32[B, cap]
    bpayload: np.ndarray         # i32[B, cap]
    blen: np.ndarray             # i32[B]

    @classmethod
    def empty(cls, cap: int) -> "FlatArrays":
        """The structure of an index that was never built: one model node
        whose single slot is EMPTY, so every probe misses the tree and
        resolves from the write tiers alone."""
        z = np.zeros(1, np.int32)
        return cls(node_kind=np.full(1, KIND_MODEL, np.uint8),
                   node_slope=np.zeros(1, np.float32),
                   node_intercept=np.zeros(1, np.float32),
                   node_offset=z, node_size=np.ones(1, np.int32),
                   etype=np.full(1, EMPTY, np.uint8),
                   ekey=np.zeros(1, np.float32),
                   ehi=np.zeros(1, np.uint32), elo=np.zeros(1, np.uint32),
                   epayload=np.full(1, -1, np.int32),
                   echild=np.full(1, -1, np.int32),
                   bkey=np.zeros((1, cap), np.float32),
                   bhi=np.zeros((1, cap), np.uint32),
                   blo=np.zeros((1, cap), np.uint32),
                   bpayload=np.zeros((1, cap), np.int32), blen=z)

    def to_kernel_args(self, device: Union[str, torch.device]
                       ) -> KernelPools:
        """Pack the pools for the fused kernel on ``device``, at their
        exact sizes: u8 codes to i32, u32 identity halves as int32 bit
        views.  The kernel takes every size at run time, so nothing is
        padded (the JAX package pads to lane multiples and power-of-two
        buckets to bound its retraces)."""

        def to_dev(x):
            x = np.asarray(x)
            if x.dtype == np.uint32:
                x = x.view(np.int32)
            return torch.from_numpy(np.ascontiguousarray(x)).to(device)

        return KernelPools(
            node_kind=to_dev(self.node_kind.astype(np.int32)),
            node_slope=to_dev(self.node_slope),
            node_intercept=to_dev(self.node_intercept),
            node_offset=to_dev(self.node_offset),
            node_size=to_dev(self.node_size),
            etype=to_dev(self.etype.astype(np.int32)),
            ekey=to_dev(self.ekey),
            ehi=to_dev(self.ehi),
            elo=to_dev(self.elo),
            epayload=to_dev(self.epayload),
            echild=to_dev(self.echild),
            bhi=to_dev(self.bhi),
            blo=to_dev(self.blo),
            bpayload=to_dev(self.bpayload),
            blen=to_dev(self.blen),
        )


def _ranges(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Concatenated ``arange(s, s + c)`` over the (start, count) pairs."""
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, np.int64)
    excl = np.cumsum(counts) - counts
    return np.repeat(starts - excl, counts) + np.arange(total)


def _node_chunks(n: np.ndarray, step: Optional[int]):
    """(start, stop) runs of consecutive nodes holding at most ``step``
    keys together, or one node that alone holds more; ``None``: one run."""
    if step is None:
        return [(0, n.shape[0])]
    cs = np.cumsum(n)
    out = []
    a = 0
    while a < n.shape[0]:
        done = int(cs[a - 1]) if a else 0
        b = max(int(np.searchsorted(cs, done + step, side="right")), a + 1)
        out.append((a, b))
        a = b
    return out


def _seg_cumsum_excl(vals: np.ndarray, seg: np.ndarray) -> np.ndarray:
    """Exclusive running sum of ``vals`` within runs of equal ``seg``
    (``seg`` non-decreasing)."""
    cs = np.cumsum(vals)
    first = np.r_[True, seg[1:] != seg[:-1]][:seg.shape[0]]
    base = (cs - vals)[first]
    return cs - vals - np.repeat(base, np.diff(np.r_[np.flatnonzero(first),
                                                      seg.shape[0]]))


class _Builder:
    """Host-side flattening of Alg 3.2 with f32 placement arithmetic.

    Emits the JAX package's ``_Builder`` output: nodes in the same
    depth-first order, buckets numbered in the same order (a node's
    buckets left of a child run come before the child's subtree), the
    same f32 slope/intercept arithmetic.  Instead of one Python call per
    node it builds the tree a level at a time with array operations over
    every node of the level, then numbers nodes, buckets and entry
    offsets depth-first.  Per node, a slot group of one key is a DATA
    entry, fewer than ``d_tail`` keys a bucket, and each maximal run of
    adjacent slots holding ``d_tail`` or more keys each becomes a child.

    Only the per-node linear fit stays one call per node (see ``_fit``)."""

    def __init__(self, cfg: FlatAFLIConfig, d_tail: int):
        self.cfg = cfg
        self.d_tail = d_tail
        self.max_depth = 1
        self._arrays: Optional[FlatArrays] = None

    def _fit(self, pk, s0, n, skip):
        """Per-node least-squares fit keys -> alpha * rank (f64): returns
        (slope, intercept).  ``fit_linear_model`` on each node's keys, one
        call a node, exactly as the reference builder calls it: its sums
        run through numpy's ``mean`` and ``dot``, whose summation order an
        array formulation would not reproduce, and an exactly linear key
        set (intercept 0) shows the difference in the f32 it stores."""
        alpha = self.cfg.alpha
        slope = np.zeros(n.shape[0])
        icpt = np.zeros(n.shape[0])
        for j in np.flatnonzero((n > 1) & ~skip).tolist():
            a, m = int(s0[j]), int(n[j])
            f = fit_linear_model(pk[a:a + m].astype(np.float64),
                                 np.arange(m, dtype=np.float64) * alpha)
            slope[j], icpt[j] = f.slope, f.intercept
        return slope, icpt

    def build(self, pk: np.ndarray, hi: np.ndarray, lo: np.ndarray,
              pv: np.ndarray) -> int:
        """Build the whole tree over sorted f32 keys ``pk``; returns the
        root's id (0)."""
        for _ in self.build_steps(pk, hi, lo, pv):
            pass
        return 0

    def build_steps(self, pk: np.ndarray, hi: np.ndarray, lo: np.ndarray,
                    pv: np.ndarray, step_keys: Optional[int] = None):
        """``build`` in bounded steps: a generator that yields the work of
        each step in keys, for the incremental fold's budget.

        Each tree level is cut into node chunks: maximal runs of
        consecutive nodes holding at most ``step_keys`` keys together, or
        one node that alone holds more.  A chunk fits and places its
        nodes and is charged the keys it holds; a single node above the
        step is one vectorised partition pass and is charged a
        sixteenth of its keys, as the reference fold charges its root
        partition.  After each level the partition into the next level
        is charged a sixteenth of the level's keys, and the depth-first
        assembly of the pools a quarter of all keys.  ``step_keys=None``
        takes each level whole (the bulk load).  Chunking changes no
        output: nodes are independent within a level, and the chunks are
        concatenated in node order."""
        # per breadth-first node
        kind, slope_n, icpt_n, size_n, parent = [], [], [], [], []
        level_start = []
        dense_w = []      # (node, first key) of dense nodes
        data_w = []       # (node, slot, key)
        bucket_w = []     # (node, slot, first key, count)
        child_w = []      # (node, first slot, last slot, child)
        # the nodes of one level: first key, key count, depth, parent,
        # and whether it is a dense child that spans its parent's keys
        s0 = np.zeros(1, np.int64)
        n = np.array([pk.shape[0]], np.int64)
        dep = np.ones(1, np.int64)
        par = np.full(1, -1, np.int64)
        forced = np.zeros(1, bool)
        n_nodes = 0
        while s0.shape[0]:
            level_keys = int(n.sum())
            level_start.append(n_nodes)
            ids = n_nodes + np.arange(s0.shape[0])
            n_nodes += s0.shape[0]
            if (~forced).any():
                self.max_depth = max(self.max_depth, int(dep[~forced].max()))
            parts = []
            n_child = 0
            for a, b in _node_chunks(n, step_keys):
                part = self._place_nodes(pk, s0[a:b], n[a:b], dep[a:b],
                                         forced[a:b], ids[a:b],
                                         n_nodes + n_child)
                n_child += part[-1][0].shape[0]
                parts.append(part)
                keys = int(n[a:b].sum())
                yield keys if b - a > 1 or step_keys is None \
                    or keys <= step_keys else max(keys // 16, 1)
            cols = [np.concatenate(c) for c in zip(*(p[:8] for p in parts))]
            k_, sl_, ic_, sz_, dw, daw, bw, cw = cols
            kind.append(k_)
            slope_n.append(sl_)
            icpt_n.append(ic_)
            size_n.append(sz_)
            parent.append(par)
            dense_w.append(dw)
            data_w.append(daw)
            bucket_w.append(bw)
            child_w.append(cw)
            s0, n, dep, par, forced = (np.concatenate(c) for c in
                                       zip(*(p[8] for p in parts)))
            yield max(level_keys // 16, 1)
        level_start.append(n_nodes)
        self._arrays = self._assemble(
            pk, hi, lo, pv, np.concatenate(kind), np.concatenate(slope_n),
            np.concatenate(icpt_n), np.concatenate(size_n),
            np.concatenate(parent), level_start,
            np.concatenate(dense_w), np.concatenate(data_w),
            np.concatenate(bucket_w), np.concatenate(child_w))
        yield max(pk.shape[0] // 4, 1)

    def _place_nodes(self, pk, s0, n, dep, forced, ids, child_base):
        """Fit and place a run of consecutive nodes of one level.

        Returns the nodes' kind, slope, intercept and size, their
        dense, DATA, bucket and child records, and the next level's
        nodes (first key, count, depth, parent, forced) as a tuple, with
        the children numbered from ``child_base``."""
        cfg = self.cfg
        alpha = cfg.alpha
        sl, ic = self._fit(pk, s0, n, forced)
        degen = forced | (sl <= 0.0) | (n < 2)
        s32 = sl.astype(np.float32)
        b32 = ic.astype(np.float32)
        first = np.zeros(s0.shape[0], np.int64)
        last = np.zeros(s0.shape[0], np.int64)
        cand = np.flatnonzero(~degen)
        if cand.shape[0]:
            nc = n[cand]
            idx = _ranges(s0[cand], nc)
            st = np.cumsum(nc) - nc
            raw = np.rint(np.repeat(s32[cand], nc) * pk[idx]
                          + np.repeat(b32[cand], nc))
            fin = np.logical_and.reduceat(np.isfinite(raw), st)
            first[cand] = np.where(fin, raw[st], 0).astype(np.int64)
            last[cand] = np.where(fin, raw[st + nc - 1], 0).astype(np.int64)
            degen[cand] |= ~fin
        degen |= last == first
        dense = degen | (dep >= cfg.max_depth)
        model = np.flatnonzero(~dense)
        size = n.copy()
        mslope = np.zeros(s0.shape[0], np.float32)
        micpt = np.zeros(s0.shape[0], np.float32)
        nm = n[model]
        fm, lm = first[model], last[model]
        sz = np.minimum(np.maximum(np.floor(nm * alpha).astype(np.int64),
                                   2), lm - fm + 1)
        size[model] = sz
        scale = ((sz - 1) / np.maximum(lm - fm, 1)).astype(np.float32)
        mslope[model] = s32[model] * scale
        micpt[model] = (b32[model] - fm.astype(np.float32)) * scale
        dj = np.flatnonzero(dense)

        # slot groups of every model node of the run
        idx = _ranges(s0[model], nm)
        base = np.cumsum(sz) - sz
        pred = np.rint(np.repeat(mslope[model], nm) * pk[idx]
                       + np.repeat(micpt[model], nm)).astype(np.int64)
        pred = np.clip(pred, 0, np.repeat(sz - 1, nm))
        # per-node running max: node bases keep nodes apart
        gpred = np.maximum.accumulate(pred + np.repeat(base, nm))
        gs = np.flatnonzero(np.r_[True, gpred[1:] != gpred[:-1]]
                            [:idx.shape[0]])
        gcount = np.diff(np.r_[gs, idx.shape[0]])
        gseg = np.repeat(np.arange(model.shape[0]), nm)[gs]
        gslot = gpred[gs] - base[gseg]
        gkey = idx[gs]
        gnode = ids[model][gseg]
        single = gcount == 1
        big = gcount >= self.d_tail
        bk = ~single & ~big
        # children: maximal runs of adjacent big slots of one node
        g = np.flatnonzero(big)
        new_run = np.r_[True, (np.diff(g) != 1) | (np.diff(gseg[g]) != 0)
                        | (np.diff(gslot[g]) != 1)][:g.shape[0]]
        fg = g[new_run]
        lg = g[np.r_[new_run[1:], True]] if g.shape[0] else g
        i0 = gkey[fg]
        tot = gkey[lg] + gcount[lg] - i0
        return (np.where(dense, KIND_DENSE, KIND_MODEL), mslope, micpt, size,
                np.stack([ids[dj], s0[dj]], 1),
                np.stack([gnode[single], gslot[single], gkey[single]], 1),
                np.stack([gnode[bk], gslot[bk], gkey[bk], gcount[bk]], 1),
                np.stack([gnode[fg], gslot[fg], gslot[lg],
                          child_base + np.arange(fg.shape[0])], 1),
                (i0, tot, dep[model][gseg[fg]] + 1, gnode[fg],
                 tot == nm[gseg[fg]]))

    def _assemble(self, pk, hi, lo, pv, kind, slope, icpt, size, parent,
                  level_start, dense, data, bucket, child) -> FlatArrays:
        """Number nodes, buckets and entries depth-first; fill the pools."""
        cap = self.cfg.max_bucket
        n_nodes = kind.shape[0]
        cnode, cslot, cid = child[:, 0], child[:, 1], child[:, 3]
        # subtree node / bucket counts, bottom-up one level at a time
        sub = np.ones(n_nodes, np.int64)
        sub_b = np.bincount(bucket[:, 0], minlength=n_nodes).astype(np.int64)
        for lv in range(len(level_start) - 2, 0, -1):
            ids = np.arange(level_start[lv], level_start[lv + 1])
            np.add.at(sub, parent[ids], sub[ids])
            np.add.at(sub_b, parent[ids], sub_b[ids])
        # event offsets inside each node, in slot order: a child counts
        # its subtree, a bucket counts one
        ev_node = np.r_[cnode, bucket[:, 0]]
        ev_slot = np.r_[cslot, bucket[:, 1]]
        ev_w = np.r_[sub_b[cid], np.ones(bucket.shape[0], np.int64)]
        order = np.lexsort((ev_slot, ev_node))
        ev_off = np.empty_like(ev_w)
        ev_off[order] = _seg_cumsum_excl(ev_w[order], ev_node[order])
        nc = cid.shape[0]
        c_boff, b_off = ev_off[:nc], ev_off[nc:]
        # child rows are sorted by (parent, slot) already
        c_noff = _seg_cumsum_excl(sub[cid], cnode)
        pre = np.zeros(n_nodes, np.int64)
        bbase = np.zeros(n_nodes, np.int64)
        for lv in range(1, len(level_start) - 1):
            rows = np.arange(level_start[lv], level_start[lv + 1]) - 1
            p = cnode[rows]
            pre[cid[rows]] = pre[p] + 1 + c_noff[rows]
            bbase[cid[rows]] = bbase[p] + c_boff[rows]
        bid = bbase[bucket[:, 0]] + b_off
        at = np.empty(n_nodes, np.int64)
        at[pre] = np.arange(n_nodes)
        offset = np.empty(n_nodes, np.int64)
        offset[at] = np.cumsum(size[at]) - size[at]

        n_ent = int(size.sum())
        etype = np.zeros(n_ent, np.uint8)
        ekey = np.zeros(n_ent, np.float32)
        ehi = np.zeros(n_ent, np.uint32)
        elo = np.zeros(n_ent, np.uint32)
        epay = np.zeros(n_ent, np.int32)
        echild = np.full(n_ent, -1, np.int32)

        def put(e, k):
            etype[e] = DATA
            ekey[e] = pk[k]
            ehi[e] = hi[k]
            elo[e] = lo[k]
            epay[e] = pv[k]

        put(offset[data[:, 0]] + data[:, 1], data[:, 2])
        dn = size[dense[:, 0]]
        put(_ranges(offset[dense[:, 0]], dn), _ranges(dense[:, 1], dn))
        e = offset[bucket[:, 0]] + bucket[:, 1]
        etype[e] = BUCKET
        echild[e] = bid
        cnt = child[:, 2] - cslot + 1
        e = _ranges(offset[cnode] + cslot, cnt)
        etype[e] = CHILD
        echild[e] = np.repeat(pre[cid], cnt)

        nb = max(bucket.shape[0], 1)
        bkey = np.zeros((nb, cap), np.float32)
        bhi = np.zeros((nb, cap), np.uint32)
        blo = np.zeros((nb, cap), np.uint32)
        bpv = np.zeros((nb, cap), np.int32)
        blen = np.zeros(nb, np.int32)
        bc = bucket[:, 3]
        rows = np.repeat(bid, bc)
        cols = _ranges(np.zeros_like(bc), bc)
        k = _ranges(bucket[:, 2], bc)
        bkey[rows, cols] = pk[k]
        bhi[rows, cols] = hi[k]
        blo[rows, cols] = lo[k]
        bpv[rows, cols] = pv[k]
        blen[bid] = bc
        return FlatArrays(
            node_kind=kind[at].astype(np.uint8),
            node_slope=slope[at].astype(np.float32),
            node_intercept=icpt[at].astype(np.float32),
            node_offset=offset[at].astype(np.int32),
            node_size=size[at].astype(np.int32),
            etype=etype, ekey=ekey, ehi=ehi, elo=elo, epayload=epay,
            echild=echild, bkey=bkey, bhi=bhi, blo=blo, bpayload=bpv,
            blen=blen)

    def finalize(self) -> FlatArrays:
        return self._arrays


class _Fold:
    """Bounded-step fold of the write tiers into a new tree.

    Port of ``repro.core.flat_afli._IncrementalFold``'s contract, not of
    its work items: the JAX fold defers subtrees through hooks of its
    recursive builder, while this builder works a level at a time, so
    the fold advances it a node chunk of about ``fold_step_keys`` keys
    per step (``_Builder.build_steps``).  Phases, each charged to the
    per-call work budget in keys:

    1. ``build`` — one node chunk of a level of the new tree per step,
       the partition into the next level, and the assembly of the pools
       (the snapshot is taken when the fold starts);
    2. ``pack`` — the new pools go to the device beside the serving ones;
    3. ``verify`` — placement through the kernel against the new pools,
       tree only (the tiers are excluded, so a newer write of an identity
       is not mistaken for a misplacement), in chunks of
       ``fold_step_keys``; with a serve flow, again through the in-kernel
       NF.  Keys the kernel cannot find become shadows.

    The old tree and the frozen tiers serve until the swap.  At the swap
    the new tree and scan pool go in together, the run becomes the
    shadows, the active delta (which only grew during the fold, so its
    entries stay newest) carries over untouched, and the capacity floors
    are pinned again."""

    def __init__(self, idx: "FlatAFLI", pk, hi, lo, pv):
        self.idx = idx
        self.pk, self.hi, self.lo, self.pv = pk, hi, lo, pv
        self.n = int(pk.shape[0])
        self.step = max(int(idx.cfg.fold_step_keys), 1)
        self.serve_flow = idx._serve_flow
        self.builder = _Builder(idx.cfg, idx.d_tail)
        self._levels = self.builder.build_steps(pk, hi, lo, pv,
                                                self.step)
        self.phase = "build"
        self.arrays_new: Optional[FlatArrays] = None
        self.pools_new = None
        self.max_depth_new = 1
        self.dense_window_new = 8
        self.chunks = collections.deque()
        self.shadow = []   # [(pk, hi, lo, pv)] chunks for the new run
        # host seconds per phase and write calls that advanced the fold
        self.report = {"keys": self.n, "ticks": 0, "build_s": 0.0,
                       "pack_s": 0.0, "verify_s": 0.0}

    def tick(self, budget: int) -> bool:
        """Work under ``budget`` keys (at least one step a call).
        Returns True once the new tree is live."""
        self.report["ticks"] += 1
        while budget > 0:
            t0 = time.perf_counter()
            phase = self.phase
            if phase == "build":
                cost = next(self._levels, None)
                if cost is None:
                    self.phase = "pack"
                    continue
                budget -= max(cost, 1)
            elif phase == "pack":
                budget -= self._pack()
                self.phase = "verify"
            else:
                if not self.chunks:
                    self._swap()
                    return True
                kind, a, b = self.chunks.popleft()
                self._verify_chunk(a, b, flow=kind == "verify_flow")
                budget -= max(b - a, 1)
            self.report[f"{phase}_s"] += time.perf_counter() - t0
        return False

    def _pack(self) -> int:
        b = self.builder
        self.arrays_new = b.finalize()
        self.pools_new = self.idx._serving.pack_tree(self.arrays_new)
        self.max_depth_new = b.max_depth + 1
        self.dense_window_new = _max_equal_run(self.pk) + 2
        kinds = ("verify",) + (("verify_flow",) if self.serve_flow else ())
        for kind in kinds:
            for a in range(0, self.n, self.step):
                self.chunks.append((kind, a, min(a + self.step, self.n)))
        return max(self.n // 4, 1)

    def _verify_chunk(self, a: int, b: int, flow: bool) -> None:
        idx = self.idx
        hi, lo, pv = self.hi[a:b], self.lo[a:b], self.pv[a:b]
        over = dict(pools=self.pools_new, max_depth=self.max_depth_new,
                    dense_window=self.dense_window_new)
        if flow:
            normalizer, flow_cfg, packed_w, shapes = self.serve_flow
            ik64 = _ids64(hi, lo).view(np.float64)
            feats = expand_features(ik64, normalizer, flow_cfg.dim,
                                    flow_cfg.theta, dtype=np.float32)
            res, pk = idx._dispatch(feats, hi, lo, (packed_w, shapes),
                                    tiers=False, **over)
        else:
            pk = self.pk[a:b]
            res, _ = idx._dispatch(pk.reshape(-1, 1), hi, lo, None,
                                   tiers=False, **over)
        wrong = res != pv
        if wrong.any():
            self.shadow.append((pk[wrong].astype(np.float32), hi[wrong],
                                lo[wrong], pv[wrong]))

    def _swap(self) -> None:
        t0 = time.perf_counter()
        idx = self.idx
        idx.arrays = self.arrays_new
        idx.max_depth = self.max_depth_new
        idx.dense_window = self.dense_window_new
        idx._serving.set_tree(self.arrays_new, self.pools_new)
        # the snapshot IS the new structure's keys in rank order
        idx._set_scan_pool(self.pk, self.hi, self.lo, self.pv)
        if self.shadow:
            pk, hi, lo, pv = (np.concatenate([s[i] for s in self.shadow])
                              for i in range(4))
            order = np.argsort(pk, kind="stable")
            idx._run_pk, idx._run_hi = pk[order], hi[order]
            idx._run_lo, idx._run_pv = lo[order], pv[order].astype(np.int32)
            idx.n_shadowed = int(pk.shape[0])
        else:
            idx._run_pk = np.empty(0, np.float32)
            idx._run_hi = np.empty(0, np.uint32)
            idx._run_lo = np.empty(0, np.uint32)
            idx._run_pv = np.empty(0, np.int32)
            idx.n_shadowed = 0
        idx._sync_run()
        idx._preallocate_tiers(self.n)
        idx.n_rebuilds += 1
        idx.last_fold = dict(self.report, shadowed=idx.n_shadowed,
                             swap_s=time.perf_counter() - t0)
        idx._fold = None


class FlatAFLI:
    """Flat index on one device, served by the port's kernels, with the
    tiered write path: active delta > compacted run > static tree."""

    def __init__(self, cfg: FlatAFLIConfig | None = None,
                 device: Optional[Union[str, torch.device]] = None):
        self.cfg = cfg or FlatAFLIConfig()
        self.device = resolve_device(device)
        self.arrays: Optional[FlatArrays] = None
        self._serving = ServingState(self.device)
        self.last_dispatch = {}
        self.last_scan_dispatch = {}
        self.max_depth = 1
        self.dense_window = 8
        self.d_tail = self.cfg.min_bucket
        self.n_keys = 0
        self.n_shadowed = 0            # keys shadowed into the run tier
        self.n_rebuilds = 0
        self.last_fold = {}            # _Fold.report of the last swap
        self._ids = np.empty(0, np.uint64)   # sorted live identities
        self._serve_flow = None        # (normalizer, flow_cfg, packed_w, shapes)
        self._fold: Optional[_Fold] = None
        self.autoswitch = {"use_flow": None, "tail_original": 0,
                           "tail_transformed": 0}
        self._reset_tiers()

    @staticmethod
    def _check_payloads(pv: np.ndarray) -> None:
        """Payloads must be >= 0: -1 is the miss sentinel, -2 TOMBSTONE."""
        if pv.shape[0] and int(pv.min()) < 0:
            raise ValueError(
                "payloads must be >= 0 (-1/-2 are reserved sentinels); "
                f"got min={int(pv.min())}")

    # -------------------------------------------------------------- build
    def build(self, pkeys: np.ndarray, payloads: np.ndarray,
              ikeys: np.ndarray | None = None) -> None:
        """Bulk build from positioning keys: sort, fit the flattened tree
        with f32 placement arithmetic, pack the pools once onto the
        device, adopt the sorted keys as the range path's scan pool, pin
        the tier capacities, and verify every key's placement through the
        kernel (shadowing any it misses).  ``ikeys`` are the raw 64-bit
        identity keys when ``pkeys`` are flow-transformed.  Writes
        buffered before the build are dropped."""
        pk64 = np.asarray(pkeys, dtype=np.float64)
        ik64 = pk64 if ikeys is None else np.asarray(ikeys, dtype=np.float64)
        pv = np.asarray(payloads, dtype=np.int64)
        self._check_payloads(pv)
        order = np.argsort(pk64, kind="stable")
        pk64, ik64, pv = pk64[order], ik64[order], pv[order]
        pk32 = pk64.astype(np.float32)
        # f32 can reorder near-equal keys; re-sort by pk32 stably
        order2 = np.argsort(pk32, kind="stable")
        pk32, ik64, pv = pk32[order2], ik64[order2], pv[order2]
        hi, lo = split_key_bits(ik64)

        model = fit_linear_model(pk32.astype(np.float64))
        if pk32.shape[0] >= 2 and model.slope > 0:
            d = tail_conflict_degree(
                conflict_degrees(pk32.astype(np.float64), model),
                self.cfg.gamma)
        else:
            d = self.cfg.max_bucket
        if ikeys is not None:
            use, t_orig, t_flow = should_use_flow(ik64, pk32, self.cfg.gamma)
            self.autoswitch = {"use_flow": bool(use),
                               "tail_original": int(t_orig),
                               "tail_transformed": int(t_flow)}
        else:
            self.autoswitch = {"use_flow": False, "tail_original": int(d),
                               "tail_transformed": int(d)}
        self.d_tail = int(np.clip(d, self.cfg.min_bucket, self.cfg.max_bucket))

        builder = _Builder(self.cfg, self.d_tail)
        builder.build(pk32, hi, lo, pv)
        self.arrays = builder.finalize()
        self.max_depth = builder.max_depth + 1
        self.dense_window = _max_equal_run(pk32) + 2
        self._serving.set_tree(self.arrays)
        self._reset_tiers()
        self._preallocate_tiers(pk32.shape[0])
        self._set_scan_pool(pk32, hi, lo, pv)
        self._ids = np.unique(_ids64(hi, lo))
        self.n_keys = int(self._ids.shape[0])
        self.n_shadowed = 0
        self._self_verify(pk32, hi, lo, pv.astype(np.int32))

    def _reset_tiers(self) -> None:
        self._delta_pk = np.empty(0, np.float32)
        self._delta_hi = np.empty(0, np.uint32)
        self._delta_lo = np.empty(0, np.uint32)
        self._delta_pv = np.empty(0, np.int32)
        self._run_pk = np.empty(0, np.float32)
        self._run_hi = np.empty(0, np.uint32)
        self._run_lo = np.empty(0, np.uint32)
        self._run_pv = np.empty(0, np.int32)
        self._serving.reset_tiers()
        self._fold = None

    def _preallocate_tiers(self, n: int) -> None:
        """Pin the tier capacities from the configured write bounds: the
        delta holds up to ``delta_cap`` between merges and keeps taking
        writes while a fold runs, the run peaks near the fold trigger,
        and the scan pool holds the live keys plus the same headroom;
        8x ``delta_cap`` over each keeps a steady write window from
        reallocating."""
        cfg = self.cfg
        n = max(int(n), 1)
        slack = 8 * cfg.delta_cap + 1
        self._serving.preallocate(
            delta_floor=slack,
            run_floor=int(cfg.rebuild_frac * n) + slack,
            scan_floor=int((1.0 + cfg.rebuild_frac) * n) + slack)

    def _set_scan_pool(self, pk, hi, lo, pv) -> None:
        """Ship the (re)built structure's sorted keys to the range path's
        scan pool: at build and fold swap only, off the serve path."""
        self._serving.set_scan(pk, hi, lo, np.asarray(pv, np.int32),
                               _tier_window(pk))

    def set_serve_flow(self, normalizer, flow_cfg, packed_w, shapes) -> None:
        """Register the serve-path flow context (normalizer, config and
        the packed weights the fused kernels evaluate); every fold
        verifies placement through it as well."""
        self._serve_flow = (normalizer, flow_cfg, packed_w, shapes)

    def _has(self, ids: np.ndarray) -> np.ndarray:
        """Membership of u64 identities in the live set."""
        if not self._ids.shape[0]:
            return np.zeros(ids.shape[0], bool)
        j = np.minimum(np.searchsorted(self._ids, ids),
                       self._ids.shape[0] - 1)
        return self._ids[j] == ids

    def contains_batch(self, ikeys: np.ndarray) -> np.ndarray:
        """Exact membership by 64-bit identity (tree and tiers: a
        tombstoned key is absent until it is inserted again)."""
        hi, lo = split_key_bits(np.asarray(ikeys, dtype=np.float64))
        return self._has(_ids64(hi, lo))

    # ---------------------------------------------------- device dispatch
    def _kernel_pools(self) -> KernelPools:
        """The serving tree pools; an index that was never built serves
        an empty tree, so every read resolves from the tiers."""
        if self._serving.tree_pools is None:
            self._serving.set_tree(FlatArrays.empty(self.cfg.max_bucket))
        return self._serving.tree_pools

    def _tier_pack(self):
        return self._serving.tier_pack()

    def _streams(self, live: bool) -> bool:
        """Whether a point dispatch takes the streamed rung: only a live
        read, and only when the tree pools' bytes exceed ``pool_budget``.
        A placement verify probes a tree (a fold's candidate, or the tree
        it checks) that the live scan pool does not stand for."""
        budget = self.cfg.pool_budget
        return (live and budget is not None
                and self._kernel_pools().nbytes() > budget)

    def _launch(self, feats: np.ndarray, hi: np.ndarray, lo: np.ndarray,
                flow, tiers: bool, pools=None, max_depth=None,
                dense_window=None, verify: bool = False, stream=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Launch one point-read kernel for the batch and return its
        (payloads, z) device tensors without waiting.  The pools, tiers
        and rung are taken on the current stream; with ``stream`` (a
        ``torch.cuda.Stream``), the batch's uploads, the kernel and
        whatever the caller enqueues in ``_on_stream`` run there, after
        the current stream's work.  A fold verifies its new tree by
        passing that tree's pools, depth and window.  Only a live read
        (tiers probed, the serving tree, not a verify) may stream."""
        dev = self.device
        tier_pack = self._tier_pack() if tiers else None
        live = pools is None and tiers and not verify
        rung = self._serving.stream_pack() if self._streams(live) else None
        pools = self._kernel_pools() if pools is None else pools
        with _on_stream(stream):
            pay, z, path = ops.fused_lookup(
                pools, _upload(feats, np.float32, dev),
                _upload(hi, np.int32, dev), _upload(lo, np.int32, dev),
                flow=flow,
                max_depth=self.max_depth if max_depth is None else max_depth,
                dense_iters=self.cfg.dense_search_iters,
                bucket_cap=self.cfg.max_bucket,
                dense_window=(self.dense_window if dense_window is None
                              else dense_window),
                tiers=tier_pack, stream=rung)
        self.last_dispatch = {"path": path, "n_dispatch": 1,
                              "tier_path": ("kernel" if tier_pack is not None
                                            else "none")}
        return pay, z

    def _dispatch(self, feats: np.ndarray, hi: np.ndarray, lo: np.ndarray,
                  flow, tiers: bool, pools=None, max_depth=None,
                  dense_window=None, verify: bool = False
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """``_launch``, then bring (payloads, z) back."""
        pay, z = self._launch(feats, hi, lo, flow, tiers, pools, max_depth,
                              dense_window, verify)
        return pay.cpu().numpy(), z.cpu().numpy()

    def _device_lookup(self, pk32: np.ndarray, hi: np.ndarray,
                       lo: np.ndarray, tiers: bool = True) -> np.ndarray:
        """Non-flow fused dispatch on f32 positioning keys."""
        return self._dispatch(np.asarray(pk32, np.float32).reshape(-1, 1),
                              hi, lo, None, tiers)[0]

    def _self_verify(self, pk32, hi, lo, pv) -> None:
        """Device-verified placement: any built key the kernel cannot
        find by its positioning key is shadowed into the run tier, whose
        probe compares identities only."""
        res = self._device_lookup(pk32, hi, lo, tiers=False)
        wrong = res != pv
        if wrong.any():
            self._append_run(pk32[wrong], hi[wrong], lo[wrong], pv[wrong])
            self.n_shadowed += int(wrong.sum())

    # ------------------------------------------------------- write tiers
    def _sync_run(self) -> None:
        self._serving.run.refresh(self._run_pk, self._run_hi, self._run_lo,
                                  self._run_pv, _tier_window(self._run_pk))

    def _sync_delta(self) -> None:
        self._serving.delta.refresh(self._delta_pk, self._delta_hi,
                                    self._delta_lo, self._delta_pv,
                                    _tier_window(self._delta_pk))

    def _append_delta(self, pk, hi, lo, pv) -> None:
        """Append a batch to the active delta, last write wins by 64-bit
        identity (the batch is newer than the delta, and later entries of
        the batch are newer than earlier ones), and ship it."""
        (self._delta_pk, self._delta_hi,
         self._delta_lo, self._delta_pv) = _dedup_newest(
            np.concatenate([self._delta_pk, pk.astype(np.float32)]),
            np.concatenate([self._delta_hi, hi]),
            np.concatenate([self._delta_lo, lo]),
            np.concatenate([self._delta_pv, pv.astype(np.int32)]))
        self._sync_delta()

    def _append_run(self, pk, hi, lo, pv) -> None:
        """Merge entries into the compacted run (last write wins by
        64-bit identity) and ship the run to the device."""
        (self._run_pk, self._run_hi,
         self._run_lo, self._run_pv) = _dedup_newest(
            np.concatenate([self._run_pk, pk.astype(np.float32)]),
            np.concatenate([self._run_hi, hi]),
            np.concatenate([self._run_lo, lo]),
            np.concatenate([self._run_pv, pv.astype(np.int32)]))
        self._sync_run()

    def _merge_delta_into_run(self) -> None:
        """Retire the active delta into the compacted run."""
        if not self._delta_pk.shape[0]:
            return
        self._append_run(self._delta_pk, self._delta_hi, self._delta_lo,
                         self._delta_pv)
        self._delta_pk = np.empty(0, np.float32)
        self._delta_hi = np.empty(0, np.uint32)
        self._delta_lo = np.empty(0, np.uint32)
        self._delta_pv = np.empty(0, np.int32)
        self._sync_delta()

    # ------------------------------------------------------------ writes
    def insert_batch(self, keys: np.ndarray, payloads: np.ndarray,
                     ikeys: np.ndarray | None = None) -> None:
        """Tiered write: the batch lands in the active delta (probed
        inside the fused kernels); a full delta merges into the run; a
        run past ``rebuild_frac`` of the live keys starts a fold, which
        every write call advances by a bounded work budget."""
        k64 = np.asarray(keys, dtype=np.float64)
        ik64 = k64 if ikeys is None else np.asarray(ikeys, dtype=np.float64)
        pv = np.asarray(payloads, dtype=np.int32)
        self._check_payloads(pv)
        pk = k64.astype(np.float32)
        hi, lo = split_key_bits(ik64)
        self._append_delta(pk, hi, lo, pv)
        self._add_ids(_ids64(hi, lo))
        self._advance_write_path(pk.shape[0])

    def _add_ids(self, ids: np.ndarray) -> None:
        """Add u64 identities to the live set; only identities not live
        yet count (a re-insert overwrites)."""
        ids = np.unique(ids)
        fresh = ids[~self._has(ids)]
        self._ids = np.insert(self._ids, np.searchsorted(self._ids, fresh),
                              fresh)
        self.n_keys += int(fresh.shape[0])

    def delete_batch(self, keys: np.ndarray,
                     ikeys: np.ndarray | None = None) -> np.ndarray:
        """Tombstone deletes: each present key appends a TOMBSTONE to the
        active delta, the newest copy of its identity, which masks every
        older copy on the point and range paths; the next fold drops it.
        Returns per-key success: False for an absent key, and for the
        second delete of one key within a batch."""
        k64 = np.asarray(keys, dtype=np.float64)
        ik64 = k64 if ikeys is None else np.asarray(ikeys, dtype=np.float64)
        pk = k64.astype(np.float32)
        hi, lo = split_key_bits(ik64)
        ids = _ids64(hi, lo)
        uniq, first = np.unique(ids, return_index=True)
        live = self._has(uniq)
        ok = np.zeros(ids.shape[0], dtype=bool)
        ok[first[live]] = True
        if ok.any():
            self._ids = np.delete(self._ids,
                                  np.searchsorted(self._ids, uniq[live]))
            n_del = int(ok.sum())
            self.n_keys -= n_del
            self._append_delta(pk[ok], hi[ok], lo[ok],
                               np.full(n_del, TOMBSTONE, np.int32))
            self._advance_write_path(n_del)
        return ok

    def _advance_write_path(self, n_batch: int) -> None:
        """After a write: advance a fold in flight by the per-call
        budget, retire a full delta into the run, and start a fold when
        the run outgrows its bound.  The call that starts a fold has
        spent the snapshot's keys of its budget on the snapshot (an
        O(n) merge and sort), and ticks only with what is left.  An
        index never built keeps buffering: there is no tree to fold
        into."""
        budget = max(int(self.cfg.fold_step_keys),
                     int(self.cfg.fold_work_factor * max(n_batch, 1)))
        if self._fold is not None:
            self._fold_tick(budget)
        if self._fold is None:
            if self._delta_pk.shape[0] > self.cfg.delta_cap:
                self._merge_delta_into_run()
            if (self.arrays is not None
                    and self._run_pk.shape[0]
                    > self.cfg.rebuild_frac * max(self.n_keys, 1)):
                self._fold_start()
                if self._fold is not None and budget > self._fold.n:
                    self._fold_tick(budget - self._fold.n)

    # -------------------------------------------------------------- fold
    def _snapshot_live(self):
        """Freeze the live keyset: merge the delta into the run, gather
        static DATA entries (oldest), bucket entries, then the run
        (newest), keep the newest copy of each identity and drop the
        tombstoned ones.  Returns ``(pk, hi, lo, pv)`` sorted by pk."""
        self._merge_delta_into_run()
        if self.arrays is not None:
            a = self.arrays
            data = a.etype == DATA
            bmask = np.arange(self.cfg.max_bucket)[None, :] < a.blen[:, None]
            pk = np.concatenate([a.ekey[data], a.bkey[bmask], self._run_pk])
            hi = np.concatenate([a.ehi[data], a.bhi[bmask], self._run_hi])
            lo = np.concatenate([a.elo[data], a.blo[bmask], self._run_lo])
            pv = np.concatenate([a.epayload[data], a.bpayload[bmask],
                                 self._run_pv])
        else:
            pk, hi, lo, pv = (self._run_pk, self._run_hi, self._run_lo,
                              self._run_pv)
        pk, hi, lo, pv = _dedup_newest(pk, hi, lo, np.asarray(pv, np.int64))
        live = pv != TOMBSTONE
        if not live.all():
            pk, hi, lo, pv = pk[live], hi[live], lo[live], pv[live]
        return pk, hi, lo, pv

    def _fold_start(self) -> None:
        """Begin a fold over a snapshot of the live keys.  If every key
        is tombstoned there is nothing to fold into: the old tree keeps
        serving and the run keeps the tombstones that mask it."""
        t0 = time.perf_counter()
        pk, hi, lo, pv = self._snapshot_live()
        if pk.shape[0]:
            self._fold = _Fold(self, pk, hi, lo, pv)
            self._fold.report["snapshot_s"] = time.perf_counter() - t0

    def _fold_tick(self, budget: int) -> None:
        if self._fold is not None and self._fold.tick(budget):
            # swapped in: apply a delta merge deferred during the fold
            if self._delta_pk.shape[0] > self.cfg.delta_cap:
                self._merge_delta_into_run()

    def rebuild(self) -> None:
        """Fold every write tier into the tree now: finish a fold in
        flight (its snapshot misses the writes made since), then fold
        what is left."""
        if self.arrays is None:
            return
        while self._fold is not None:
            self._fold_tick(1 << 62)
        self._fold_start()
        while self._fold is not None:
            self._fold_tick(1 << 62)

    def start_reflow(self, transform_fn, serve_flow, on_swap) -> bool:
        raise NotImplementedError(
            "FlatAFLI.start_reflow (re-keying folds) is not ported to "
            "repro_torch yet (ROADMAP A11)")

    # ------------------------------------------------------------- lookup
    def lookup_batch_async(self, keys: np.ndarray,
                           ikeys: np.ndarray | None = None, stream=None):
        """Launch a batched lookup (as ``lookup_batch``) and return a
        zero-argument finisher that waits for it and returns the
        payloads.  The kernel and the copy of its payloads into pinned
        host memory are in flight when this returns, so a caller can
        dispatch more batches (or, as the sharded index does, every
        shard's batch, each on its own ``stream``) before finishing any.
        The kernel reads the tiers as they are at dispatch: a write
        enqueued after it on the same stream runs after it, and a write
        to an index served on another stream must first make the
        current stream wait on that one (``ShardedFlatAFLI`` does)."""
        k64 = np.asarray(keys, dtype=np.float64)
        ik64 = k64 if ikeys is None else np.asarray(ikeys, dtype=np.float64)
        hi, lo = split_key_bits(ik64)
        pay, _z = self._launch(k64.astype(np.float32).reshape(-1, 1), hi, lo,
                               None, True, stream=stream)
        with _on_stream(stream, wait=False):
            return _fetch_async(pay)

    def lookup_batch(self, keys: np.ndarray,
                     ikeys: np.ndarray | None = None) -> np.ndarray:
        """Batched point lookups by positioning keys (-1: not found);
        ``ikeys`` are the identity keys when ``keys`` are transformed."""
        return self.lookup_batch_async(keys, ikeys)()

    def _flow_device_lookup(self, feats, hi, lo, packed_w, shapes,
                            verify: bool = False):
        return self._dispatch(np.asarray(feats, np.float32), hi, lo,
                              (packed_w, shapes), True, verify=verify)

    def lookup_batch_flow_async(self, feats: np.ndarray, ikeys: np.ndarray,
                                packed_w, shapes, stream=None):
        """Flow-positioned twin of ``lookup_batch_async``: the fused
        kernel (NF in the kernel, traversal, tier probe) is launched and
        a finisher returned."""
        hi, lo = split_key_bits(np.asarray(ikeys, dtype=np.float64))
        pay, _z = self._launch(np.asarray(feats, np.float32), hi, lo,
                               (packed_w, shapes), True, stream=stream)
        with _on_stream(stream, wait=False):
            return _fetch_async(pay)

    def lookup_batch_flow(self, feats: np.ndarray, ikeys: np.ndarray,
                          packed_w, shapes) -> np.ndarray:
        """Single-dispatch serving for flow-positioned indexes: the fused
        kernel runs the NF forward on ``feats`` (f32[n, d] expanded query
        features), the traversal and the tier probe."""
        return self.lookup_batch_flow_async(feats, ikeys, packed_w,
                                            shapes)()

    def verify_serve_flow(self, feats: np.ndarray, ikeys: np.ndarray,
                          packed_w, shapes, payloads: np.ndarray) -> int:
        """Serve-path placement check: any built key the fused kernel
        (in-kernel NF) cannot resolve is shadowed into the run tier under
        its served positioning key.  It checks the tree, so it stays on
        the fused rung whatever ``pool_budget`` says.  Returns the number
        shadowed."""
        hi, lo = split_key_bits(np.asarray(ikeys, dtype=np.float64))
        res, z = self._flow_device_lookup(feats, hi, lo, packed_w, shapes,
                                          verify=True)
        wrong = res != np.asarray(payloads, res.dtype)
        if wrong.any():
            self._append_run(z[wrong], hi[wrong], lo[wrong],
                             np.asarray(payloads)[wrong].astype(np.int32))
            self.n_shadowed += int(wrong.sum())
        return int(wrong.sum())

    # -------------------------------------------------------- range scan
    def scan_batch(self, lo_keys: np.ndarray, hi_keys: np.ndarray,
                   cap: int | None = None):
        """Batched ``[lo, hi)`` range scans over positioning-key order.
        Returns ``(payloads i32[n, cap] (-1 padded), counts i32[n],
        totals i32[n])``: per query the first ``counts[i]`` lanes are the
        live entries in range, in key order; ``totals[i] > cap`` flags
        truncation (``cap`` bounds the candidates examined).  Without a
        flow the positioning order is the key order (the f32 cast is
        monotone)."""
        lo32 = np.asarray(lo_keys, dtype=np.float64).astype(np.float32)
        hi32 = np.asarray(hi_keys, dtype=np.float64).astype(np.float32)
        return self._device_scan(lo32.reshape(-1, 1), hi32.reshape(-1, 1),
                                 flow=None, cap=cap)

    def scan_batch_flow(self, feats_lo: np.ndarray, feats_hi: np.ndarray,
                        packed_w, shapes, cap: int | None = None):
        """Range scans for flow-positioned indexes: one launch runs the
        NF on both endpoints (``expand_features`` of the raw keys), the
        lower bounds and the tier-merged emission."""
        return self._device_scan(feats_lo, feats_hi,
                                 flow=(packed_w, shapes), cap=cap)

    def _device_scan(self, feats_lo: np.ndarray, feats_hi: np.ndarray, *,
                     flow, cap: int | None):
        """One ``ops.fused_range_scan`` launch for the whole batch (the
        kernel takes any batch size, so nothing is padded)."""
        cap = int(cap if cap is not None else self.cfg.scan_cap)
        dev = self.device
        tiers = self._tier_pack()
        pv, cnt, tot, _zlo, _zhi = ops.fused_range_scan(
            self._serving.scan_pack(), tiers,
            torch.from_numpy(np.ascontiguousarray(feats_lo, np.float32)
                             ).to(dev),
            torch.from_numpy(np.ascontiguousarray(feats_hi, np.float32)
                             ).to(dev),
            flow=flow, scan_cap=cap)
        tot = tot.cpu().numpy()
        self.last_scan_dispatch = {
            "path": "fused", "n_dispatch": 1,
            "truncated": int((tot > cap).sum()),
            "tier_path": "kernel" if tiers is not None else "none"}
        return pv.cpu().numpy(), cnt.cpu().numpy(), tot

    def stats(self):
        """Structure sizes, tier lengths, fold state and the
        serving-state counters."""
        a = self.arrays
        return {
            "n_nodes": int(a.node_kind.shape[0]) if a is not None else 0,
            "n_entries": int(a.etype.shape[0]) if a is not None else 0,
            "n_buckets": int(a.blen.shape[0]) if a is not None else 0,
            "max_depth": self.max_depth,
            "n_keys": self.n_keys,
            "n_shadowed": self.n_shadowed,
            "delta_len": int(self._delta_pk.shape[0]),
            "run_len": int(self._run_pk.shape[0]),
            "fold_active": self._fold is not None,
            "n_rebuilds": self.n_rebuilds,
            "last_fold": dict(self.last_fold),
            "scan_pool_len": self._serving.scan.length,
            "serving": self._serving.stats(),
        }
