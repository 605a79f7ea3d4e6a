"""FlatAFLI — the flattened AFLI index, served by the port's fused kernel.

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
that also probes the run tier.  ``_self_verify`` and
``verify_serve_flow`` look every built key up through that kernel and
shadow any key it cannot find into the run tier (keyed by the served
positioning key).  With the kernel's slot arithmetic rounding exactly as
the builder's does, the shadow set is expected to be empty; the net
stays.

Not ported yet: the write path (``insert_batch``/``delete_batch``,
the delta tier, incremental folds — ROADMAP A6) and range scans
(ROADMAP A8).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.conflict import (conflict_degrees, fit_linear_model,
                                       should_use_flow, tail_conflict_degree)
from repro_torch.core.serving_state import ServingState
from repro_torch.kernels import ops
from repro_torch.kernels.backend import resolve_device
from repro_torch.kernels.fused_lookup import (BUCKET, CHILD, DATA, KIND_DENSE,
                                              KIND_MODEL, TOMBSTONE,
                                              KernelPools)

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


def _tier_window(pk_pool: np.ndarray) -> int:
    """Probe window of one sorted tier: its longest run of equal
    positioning keys (at least 1)."""
    return max(_max_equal_run(pk_pool), 1)


@dataclasses.dataclass(frozen=True)
class FlatAFLIConfig:
    gamma: float = 0.99
    max_bucket: int = 6
    min_bucket: int = 2
    alpha: float = 1.2
    max_depth: int = 16
    dense_search_iters: int = 24      # binary-search rounds (2^24 max dense)


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
        cfg = self.cfg
        alpha = cfg.alpha
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
            level_start.append(n_nodes)
            ids = n_nodes + np.arange(s0.shape[0])
            n_nodes += s0.shape[0]
            if (~forced).any():
                self.max_depth = max(self.max_depth, int(dep[~forced].max()))
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
            kind.append(np.where(dense, KIND_DENSE, KIND_MODEL))
            slope_n.append(mslope)
            icpt_n.append(micpt)
            size_n.append(size)
            parent.append(par)
            dj = np.flatnonzero(dense)
            dense_w.append(np.stack([ids[dj], s0[dj]], 1))

            # slot groups of every model node of the level
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
            data_w.append(np.stack([gnode[single], gslot[single],
                                    gkey[single]], 1))
            bucket_w.append(np.stack([gnode[bk], gslot[bk], gkey[bk],
                                      gcount[bk]], 1))
            # children: maximal runs of adjacent big slots of one node
            g = np.flatnonzero(big)
            new_run = np.r_[True, (np.diff(g) != 1) | (np.diff(gseg[g]) != 0)
                            | (np.diff(gslot[g]) != 1)][:g.shape[0]]
            fg = g[new_run]
            lg = g[np.r_[new_run[1:], True]] if g.shape[0] else g
            i0 = gkey[fg]
            tot = gkey[lg] + gcount[lg] - i0
            child_w.append(np.stack([gnode[fg], gslot[fg], gslot[lg],
                                     n_nodes + np.arange(fg.shape[0])], 1))
            s0, n = i0, tot
            dep = dep[model][gseg[fg]] + 1
            par = gnode[fg]
            forced = tot == nm[gseg[fg]]
        level_start.append(n_nodes)
        self._arrays = self._assemble(
            pk, hi, lo, pv, np.concatenate(kind), np.concatenate(slope_n),
            np.concatenate(icpt_n), np.concatenate(size_n),
            np.concatenate(parent), level_start,
            np.concatenate(dense_w), np.concatenate(data_w),
            np.concatenate(bucket_w), np.concatenate(child_w))
        return 0

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


class FlatAFLI:
    """Static flat index on one device, served by the fused kernel, with
    the run tier as the home of shadowed keys."""

    def __init__(self, cfg: FlatAFLIConfig | None = None,
                 device: Optional[Union[str, torch.device]] = None):
        self.cfg = cfg or FlatAFLIConfig()
        self.device = resolve_device(device)
        self.arrays: Optional[FlatArrays] = None
        self._serving = ServingState(self.device)
        self.last_dispatch = {}
        self.max_depth = 1
        self.dense_window = 8
        self.d_tail = self.cfg.min_bucket
        self.n_keys = 0
        self.n_shadowed = 0            # keys shadowed into the run tier
        self._ids = np.empty(0, np.uint64)   # sorted live identities
        self._serve_flow = None        # (normalizer, flow_cfg, packed_w, shapes)
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
        device, and verify every key's placement through the kernel
        (shadowing any it misses).  ``ikeys`` are the raw 64-bit identity keys when ``pkeys`` are
        flow-transformed."""
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
        self._ids = np.unique(_ids64(hi, lo))
        self.n_keys = int(self._ids.shape[0])
        self.n_shadowed = 0
        self._self_verify(pk32, hi, lo, pv.astype(np.int32))

    def _reset_tiers(self) -> None:
        self._run_pk = np.empty(0, np.float32)
        self._run_hi = np.empty(0, np.uint32)
        self._run_lo = np.empty(0, np.uint32)
        self._run_pv = np.empty(0, np.int32)
        self._serving.reset_tiers()

    def set_serve_flow(self, normalizer, flow_cfg, packed_w, shapes) -> None:
        """Register the serve-path flow context (normalizer, config and
        the packed weights the fused kernel evaluates)."""
        self._serve_flow = (normalizer, flow_cfg, packed_w, shapes)

    def contains_batch(self, ikeys: np.ndarray) -> np.ndarray:
        """Exact membership by 64-bit identity."""
        hi, lo = split_key_bits(np.asarray(ikeys, dtype=np.float64))
        ids = _ids64(hi, lo)
        if not self._ids.shape[0]:
            return np.zeros(ids.shape[0], bool)
        j = np.minimum(np.searchsorted(self._ids, ids),
                       self._ids.shape[0] - 1)
        return self._ids[j] == ids

    # ---------------------------------------------------- device dispatch
    def _kernel_pools(self) -> KernelPools:
        return self._serving.tree_pools

    def _tier_pack(self):
        return self._serving.tier_pack()

    def _dispatch(self, feats: np.ndarray, hi: np.ndarray, lo: np.ndarray,
                  flow, tiers: bool) -> Tuple[np.ndarray, np.ndarray]:
        """Move the batch to the device, launch the fused kernel once,
        and bring (payloads, z) back."""
        if self.arrays is None:
            raise RuntimeError("FlatAFLI.build must run before lookups")
        dev = self.device
        tier_pack = self._tier_pack() if tiers else None
        pay, z = ops.fused_lookup(
            self._kernel_pools(),
            torch.from_numpy(np.ascontiguousarray(feats, np.float32)).to(dev),
            torch.from_numpy(np.ascontiguousarray(hi).view(np.int32)).to(dev),
            torch.from_numpy(np.ascontiguousarray(lo).view(np.int32)).to(dev),
            flow=flow, max_depth=self.max_depth,
            dense_iters=self.cfg.dense_search_iters,
            bucket_cap=self.cfg.max_bucket,
            dense_window=self.dense_window, tiers=tier_pack)
        self.last_dispatch = {"path": "fused", "n_dispatch": 1,
                              "tier_path": ("kernel" if tier_pack is not None
                                            else "none")}
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

    def _append_run(self, pk, hi, lo, pv) -> None:
        """Merge entries into the compacted run (last write wins by
        64-bit identity) and ship the run to the device."""
        (self._run_pk, self._run_hi,
         self._run_lo, self._run_pv) = _dedup_newest(
            np.concatenate([self._run_pk, pk.astype(np.float32)]),
            np.concatenate([self._run_hi, hi]),
            np.concatenate([self._run_lo, lo]),
            np.concatenate([self._run_pv, pv.astype(np.int32)]))
        self._serving.run.refresh(self._run_pk, self._run_hi, self._run_lo,
                                  self._run_pv, _tier_window(self._run_pk))

    # ------------------------------------------------------------- lookup
    def lookup_batch(self, keys: np.ndarray,
                     ikeys: np.ndarray | None = None) -> np.ndarray:
        """Batched point lookups by positioning keys (-1: not found);
        ``ikeys`` are the identity keys when ``keys`` are transformed."""
        k64 = np.asarray(keys, dtype=np.float64)
        ik64 = k64 if ikeys is None else np.asarray(ikeys, dtype=np.float64)
        hi, lo = split_key_bits(ik64)
        return self._device_lookup(k64.astype(np.float32), hi, lo)

    def _flow_device_lookup(self, feats, hi, lo, packed_w, shapes):
        return self._dispatch(np.asarray(feats, np.float32), hi, lo,
                              (packed_w, shapes), True)

    def lookup_batch_flow(self, feats: np.ndarray, ikeys: np.ndarray,
                          packed_w, shapes) -> np.ndarray:
        """Single-dispatch serving for flow-positioned indexes: the fused
        kernel runs the NF forward on ``feats`` (f32[n, d] expanded query
        features), the traversal and the tier probe."""
        hi, lo = split_key_bits(np.asarray(ikeys, dtype=np.float64))
        return self._flow_device_lookup(feats, hi, lo, packed_w, shapes)[0]

    def verify_serve_flow(self, feats: np.ndarray, ikeys: np.ndarray,
                          packed_w, shapes, payloads: np.ndarray) -> int:
        """Serve-path placement check: any built key the fused kernel
        (in-kernel NF) cannot resolve is shadowed into the run tier under
        its served positioning key.  Returns the number shadowed."""
        hi, lo = split_key_bits(np.asarray(ikeys, dtype=np.float64))
        res, z = self._flow_device_lookup(feats, hi, lo, packed_w, shapes)
        wrong = res != np.asarray(payloads, res.dtype)
        if wrong.any():
            self._append_run(z[wrong], hi[wrong], lo[wrong],
                             np.asarray(payloads)[wrong].astype(np.int32))
            self.n_shadowed += int(wrong.sum())
        return int(wrong.sum())

    def stats(self):
        """Structure sizes, tier lengths and the serving-state counters."""
        a = self.arrays
        return {
            "n_nodes": int(a.node_kind.shape[0]) if a is not None else 0,
            "n_entries": int(a.etype.shape[0]) if a is not None else 0,
            "n_buckets": int(a.blen.shape[0]) if a is not None else 0,
            "max_depth": self.max_depth,
            "n_keys": self.n_keys,
            "n_shadowed": self.n_shadowed,
            "run_len": int(self._run_pk.shape[0]),
            "serving": self._serving.stats(),
        }
