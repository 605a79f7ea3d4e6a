"""Shard router for key-space-partitioned serving (DESIGN.md §13).

Port of ``repro.kernels.shard_dispatch``.  The positioning-key domain
(z-space when the flow is on) is split into P contiguous shards: shard
``s`` owns ``[B[s-1], B[s])`` for a sorted f32 boundary vector ``B`` of
length P-1 (``-inf`` / ``+inf`` at the ends), drawn at equal-mass
quantiles of the build's positioning keys.

With the flow on, ``route_flow`` launches the NF kernel (``nf_forward``,
the same routine that positioned the build and every insert) on the
batch's features and bins the z on the card with one ``searchsorted``
over the P-1 boundaries, the binning the JAX package also leaves outside
any Pallas kernel.  Flow off, and for every write, ``route`` bins on the
host.  The fan-out plan (``bin_by_shard`` / ``fanout_plan``) and the
range split (``split_ranges``) are host numpy, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.nf_forward import nf_forward

__all__ = [
    "choose_boundaries",
    "refresh_boundaries",
    "route",
    "route_flow",
    "bin_by_shard",
    "fanout_plan",
    "split_ranges",
]


def choose_boundaries(pk32_sorted: np.ndarray, n_shards: int) -> np.ndarray:
    """Equal-mass shard boundaries: f32[``n_shards - 1``] at the
    ``s / n_shards`` quantiles of the ascending f32 positioning keys.
    Duplicate-heavy key sets can give equal boundaries (an empty shard),
    which serving tolerates."""
    n = int(pk32_sorted.shape[0])
    P = int(n_shards)
    if P < 2:
        return np.empty(0, np.float32)
    idx = (np.arange(1, P, dtype=np.int64) * n) // P
    b = np.asarray(pk32_sorted, np.float32)[np.clip(idx, 0, max(n - 1, 0))]
    return np.ascontiguousarray(b, np.float32)


def refresh_boundaries(boundaries, interior, lo: int) -> np.ndarray:
    """Value-only boundary refresh of a boundary migration (§18): write
    ``interior`` over positions ``lo .. lo + len(interior) - 1`` and
    check that the vector stays non-decreasing (a splice that broke the
    order would mis-route every query past it).  Returns the new
    f32[P-1] host vector.  (The JAX package splices in a jitted
    ``dynamic_update_slice`` to keep one trace; a slice assignment does
    the same here.)"""
    b = np.asarray(boundaries, np.float32)
    it = np.asarray(interior, np.float32)
    lo = int(lo)
    if it.shape[0] == 0:
        return b.copy()
    if lo < 0 or lo + it.shape[0] > b.shape[0]:
        raise ValueError(
            f"boundary splice [{lo}, {lo + it.shape[0]}) outside the "
            f"boundary vector of length {b.shape[0]}")
    out = b.copy()
    out[lo:lo + it.shape[0]] = it
    if out.shape[0] > 1 and np.any(np.diff(out) < 0):
        raise ValueError("boundary splice breaks routing monotonicity")
    return np.ascontiguousarray(out, np.float32)


def route(z32: np.ndarray, boundaries) -> np.ndarray:
    """Shard ids of positioning keys: the count of boundaries <= z
    (``searchsorted`` right), the binning ``route_flow`` does on the
    card.  Empty boundaries: one shard."""
    z32 = np.asarray(z32, np.float32)
    if boundaries is None or boundaries.shape[0] == 0:
        return np.zeros(z32.shape[0], np.int32)
    return np.searchsorted(np.asarray(boundaries, np.float32), z32,
                           side="right").astype(np.int32)


def route_flow(feats: np.ndarray, packed_w: torch.Tensor, shapes,
               boundaries: Optional[torch.Tensor],
               device: torch.device) -> Tuple[np.ndarray, np.ndarray]:
    """Flow-on routing: expanded query features -> ``(z f32[n], shard id
    i32[n])`` on the host.  One ``nf_forward`` launch on ``device`` (its
    plain version on the CPU) gives z bit-equal to the z the shards were
    built and written with, then ``searchsorted`` over ``boundaries``
    (f32[P-1] on ``device``, or None for one shard) bins it there.  The
    kernel takes any batch size, so nothing is padded."""
    feats = np.ascontiguousarray(feats, np.float32)
    z = nf_forward(torch.from_numpy(feats).to(device), packed_w, shapes,
                   int(feats.shape[1]))
    if boundaries is None or boundaries.shape[0] == 0:
        return z.cpu().numpy(), np.zeros(feats.shape[0], np.int32)
    sid = torch.searchsorted(boundaries, z, right=True).to(torch.int32)
    # one copy back for both halves
    both = torch.stack([z.view(torch.int32), sid]).cpu().numpy()
    return both[0].view(np.float32), both[1]


def bin_by_shard(sids: np.ndarray, n_shards: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fan-out plan from routed shard ids: ``(order, counts, inv)``.
    ``order`` is a stable shard-major permutation (input order kept
    within a shard, so a shard's write batch stays age-ordered);
    ``counts[s]`` is shard s's group length; ``gathered[inv]`` restores
    input order from shard-major results.  The ids are sorted as the
    narrowest unsigned type that holds them, which numpy's stable sort
    takes by radix (about 9x faster than on i32 at 65,536 ids)."""
    sids = np.asarray(sids)
    key = sids if n_shards > 65536 else sids.astype(
        np.uint8 if n_shards <= 256 else np.uint16)
    order = np.argsort(key, kind="stable")
    counts = np.bincount(sids, minlength=n_shards).astype(np.int64)
    inv = np.empty_like(order)
    inv[order] = np.arange(order.shape[0])
    return order, counts, inv


def fanout_plan(sids: np.ndarray, n_shards: int) -> Tuple[list, np.ndarray]:
    """``bin_by_shard`` as per-shard segments: ``(segments, inv)``, where
    ``segments[s]`` is the stable index array of the queries routed to
    shard ``s`` and ``inv`` restores input order from the shard-major
    concatenation of the non-empty segments' results."""
    order, counts, inv = bin_by_shard(sids, int(n_shards))
    offs = np.zeros(int(n_shards) + 1, np.int64)
    np.cumsum(counts, out=offs[1:])
    segs = [order[offs[s]:offs[s + 1]] for s in range(int(n_shards))]
    return segs, inv


def split_ranges(zlo: np.ndarray, zhi: np.ndarray, boundaries
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Split ``[zlo, zhi)`` range queries at the shard boundaries: shard
    ``s`` of the touched ones gets ``[max(zlo, B[s-1]), min(zhi, B[s]))``,
    so the sub-ranges tile the query exactly.  Returns ``(qid i64[m],
    sid i32[m], sub_lo f32[m], sub_hi f32[m])``, shard ascending within
    each query; an empty range (``zhi <= zlo``) gives none."""
    zlo = np.asarray(zlo, np.float32)
    zhi = np.asarray(zhi, np.float32)
    B = (np.empty(0, np.float32) if boundaries is None
         else np.asarray(boundaries, np.float32))
    nonempty = zhi > zlo
    # first shard touched: #B <= zlo; last: #B < zhi (a range that ends
    # at a boundary does not touch the shard that starts there)
    first = np.searchsorted(B, zlo, side="right").astype(np.int64)
    last = np.searchsorted(B, zhi, side="left").astype(np.int64)
    spans = np.where(nonempty, last - first + 1, 0)
    qid = np.repeat(np.arange(zlo.shape[0], dtype=np.int64), spans)
    excl = np.cumsum(spans) - spans
    step = np.arange(int(spans.sum()), dtype=np.int64) - np.repeat(excl, spans)
    sid = (np.repeat(first, spans) + step).astype(np.int32)
    ext = np.concatenate([[-np.inf], B, [np.inf]]).astype(np.float32)
    sub_lo = np.maximum(zlo[qid], ext[sid])
    sub_hi = np.minimum(zhi[qid], ext[sid + 1])
    return qid, sid, sub_lo, sub_hi
