"""Streamed point lookup: NF forward + router-bracketed scan-pool probe +
write-tier probe.

Port of ``repro.kernels.streamed_lookup``.  The streamed rung serves a
point read from the scan pool (the static structure's keys in rank
order, which the range path also reads) instead of the tree: the pool is
cut into ``STREAM_ALIGN``-row tiles, and a router vector holding the
first key of every tile brackets the tiles that can hold a query's key.
``streamed_lookup`` launches the CUDA kernel
(``csrc/streamed_lookup.cu``: the router in shared memory, block
searches, the tiers probed beside the pool) on CUDA tensors and runs
``streamed_lookup_plain`` on CPU tensors.

Per query, as the JAX package's ``_kernel``: z (the in-kernel NF, or
``feats[:, 0]``); the tiles whose span ``[ord(router[t]) - 2,
ord(router[t+1]) + 2]`` holds ``ord(z)`` (``_ord_f32``'s int32
total-order image); in each, a lower bound within its live rows and the
identity window ``[l - W, l + 3W)``, keeping the largest matching global
index (the newest copy) and its payload; then delta > run > pool, with a
TOMBSTONE read as a miss.

The router is built over the pool's capacity, as the JAX package builds
it: ``router[j] = pk[j * STREAM_ALIGN]`` for every whole slice, then a
``+inf`` sentinel and ``+inf`` padding.  Rows past the live length are
``+inf`` and each tile's search is clipped to its live rows, so a tile
past the live length is never probed and an empty pool probes none.

The TPU kernel's tile-size fitting (``select_stream_tile``,
``stream_resident_parts``, ``MIN_STREAM_TILE``) sizes VMEM and has no
counterpart here: the port's tile is ``STREAM_ALIGN`` rows.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fused_lookup import (TOMBSTONE, TierPack,
                                              _probe_index_plain,
                                              _probe_tier_plain,
                                              check_window_layout)
from repro_torch.kernels.nf_forward import nf_forward_plain, nf_params_cached
from repro_torch.kernels.range_scan import ScanPool

__all__ = ["streamed_lookup", "streamed_lookup_plain", "StreamPack",
           "STREAM_ALIGN", "build_router", "router_len", "ord_f32"]

# rows per pool tile, and per router entry (the JAX package's value)
STREAM_ALIGN = 1024
# binary-search rounds within a tile: bit_length(STREAM_ALIGN), as the TPU
# tile's search
TILE_ITERS = STREAM_ALIGN.bit_length()
_LANE = 128
_INT32_MIN = -(1 << 31)


class StreamPack(NamedTuple):
    """The streamed rung's inputs: the scan pool, its router, and the
    pool's duplicate-key window (its longest run of equal keys)."""

    pool: ScanPool
    router: torch.Tensor   # f32[R] first key per STREAM_ALIGN slice, +inf pad
    window: int


class _StreamArgs(ctypes.Structure):
    """Mirror of ``StreamArgs`` in csrc/streamed_lookup.cu."""

    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "feats", "qhi", "qlo", "spk", "shi", "slo", "spv", "slen", "router",
        "rpk", "rhi", "rlo", "rpv", "rlen", "dpk", "dhi", "dlo", "dpv",
        "dlen", "out_pay", "out_z")]
        + [(n, ctypes.c_int) for n in (
            "B", "feat_dim", "use_flow", "s_cap", "window", "probe_tiers",
            "run_window", "dl_window", "r_smem", "chunk")])


def router_len(capacity: int) -> int:
    """Router length for a capacity-``C`` pool: one entry per whole
    ``STREAM_ALIGN`` slice (at least one) plus the trailing sentinel,
    padded to a multiple of 128 as in the JAX package."""
    n_slices = max(int(capacity) // STREAM_ALIGN, 1)
    return ((n_slices + 1 + _LANE - 1) // _LANE) * _LANE


def build_router(pk: torch.Tensor) -> torch.Tensor:
    """Router of a sorted, ``+inf``-padded pool buffer ``pk`` (on its
    device): ``router[j] = pk[j * STREAM_ALIGN]`` for every whole slice
    (``pk[0]`` alone when the buffer is shorter than a slice), ``+inf``
    after."""
    cap = int(pk.shape[0])
    n_slices = max(cap // STREAM_ALIGN, 1)
    step = STREAM_ALIGN if cap >= STREAM_ALIGN else max(cap, 1)
    router = torch.full((router_len(cap),), float("inf"),
                        dtype=torch.float32, device=pk.device)
    if cap:
        router[:n_slices] = pk[:n_slices * step:step]
    return router


def ord_f32(x: torch.Tensor) -> torch.Tensor:
    """``_ord_f32``: int32 total-order image of f32 (monotone over every
    non-NaN value, ``-0.0`` and ``+0.0`` both 0), as int64."""
    i = x.contiguous().view(torch.int32).to(torch.int64)
    return torch.where(i < 0, _INT32_MIN - i, i)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """Reduce int64 values to int32 two's complement (as int64)."""
    return ((x - _INT32_MIN) % (1 << 32)) + _INT32_MIN


def _bracket(router: torch.Tensor, n_tiles: torch.Tensor, oz: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per query, the tiles ``[t0, t1]`` of ``[0, n_tiles)`` whose span
    ``[ord(router[t]) - 2, ord(router[t+1]) + 2]`` holds ``oz`` (empty
    when ``t0 > t1``).  Both span ends rise with ``t``, so each end is
    one binary search."""
    lo_k = _wrap32(ord_f32(router) - 2)
    hi_k = _wrap32(ord_f32(router) + 2)
    b = oz.shape[0]
    n = n_tiles.to(torch.int64).expand(b).clone()
    rounds = max(int(router.shape[0]).bit_length(), 1)

    def search(keys, cmp):
        l = torch.zeros(b, dtype=torch.int64, device=oz.device)
        h = n.clone()
        for _ in range(rounds):
            mid = (l + h) // 2
            go = (l < h) & cmp(keys[torch.clamp(mid, max=keys.shape[0] - 1)])
            l = torch.where(go, mid + 1, l)
            h = torch.where(go | (l >= h), h, mid)
        return l

    # t1 + 1: tiles whose span starts at or below oz
    t1 = search(lo_k, lambda k: k <= oz) - 1
    # t0: the first tile whose span ends at or above oz
    t0 = search(hi_k[1:], lambda k: k < oz)
    return t0, t1


def streamed_lookup_plain(feats: torch.Tensor, qhi: torch.Tensor,
                          qlo: torch.Tensor,
                          packed_w: Optional[torch.Tensor],
                          stream: StreamPack,
                          tiers: Optional[TierPack] = None, *, dim: int,
                          shapes=(), use_flow: bool = True
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the streamed kernel, on ``feats``' device,
    vectorised over queries: the widest bracket's tiles in turn, each
    probed for the queries whose bracket holds it.  Returns (payload i32[B]
    or -1, positioning key f32[B])."""
    if use_flow:
        q = nf_forward_plain(feats, packed_w, shapes, dim)
    else:
        q = feats[:, 0].to(torch.float32)
    dev = q.device
    b = q.shape[0]
    pool = stream.pool
    cap = pool.pk.shape[0]
    plen = pool.plen.reshape(-1)[:1].to(torch.int64)
    n_tiles = (plen + STREAM_ALIGN - 1) // STREAM_ALIGN
    t0, t1 = _bracket(stream.router, n_tiles, ord_f32(q))
    best = torch.full((b,), -1, dtype=torch.int64, device=dev)
    width = int((t1 - t0 + 1).clamp(min=0).max()) if b else 0
    for k in range(width):
        t = t0 + k
        active = t <= t1
        if not bool(active.any()):
            continue
        base = torch.where(active, t, 0) * STREAM_ALIGN
        live = torch.where(active, torch.clamp(plen - base, 0, STREAM_ALIGN),
                           0)
        rows = torch.clamp(cap - base, 1, STREAM_ALIGN)
        j = _probe_index_plain(pool.pk, pool.hi, pool.lo, live, TILE_ITERS,
                               stream.window, q, qhi, qlo, base, rows)
        best = torch.where(j >= 0, torch.maximum(best, base + j), best)
    pay = pool.pv[torch.clamp(best, 0, cap - 1)]
    result = torch.where(best >= 0, pay, torch.full_like(pay, -1))
    if tiers is not None:
        t = tiers.pools
        dl = _probe_tier_plain(t.dl_pk, t.dl_hi, t.dl_lo, t.dl_pv, t.dl_len,
                               tiers.delta_iters, tiers.delta_window, q,
                               qhi, qlo)
        rn = _probe_tier_plain(t.run_pk, t.run_hi, t.run_lo, t.run_pv,
                               t.run_len, tiers.run_iters,
                               tiers.run_window, q, qhi, qlo)
        result = torch.where(dl != -1, dl, torch.where(rn != -1, rn, result))
    result = torch.where(result == TOMBSTONE, torch.full_like(result, -1),
                         result)
    return result, q


def streamed_lookup(feats: torch.Tensor, qhi: torch.Tensor,
                    qlo: torch.Tensor, packed_w: Optional[torch.Tensor],
                    stream: StreamPack, tiers: Optional[TierPack] = None, *,
                    dim: int, shapes=(), use_flow: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streamed NF + scan-pool probe + tier probe -> (payload i32[B],
    z f32[B]).

    feats: f32[B, dim] expanded query features (``use_flow``) or [B, 1]
    positioning keys; qhi/qlo: i32[B] identity bit views; packed_w: the
    CPU ``pack_flow_weights`` row (ignored without flow); stream and
    tiers (None: both write tiers empty) on the same device as feats.
    CUDA tensors launch ``csrc/streamed_lookup.cu`` (and count the
    launch); CPU tensors run ``streamed_lookup_plain``."""
    kw = dict(dim=dim, shapes=shapes, use_flow=use_flow)
    if feats.device.type == "cpu":
        return streamed_lookup_plain(feats, qhi, qlo, packed_w, stream,
                                     tiers, **kw)
    if feats.device.type != "cuda":
        raise ValueError(f"unsupported device {feats.device}")
    b = int(feats.shape[0])
    pool = stream.pool
    tensors = [feats, qhi, qlo, *pool, stream.router]
    if tiers is not None:
        tensors += list(tiers.pools)
    for t in tensors:
        if t.device != feats.device or not t.is_contiguous():
            raise ValueError("streamed_lookup inputs must be contiguous and "
                             "on one device")
    if feats.dtype != torch.float32 or feats.dim() != 2 \
            or feats.shape[1] != (dim if use_flow else 1):
        raise ValueError("feats must be f32[B, dim] (flow) or f32[B, 1]")
    if qhi.dtype != torch.int32 or qlo.dtype != torch.int32 \
            or qhi.shape != (b,) or qlo.shape != (b,):
        raise ValueError("qhi/qlo must be i32[B] identity bit views")
    cap = int(pool.pk.shape[0])
    if pool.pk.dtype != torch.float32 or stream.router.dtype != torch.float32:
        raise ValueError("pool keys and router must be f32")
    # the router entries the bracket reads: one per tile, then the next
    # tile's start
    need = -(-cap // STREAM_ALIGN) + 1
    if int(stream.router.shape[0]) < need:
        raise ValueError("router too short for the pool: build it with "
                         "build_router")
    if stream.window < 1:
        raise ValueError("the pool's window must be at least 1")
    # the searches' last round and the windows read four rows a 16-byte
    # load; the router is staged 16 bytes a copy
    if cap % 4 or any(x.data_ptr() % 16 for x in (pool.pk, pool.hi,
                                                  stream.router)):
        raise ValueError("streamed_lookup: the pool's pk and hi must be "
                         "16-byte aligned with a multiple of 4 rows, the "
                         "router 16-byte aligned")
    if tiers is not None:
        check_window_layout(tiers, "streamed_lookup")
        t = tiers.pools
        for pk, iters in ((t.run_pk, tiers.run_iters),
                          (t.dl_pk, tiers.delta_iters)):
            # the kernel's searches run to the exact lower bound; the
            # plain version's `iters` rounds reach it when they cover
            # the capacity
            if pk.data_ptr() % 16 or pk.shape[0] % 4 \
                    or (1 << iters) <= pk.shape[0]:
                raise ValueError("streamed_lookup: tier pk must be 16-byte "
                                 "aligned with a multiple of 4 rows, and "
                                 "its search rounds cover its capacity")
    params = nf_params_cached(packed_w, shapes, dim) if use_flow else _NO_FLOW
    pay = torch.empty(b, dtype=torch.int32, device=feats.device)
    z = torch.empty(b, dtype=torch.float32, device=feats.device)
    if b == 0:
        return pay, z
    a = _StreamArgs()
    a.feats, a.qhi, a.qlo = feats.data_ptr(), qhi.data_ptr(), qlo.data_ptr()
    a.spk, a.shi, a.slo, a.spv, a.slen = (x.data_ptr() for x in pool)
    a.router = stream.router.data_ptr()
    if tiers is not None:
        (a.rpk, a.rhi, a.rlo, a.rpv, a.rlen, a.dpk, a.dhi, a.dlo, a.dpv,
         a.dlen) = (x.data_ptr() for x in t)
        a.probe_tiers = 1
        a.run_window, a.dl_window = tiers.run_window, tiers.delta_window
    a.out_pay, a.out_z = pay.data_ptr(), z.data_ptr()
    a.B = b
    a.feat_dim = int(feats.shape[1])
    a.use_flow = int(bool(use_flow))
    a.s_cap = cap
    a.window = int(stream.window)
    a.r_smem = min(-(-need // 4) * 4, int(stream.router.shape[0]))
    fn = build.function("streamed_lookup", "streamed_lookup_launch",
                        [ctypes.POINTER(_StreamArgs),
                         ctypes.POINTER(build.NFParams), ctypes.c_void_p])
    build.check(fn(ctypes.byref(a), ctypes.byref(params),
                   build.stream_ptr(feats.device)), "streamed_lookup")
    streamed_lookup.launches += 1
    return pay, z


_NO_FLOW = build.NFParams()
streamed_lookup.launches = 0
