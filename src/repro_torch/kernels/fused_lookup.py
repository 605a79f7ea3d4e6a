"""Fused point lookup: NF forward + FlatAFLI traversal + write-tier probe.

Port of ``repro.kernels.fused_lookup``.  ``fused_lookup`` launches the
CUDA kernel (``csrc/fused_lookup.cu``, one thread per query; with tiers,
half of each block walks the tree while the other half probes the tiers
for the same queries) on CUDA tensors and runs ``fused_lookup_plain`` on
CPU tensors.  The plain
version is the JAX package's ``flat_lookup`` oracle written in PyTorch,
plus the in-kernel tier probe: per level a model-node slot
(``rint(slope*z + intercept)``, multiply and add rounded separately,
clipped), a dense-node fixed-round binary search plus the first match of
the duplicate window, a conflict-bucket max over identity matches; then
delta > run > tree with the newest tier copy winning and TOMBSTONE
masking older copies.

Identity halves are int32 bit views of the u32 pools; only equality is
taken on them.
"""

from __future__ import annotations

import collections
import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.nf_forward import nf_forward_plain, nf_params_cached

__all__ = ["fused_lookup", "fused_lookup_plain", "KernelPools", "TierPools",
           "TierPack", "TOMBSTONE", "EMPTY", "DATA", "BUCKET", "CHILD",
           "KIND_MODEL", "KIND_DENSE", "check_window_layout"]

# entry / node codes — schema owned by repro_torch.core.flat_afli
EMPTY, DATA, BUCKET, CHILD = 0, 1, 2, 3
KIND_MODEL, KIND_DENSE = 0, 1

# payload sentinels: -1 is a miss everywhere; -2 marks a tombstoned
# identity riding the write tiers (it masks every older copy, then
# surfaces as a miss)
TOMBSTONE = -2


class KernelPools(NamedTuple):
    """Kernel-ready FlatAFLI pools on one device (``FlatArrays.
    to_kernel_args``): i32 codes, int32 identity bit views, buckets
    [Bk, cap] row-major."""

    node_kind: torch.Tensor       # i32[N]  model / dense
    node_slope: torch.Tensor      # f32[N]
    node_intercept: torch.Tensor  # f32[N]
    node_offset: torch.Tensor     # i32[N]
    node_size: torch.Tensor       # i32[N]
    etype: torch.Tensor           # i32[P]
    ekey: torch.Tensor            # f32[P]
    ehi: torch.Tensor             # i32[P]  (u32 bits)
    elo: torch.Tensor             # i32[P]
    epayload: torch.Tensor        # i32[P]
    echild: torch.Tensor          # i32[P]
    bhi: torch.Tensor             # i32[Bk, cap]
    blo: torch.Tensor             # i32[Bk, cap]
    bpayload: torch.Tensor        # i32[Bk, cap]
    blen: torch.Tensor            # i32[Bk]

    def nbytes(self) -> int:
        return int(sum(a.numel() * a.element_size() for a in self))


class TierPools(NamedTuple):
    """The write tiers (compacted run, active delta): each a sorted pool
    of positioning keys (+inf padded), identity bits, payloads, and its
    live length as a device i32[1]."""

    run_pk: torch.Tensor
    run_hi: torch.Tensor
    run_lo: torch.Tensor
    run_pv: torch.Tensor
    run_len: torch.Tensor
    dl_pk: torch.Tensor
    dl_hi: torch.Tensor
    dl_lo: torch.Tensor
    dl_pv: torch.Tensor
    dl_len: torch.Tensor

    def nbytes(self) -> int:
        return int(sum(a.numel() * a.element_size() for a in self))


class TierPack(NamedTuple):
    """TierPools plus their probe bounds (binary-search rounds covering
    each capacity, pow2 duplicate windows)."""

    pools: TierPools
    run_iters: int
    run_window: int
    delta_iters: int
    delta_window: int

    def nbytes(self) -> int:
        return self.pools.nbytes()


class _LookupArgs(ctypes.Structure):
    """Mirror of ``LookupArgs`` in csrc/fused_lookup.cu."""

    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "feats", "qhi", "qlo", "nkind", "nslope", "nicept", "noff", "nsize",
        "etype", "ekey", "ehi", "elo", "epay", "echild", "bhi", "blo",
        "bpay", "blen", "rpk", "rhi", "rlo", "rpv", "rlen", "dpk", "dhi",
        "dlo", "dpv", "dlen", "out_pay", "out_z")]
        + [(n, ctypes.c_int) for n in (
            "B", "feat_dim", "use_flow", "max_depth", "dense_iters",
            "bucket_cap", "dense_window", "n_entries", "probe_tiers",
            "run_cap", "run_iters", "run_window", "dl_cap", "dl_iters",
            "dl_window", "pad_")])


def check_window_layout(tiers: "TierPack", what: str) -> None:
    """The kernels read a tier's identity window four hi rows per 16-byte
    load (``window_pv`` in csrc/tier_device.cuh): each tier's hi must
    start 16-byte aligned and hold a multiple of 4 rows, as
    ServingState's buffers do."""
    for hi in (tiers.pools.run_hi, tiers.pools.dl_hi):
        if hi.data_ptr() % 16 or hi.shape[0] % 4:
            raise ValueError(f"{what}: tier hi arrays must be 16-byte "
                             "aligned with a multiple of 4 rows")


def _slot_index(x: torch.Tensor) -> torch.Tensor:
    """rint then a saturating f32 -> i32 conversion (the card's cvt):
    out-of-range values clamp, NaN maps to 0."""
    r = torch.round(x)
    r = torch.where(torch.isnan(r), torch.zeros_like(r), r)
    return torch.clamp(r, -2147483648.0, 2147483520.0).to(torch.int64)


def _lower_bound_plain(pk, n_len, iters: int, q, base=None,
                       rows=None) -> torch.Tensor:
    """The binary search the kernels' tier searches give the index of
    (``tier_probe`` in csrc/fused_lookup.cu), vectorised over ``q``:
    the leftmost index in [0, n] with ``pk[base + i] >= q``, as ``iters``
    rounds of binary search with reads clamped to ``pk[base + rows - 1]``.
    ``n_len`` is one length (i32[1]) or one per query; ``base`` (default
    0) and ``rows`` (default: the whole pool) are per query, for a pool
    searched tile by tile."""
    cap = pk.shape[0]
    l = torch.zeros(q.shape[0], dtype=torch.int64, device=q.device)
    h = n_len.reshape(-1).to(torch.int64).expand(q.shape[0]).clone()
    off = 0 if base is None else base
    last = cap - 1 if rows is None else off + rows - 1
    for _ in range(iters):
        mid = (l + h) // 2
        go = pk[torch.clamp(off + mid, max=last)] < q
        l = torch.where(go, mid + 1, l)
        h = torch.where(go, h, mid)
    return l


def _probe_index_plain(pk, hi, lo, n_len, iters: int, window: int, q, qhi,
                       qlo, base=None, rows=None) -> torch.Tensor:
    """A tier's (or a stream tile's) identity probe: the index (from ``base``)
    of the newest row whose identity matches in the window around
    ``q``'s lower bound, -1 where none does; arguments as
    ``_lower_bound_plain``."""
    cap = pk.shape[0]
    n = n_len.reshape(-1).to(torch.int64)
    l = _lower_bound_plain(pk, n_len, iters, q, base, rows)
    widx = (l - window)[:, None] + torch.arange(4 * window, device=q.device)
    off = 0 if base is None else base[:, None]
    wc = torch.clamp(off + widx, 0, cap - 1)
    ok = ((widx >= 0) & (widx < n[:, None]) & (hi[wc] == qhi[:, None])
          & (lo[wc] == qlo[:, None]))
    return torch.max(torch.where(ok, widx, torch.full_like(widx, -1)),
                     dim=1).values


def _probe_tier_plain(pk, hi, lo, pv, n_len, iters: int, window: int,
                      q, qhi, qlo) -> torch.Tensor:
    """A tier's probe (``window_pv`` in csrc/tier_device.cuh at the
    index ``_lower_bound_plain`` gives): the newest payload whose
    identity matches in the window around ``q``'s lower bound (-1: none;
    a TOMBSTONE passes through)."""
    last = _probe_index_plain(pk, hi, lo, n_len, iters, window, q, qhi, qlo)
    pay = pv[torch.clamp(last, 0, pk.shape[0] - 1)]
    return torch.where(last >= 0, pay, torch.full_like(pay, -1))


def fused_lookup_plain(feats: torch.Tensor, qhi: torch.Tensor,
                       qlo: torch.Tensor, packed_w: Optional[torch.Tensor],
                       pools: KernelPools, tiers: Optional[TierPack] = None,
                       *, dim: int, shapes=(), max_depth: int,
                       dense_iters: int, bucket_cap: int,
                       dense_window: int = 8, use_flow: bool = True
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the fused kernel, on ``feats``' device.
    Returns (payload i32[B] or -1, positioning key f32[B])."""
    if use_flow:
        q = nf_forward_plain(feats, packed_w, shapes, dim)
    else:
        q = feats[:, 0].to(torch.float32)
    dev = q.device
    b = q.shape[0]
    n_entries = pools.ekey.shape[0]
    node = torch.zeros(b, dtype=torch.int64, device=dev)
    result = torch.full((b,), -1, dtype=torch.int32, device=dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    cols = torch.arange(pools.bhi.shape[1], device=dev)
    wcols = torch.arange(dense_window, device=dev)
    for _ in range(max_depth):
        if bool(done.all()):
            break
        kind = pools.node_kind[node]
        slope = pools.node_slope[node]
        intercept = pools.node_intercept[node]
        offset = pools.node_offset[node].to(torch.int64)
        size = pools.node_size[node].to(torch.int64)
        slot = _slot_index(slope * q + intercept)
        slot = torch.minimum(torch.maximum(slot, torch.zeros_like(slot)),
                             size - 1)
        e_model = offset + slot
        is_dense = kind == KIND_DENSE

        # dense node: the oracle's fixed-round binary search (reads
        # clamped to the pool), then the first (key, identity) match in
        # the duplicate window
        l, h = offset, offset + size
        for _ in range(dense_iters):
            mid = (l + h) // 2
            go = pools.ekey[torch.clamp(mid, max=n_entries - 1)] < q
            l = torch.where(go, mid + 1, l)
            h = torch.where(go, h, mid)
        last = offset + size - 1
        e_dense = torch.minimum(torch.maximum(l, offset), last)
        widx = torch.minimum(e_dense[:, None] + wcols, last[:, None])
        wok = ((pools.ekey[widx] == q[:, None])
               & (pools.ehi[widx] == qhi[:, None])
               & (pools.elo[widx] == qlo[:, None]))
        first = torch.argmax(wok.to(torch.int8), dim=1)
        found = wok.gather(1, first[:, None])[:, 0]
        wpay = pools.epayload[widx].gather(1, first[:, None])[:, 0]
        dense_payload = torch.where(found, wpay, torch.full_like(wpay, -1))

        e = torch.where(kind == KIND_MODEL, e_model, e_dense)
        et = pools.etype[e]
        hit_data = ((et == DATA) & (pools.ehi[e] == qhi)
                    & (pools.elo[e] == qlo))
        bid = torch.clamp(pools.echild[e], min=0).to(torch.int64)
        bmatch = ((pools.bhi[bid] == qhi[:, None])
                  & (pools.blo[bid] == qlo[:, None])
                  & (cols[None, :] < pools.blen[bid][:, None]))
        brow = pools.bpayload[bid]
        bucket_payload = torch.max(
            torch.where(bmatch, brow, torch.full_like(brow, -1)), dim=1).values
        minus1 = torch.full_like(result, -1)
        model_payload = torch.where(
            hit_data, pools.epayload[e],
            torch.where(et == BUCKET, bucket_payload, minus1))
        result = torch.where(done, result,
                             torch.where(is_dense, dense_payload,
                                         model_payload))
        deeper = (~is_dense) & (et == CHILD) & (~done)
        node = torch.where(deeper, pools.echild[e].to(torch.int64), node)
        done = done | ~deeper

    if tiers is not None:
        t = tiers.pools
        dl = _probe_tier_plain(t.dl_pk, t.dl_hi, t.dl_lo, t.dl_pv, t.dl_len,
                               tiers.delta_iters, tiers.delta_window, q,
                               qhi, qlo)
        rn = _probe_tier_plain(t.run_pk, t.run_hi, t.run_lo, t.run_pv,
                               t.run_len, tiers.run_iters,
                               tiers.run_window, q, qhi, qlo)
        result = torch.where(dl != -1, dl, torch.where(rn != -1, rn, result))
        result = torch.where(result == TOMBSTONE,
                             torch.full_like(result, -1), result)
    return result, q


def fused_lookup(feats: torch.Tensor, qhi: torch.Tensor, qlo: torch.Tensor,
                 packed_w: Optional[torch.Tensor], pools: KernelPools,
                 tiers: Optional[TierPack] = None, *, dim: int, shapes=(),
                 max_depth: int, dense_iters: int, bucket_cap: int,
                 dense_window: int = 8, use_flow: bool = True
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused NF + traversal + tier probe -> (payload i32[B], z f32[B]).

    feats: f32[B, dim] expanded query features (``use_flow``) or [B, 1]
    positioning keys; qhi/qlo: i32[B] identity bit views; packed_w: the
    CPU ``pack_flow_weights`` row (ignored without flow); pools and
    tiers on the same device as feats.  CUDA tensors launch
    ``csrc/fused_lookup.cu`` (and count the launch); CPU tensors run
    ``fused_lookup_plain``."""
    kw = dict(dim=dim, shapes=shapes, max_depth=max_depth,
              dense_iters=dense_iters, bucket_cap=bucket_cap,
              dense_window=dense_window, use_flow=use_flow)
    if feats.device.type == "cpu":
        return fused_lookup_plain(feats, qhi, qlo, packed_w, pools, tiers,
                                  **kw)
    if feats.device.type != "cuda":
        raise ValueError(f"unsupported device {feats.device}")
    b = int(feats.shape[0])
    tensors = [feats, qhi, qlo, *pools]
    if tiers is not None:
        tensors += list(tiers.pools)
    for t in tensors:
        if t.device != feats.device or not t.is_contiguous():
            raise ValueError("fused_lookup inputs must be contiguous and "
                             "on one device")
    if feats.dtype != torch.float32 or feats.dim() != 2 \
            or feats.shape[1] != (dim if use_flow else 1):
        raise ValueError("feats must be f32[B, dim] (flow) or f32[B, 1]")
    if qhi.dtype != torch.int32 or qlo.dtype != torch.int32 \
            or qhi.shape != (b,) or qlo.shape != (b,):
        raise ValueError("qhi/qlo must be i32[B] identity bit views")
    if pools.bhi.shape[1] != bucket_cap:
        raise ValueError("bucket pool width must equal bucket_cap")
    params = (nf_params_cached(packed_w, shapes, dim) if use_flow
              else _NO_FLOW)
    pay = torch.empty(b, dtype=torch.int32, device=feats.device)
    z = torch.empty(b, dtype=torch.float32, device=feats.device)
    if b == 0:
        return pay, z
    a = _LookupArgs()
    a.feats, a.qhi, a.qlo = feats.data_ptr(), qhi.data_ptr(), qlo.data_ptr()
    (a.nkind, a.nslope, a.nicept, a.noff, a.nsize, a.etype, a.ekey, a.ehi,
     a.elo, a.epay, a.echild, a.bhi, a.blo, a.bpay, a.blen) = (
        t.data_ptr() for t in pools)
    if tiers is not None:
        check_window_layout(tiers, "fused_lookup")
        t = tiers.pools
        (a.rpk, a.rhi, a.rlo, a.rpv, a.rlen, a.dpk, a.dhi, a.dlo, a.dpv,
         a.dlen) = (x.data_ptr() for x in t)
        a.probe_tiers = 1
        a.run_cap, a.dl_cap = int(t.run_pk.shape[0]), int(t.dl_pk.shape[0])
        a.run_iters, a.run_window = tiers.run_iters, tiers.run_window
        a.dl_iters, a.dl_window = tiers.delta_iters, tiers.delta_window
    a.out_pay, a.out_z = pay.data_ptr(), z.data_ptr()
    a.B = b
    a.feat_dim = int(feats.shape[1])
    a.use_flow = int(bool(use_flow))
    a.max_depth = max_depth
    a.dense_iters = dense_iters
    a.bucket_cap = bucket_cap
    a.dense_window = dense_window
    a.n_entries = int(pools.ekey.shape[0])
    fn = build.function("fused_lookup", "fused_lookup_launch",
                        [ctypes.POINTER(_LookupArgs),
                         ctypes.POINTER(build.NFParams), ctypes.c_void_p])
    build.check(fn(ctypes.byref(a), ctypes.byref(params),
                   build.stream_ptr(feats.device)), "fused_lookup")
    fused_lookup.launches += 1
    fused_lookup.launch_sizes[b] += 1
    return pay, z


_NO_FLOW = build.NFParams()
fused_lookup.launches = 0
fused_lookup.launch_sizes = collections.Counter()   # batch size -> launches
