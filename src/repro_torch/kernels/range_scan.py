"""Fused range scan: endpoint NF + three-pool lower bounds + tier merge.

Port of ``repro.kernels.range_scan``.  ``fused_range_scan`` launches the
CUDA kernel (``csrc/range_scan.cu``, one warp per range query, merging
up to 32 candidates a round) on CUDA tensors and runs
``fused_range_scan_plain`` on CPU tensors.  The plain
version is the JAX package's ``_kernel`` written in PyTorch, round for
round: per ``[lo, hi)`` query both endpoints' z, their lower bounds in
the scan pool (the static structure's keys in rank order), the run and
the delta, then ``scan_cap`` rounds of a three-way merge by positioning
key (ties: delta, run, scan pool; index order within a pool), in which a
candidate with a newer copy of its identity is superseded and a
TOMBSTONE is dropped.

Outputs per query: payloads ``pv`` i32[scan_cap] (-1 padded) with the
first ``cnt`` lanes valid, ``tot`` the candidates in range over the
three pools (``tot > scan_cap``: truncated), and the endpoints' z.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import build, counters
from repro_torch.kernels.fused_lookup import (TOMBSTONE, TierPack,
                                              _lower_bound_plain,
                                              _probe_tier_plain,
                                              check_window_layout)
from repro_torch.kernels.nf_forward import nf_forward_plain, nf_params_cached

__all__ = ["fused_range_scan", "fused_range_scan_plain", "ScanPool",
           "ScanPack"]


class ScanPool(NamedTuple):
    """The static structure's keys in rank (sorted positioning-key)
    order, laid out as one write tier: pk f32 (+inf padded), identity
    bit views, payloads, and the live length as a device i32[1]."""

    pk: torch.Tensor
    hi: torch.Tensor
    lo: torch.Tensor
    pv: torch.Tensor
    plen: torch.Tensor

    def nbytes(self) -> int:
        return int(sum(a.numel() * a.element_size() for a in self))


class ScanPack(NamedTuple):
    """ScanPool plus its binary-search rounds (covering the capacity)."""

    pool: ScanPool
    iters: int

    def nbytes(self) -> int:
        return self.pool.nbytes()


class _ScanArgs(ctypes.Structure):
    """Mirror of ``ScanArgs`` in csrc/range_scan.cu."""

    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "flo", "fhi", "spk", "shi", "slo", "spv", "slen", "rpk", "rhi",
        "rlo", "rpv", "rlen", "dpk", "dhi", "dlo", "dpv", "dlen", "out_pv",
        "out_cnt", "out_tot", "out_zlo", "out_zhi")]
        + [(n, ctypes.c_int) for n in (
            "B", "feat_dim", "use_flow", "scan_cap", "s_cap", "s_iters",
            "probe_tiers", "run_cap", "run_iters", "run_window", "dl_cap",
            "dl_iters", "dl_window", "pad_")])


def _endpoints(feats_lo, feats_hi, packed_w, shapes, dim, use_flow):
    if use_flow:
        return (nf_forward_plain(feats_lo, packed_w, shapes, dim),
                nf_forward_plain(feats_hi, packed_w, shapes, dim))
    return (feats_lo[:, 0].to(torch.float32),
            feats_hi[:, 0].to(torch.float32))


def fused_range_scan_plain(feats_lo: torch.Tensor, feats_hi: torch.Tensor,
                           packed_w: Optional[torch.Tensor],
                           scan_pack: ScanPack,
                           tiers: Optional[TierPack] = None, *, dim: int,
                           shapes=(), scan_cap: int, use_flow: bool = True
                           ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the range kernel, on ``feats_lo``'s
    device, vectorised across queries.  Returns (pv i32[B, scan_cap],
    cnt i32[B], tot i32[B], zlo f32[B], zhi f32[B])."""
    zlo, zhi = _endpoints(feats_lo, feats_hi, packed_w, shapes, dim,
                          use_flow)
    dev = zlo.device
    b = zlo.shape[0]
    s = scan_pack.pool
    s0 = _lower_bound_plain(s.pk, s.plen, scan_pack.iters, zlo)
    s1 = _lower_bound_plain(s.pk, s.plen, scan_pack.iters, zhi)
    zero = torch.zeros(b, dtype=torch.int64, device=dev)
    r0 = r1 = d0 = d1 = zero
    if tiers is not None:
        t = tiers.pools
        r0 = _lower_bound_plain(t.run_pk, t.run_len, tiers.run_iters, zlo)
        r1 = _lower_bound_plain(t.run_pk, t.run_len, tiers.run_iters, zhi)
        d0 = _lower_bound_plain(t.dl_pk, t.dl_len, tiers.delta_iters, zlo)
        d1 = _lower_bound_plain(t.dl_pk, t.dl_len, tiers.delta_iters, zhi)
    total = ((s1 - s0).clamp(min=0) + (r1 - r0).clamp(min=0)
             + (d1 - d0).clamp(min=0)).to(torch.int32)

    def head(pool_pk, cur, end):
        ok = cur < end
        pk = pool_pk[torch.clamp(cur, 0, pool_pk.shape[0] - 1)]
        return torch.where(ok, pk, torch.full_like(pk, float("inf")))

    def at(pool, cur):
        return pool[torch.clamp(cur, 0, pool.shape[0] - 1)]

    rows = torch.arange(b, device=dev)
    out = torch.full((b, scan_cap), -1, dtype=torch.int32, device=dev)
    cnt = torch.zeros(b, dtype=torch.int64, device=dev)
    it, ir, idl = s0, r0, d0
    for _ in range(scan_cap):
        t_pk = head(s.pk, it, s1)
        if tiers is not None:
            r_pk = head(t.run_pk, ir, r1)
            d_pk = head(t.dl_pk, idl, d1)
        else:
            r_pk = d_pk = torch.full_like(t_pk, float("inf"))
        m = torch.minimum(t_pk, torch.minimum(r_pk, d_pk))
        any_c = m < float("inf")
        if not bool(any_c.any()):
            break        # no query has a candidate left: later rounds are no-ops
        pick_d = any_c & (d_pk == m)
        pick_r = any_c & ~pick_d & (r_pk == m)
        pick_t = any_c & ~pick_d & ~pick_r
        chi, clo, cpv = at(s.hi, it), at(s.lo, it), at(s.pv, it)
        superseded = torch.zeros_like(any_c)
        if tiers is not None:
            chi = torch.where(pick_d, at(t.dl_hi, idl),
                              torch.where(pick_r, at(t.run_hi, ir), chi))
            clo = torch.where(pick_d, at(t.dl_lo, idl),
                              torch.where(pick_r, at(t.run_lo, ir), clo))
            cpv = torch.where(pick_d, at(t.dl_pv, idl),
                              torch.where(pick_r, at(t.run_pv, ir), cpv))
            dl = _probe_tier_plain(t.dl_pk, t.dl_hi, t.dl_lo, t.dl_pv,
                                   t.dl_len, tiers.delta_iters,
                                   tiers.delta_window, m, chi, clo)
            rn = _probe_tier_plain(t.run_pk, t.run_hi, t.run_lo, t.run_pv,
                                   t.run_len, tiers.run_iters,
                                   tiers.run_window, m, chi, clo)
            superseded = ((pick_t & ((dl != -1) | (rn != -1)))
                          | (pick_r & (dl != -1)))
        valid = any_c & ~superseded & (cpv != TOMBSTONE)
        out[rows[valid], cnt[valid]] = cpv[valid]
        cnt = cnt + valid.to(torch.int64)
        it = it + pick_t.to(torch.int64)
        ir = ir + pick_r.to(torch.int64)
        idl = idl + pick_d.to(torch.int64)
    return out, cnt.to(torch.int32), total, zlo, zhi


def fused_range_scan(feats_lo: torch.Tensor, feats_hi: torch.Tensor,
                     packed_w: Optional[torch.Tensor], scan_pack: ScanPack,
                     tiers: Optional[TierPack] = None, *, dim: int,
                     shapes=(), scan_cap: int, use_flow: bool = True
                     ) -> Tuple[torch.Tensor, ...]:
    """Fused range scan -> (pv i32[B, scan_cap], cnt i32[B], tot i32[B],
    zlo f32[B], zhi f32[B]).

    feats_lo/feats_hi: f32[B, dim] expanded endpoint features
    (``use_flow``) or [B, 1] positioning keys; packed_w: the CPU
    ``pack_flow_weights`` row (ignored without flow); scan_pack and tiers
    (None: both write tiers empty) on the same device.  CUDA tensors
    launch ``csrc/range_scan.cu`` (and count the launch); CPU tensors run
    ``fused_range_scan_plain``."""
    kw = dict(dim=dim, shapes=shapes, scan_cap=scan_cap, use_flow=use_flow)
    if feats_lo.device.type == "cpu":
        return fused_range_scan_plain(feats_lo, feats_hi, packed_w,
                                      scan_pack, tiers, **kw)
    if feats_lo.device.type != "cuda":
        raise ValueError(f"unsupported device {feats_lo.device}")
    b = int(feats_lo.shape[0])
    width = dim if use_flow else 1
    for f in (feats_lo, feats_hi):
        if f.dtype != torch.float32 or f.dim() != 2 \
                or tuple(f.shape) != (b, width):
            raise ValueError("feats must be f32[B, dim] (flow) or f32[B, 1]")
    tensors = [feats_lo, feats_hi, *scan_pack.pool]
    if tiers is not None:
        tensors += list(tiers.pools)
    for t in tensors:
        if t.device != feats_lo.device or not t.is_contiguous():
            raise ValueError("fused_range_scan inputs must be contiguous "
                             "and on one device")
    if scan_cap <= 0:
        raise ValueError("scan_cap must be positive")
    params = (nf_params_cached(packed_w, shapes, dim) if use_flow
              else _NO_FLOW)
    dev = feats_lo.device
    pv = torch.empty((b, scan_cap), dtype=torch.int32, device=dev)
    cnt = torch.empty(b, dtype=torch.int32, device=dev)
    tot = torch.empty(b, dtype=torch.int32, device=dev)
    zlo = torch.empty(b, dtype=torch.float32, device=dev)
    zhi = torch.empty(b, dtype=torch.float32, device=dev)
    if b == 0:
        return pv, cnt, tot, zlo, zhi
    a = _ScanArgs()
    a.flo, a.fhi = feats_lo.data_ptr(), feats_hi.data_ptr()
    a.spk, a.shi, a.slo, a.spv, a.slen = (x.data_ptr()
                                          for x in scan_pack.pool)
    a.s_cap = int(scan_pack.pool.pk.shape[0])
    a.s_iters = scan_pack.iters
    if tiers is not None:
        check_window_layout(tiers, "fused_range_scan")
        t = tiers.pools
        (a.rpk, a.rhi, a.rlo, a.rpv, a.rlen, a.dpk, a.dhi, a.dlo, a.dpv,
         a.dlen) = (x.data_ptr() for x in t)
        a.probe_tiers = 1
        a.run_cap, a.dl_cap = int(t.run_pk.shape[0]), int(t.dl_pk.shape[0])
        a.run_iters, a.run_window = tiers.run_iters, tiers.run_window
        a.dl_iters, a.dl_window = tiers.delta_iters, tiers.delta_window
    a.out_pv, a.out_cnt, a.out_tot = (pv.data_ptr(), cnt.data_ptr(),
                                      tot.data_ptr())
    a.out_zlo, a.out_zhi = zlo.data_ptr(), zhi.data_ptr()
    a.B = b
    a.feat_dim = width
    a.use_flow = int(bool(use_flow))
    a.scan_cap = scan_cap
    fn = build.function("range_scan", "range_scan_launch",
                        [ctypes.POINTER(_ScanArgs),
                         ctypes.POINTER(build.NFParams), ctypes.c_void_p])
    build.check(fn(ctypes.byref(a), ctypes.byref(params),
                   build.stream_ptr(dev)), "fused_range_scan")
    counters.launched(fused_range_scan)
    return pv, cnt, tot, zlo, zhi


_NO_FLOW = build.NFParams()
fused_range_scan.launches = 0
