"""Public entry points over the port's kernels, and their launch counters.

Port of the parts of ``repro.kernels.ops`` the flat backend uses.
``fused_lookup`` serves a point-read batch on one of two rungs: the
fused rung (tree traversal, ``csrc/fused_lookup.cu``) or, when the
caller passes a ``StreamPack``, the streamed rung (router-bracketed
probe of the scan pool, ``csrc/streamed_lookup.cu``).  Which rung a
read takes is the index's decision (``FlatAFLI._dispatch``).  Both
rungs probe the write tiers in the kernel, so the JAX ladder's host tier
probe and oracle rung have no counterpart: every call launches one
kernel (or, on CPU tensors, runs its plain version).
``fused_range_scan`` and ``index_probe`` have one kernel each, and so
do the LM kernels: ``mamba_scan`` (the ssm prefill's selective scan,
called by ``models.ssm.mamba_block`` under ``use_scan_kernel``) and
``flash_decode`` (one-token decode attention, called by
``models.attention.decode_attention`` on its kernel route).

Telemetry and fault injection (port of the JAX module's serving
telemetry and fault points, DESIGN.md §16): every kernel counts its
launches (``launch_counts``; CUDA launches only), and the two dispatch
shims count their dispatches on every device (``fused_lookup_stats``).
All of it sits under ``kernels.counters.LOCK``, so a snapshot with
``reset=True`` is one critical section.  ``set_fault_plan`` installs
the injected faults ``serve.faults.inject`` asks for; the gate at the
top of both shims applies them before the launch, with no change to
index state (the JAX plan's forced oracle rung has no counterpart).
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Union

import numpy as np
import torch

from repro_torch.core.feature import KeyNormalizer, expand_features
from repro_torch.core.flow import FlowConfig, materialize_weights
from repro_torch.kernels import counters
from repro_torch.kernels import flash_decode as _fd
from repro_torch.kernels import fused_lookup as _fl
from repro_torch.kernels import index_probe as _ip
from repro_torch.kernels import mamba_scan as _ms
from repro_torch.kernels import range_scan as _rs
from repro_torch.kernels import streamed_lookup as _sl
from repro_torch.kernels.backend import resolve_device
from repro_torch.kernels.nf_forward import nf_forward, pack_flow_weights

__all__ = ["nf_transform_keys", "pack_params", "fused_lookup",
           "fused_range_scan", "index_probe", "mamba_scan", "flash_decode",
           "launch_counts", "fused_lookup_launch_sizes",
           "nf_forward_launch_sizes", "reset_launch_counts",
           "fused_lookup_stats", "reset_fused_lookup_stats",
           "TransientDispatchError", "set_fault_plan", "clear_fault_plan",
           "fault_injection_stats", "fault_stall"]


def pack_params(params: Dict, cfg: FlowConfig):
    """``pack_flow_weights`` of a flow parameter tree -> (CPU row, shapes)."""
    with torch.no_grad():
        weights = materialize_weights(params, cfg)
        dev = params["out_log_scale"].device
        out_scale = torch.exp(params["out_log_scale"])
        feat_mu = params.get("feat_mu", torch.zeros(cfg.dim, device=dev))
        feat_sd = params.get("feat_sd", torch.ones(cfg.dim, device=dev))
        return pack_flow_weights(weights, out_scale, feat_mu, feat_sd)


def nf_transform_keys(params: Dict, normalizer: KeyNormalizer,
                      keys: np.ndarray, cfg: FlowConfig,
                      device: Optional[Union[str, torch.device]] = None
                      ) -> np.ndarray:
    """Kernel-backed key transformation: host f64 feature expansion ->
    ``nf_forward`` on ``device`` -> z as f64 numpy (the f32 kernel output,
    widened).  The flat backend positions its build by this z."""
    dev = resolve_device(device)
    keys = np.asarray(keys, dtype=np.float64)
    feats = expand_features(keys, normalizer, cfg.dim, cfg.theta,
                            dtype=np.float32)
    packed, shapes = pack_params(params, cfg)
    z = nf_forward(torch.from_numpy(feats).to(dev), packed, shapes, cfg.dim)
    return z.cpu().numpy().astype(np.float64)


def fused_lookup(pools, feats: torch.Tensor, qhi: torch.Tensor,
                 qlo: torch.Tensor, *, flow=None, max_depth: int,
                 dense_iters: int, bucket_cap: int, dense_window: int = 8,
                 tiers=None, stream=None):
    """One point-read dispatch for a query batch -> (payload i32[B],
    z f32[B], rung) with the tensors on the batch's device and ``rung``
    ``"fused"`` or ``"streamed"``.

    pools: ``KernelPools``; feats: f32[B, d] query features with
    ``flow=(packed_w, shapes)``, or f32[B, 1] positioning keys without;
    tiers: a ``TierPack``, or None when both write tiers are empty;
    stream: the ``StreamPack`` to serve from on the streamed rung, or
    None for the fused rung; both rungs return the same payloads and
    z."""
    _fault_gate("point")
    if flow is not None:
        packed_w, shapes = flow
    else:
        packed_w, shapes = None, ()
    dim = int(feats.shape[1])
    in_kernel = int(tiers is not None)
    if stream is not None:
        pay, z = _sl.streamed_lookup(
            feats, qhi, qlo, packed_w, stream, tiers, dim=dim,
            shapes=shapes, use_flow=flow is not None)
        _bump(dispatch_count=1, streamed_count=1,
              tier_kernel_count=in_kernel)
        return pay, z, "streamed"
    pay, z = _fl.fused_lookup(
        feats, qhi, qlo, packed_w, pools, tiers, dim=dim,
        shapes=shapes, max_depth=max_depth, dense_iters=dense_iters,
        bucket_cap=bucket_cap, dense_window=dense_window,
        use_flow=flow is not None)
    _bump(dispatch_count=1, fused_count=1, tier_kernel_count=in_kernel)
    return pay, z, "fused"


def fused_range_scan(scan_pack, tiers, feats_lo: torch.Tensor,
                     feats_hi: torch.Tensor, *, flow=None, scan_cap: int):
    """One range-scan dispatch for a batch of ``[lo, hi)`` queries ->
    (pv i32[B, scan_cap], cnt i32[B], tot i32[B], zlo f32[B], zhi f32[B])
    as tensors on the batch's device.

    scan_pack: ``ScanPack``; tiers: a ``TierPack``, or None when both
    write tiers are empty; feats_lo/feats_hi: f32[B, d] endpoint features
    with ``flow=(packed_w, shapes)``, or f32[B, 1] positioning keys
    without.  Queries with ``tot > scan_cap`` were truncated; they are
    counted in ``fused_range_scan.truncated``."""
    _fault_gate("scan")
    if flow is not None:
        packed_w, shapes = flow
    else:
        packed_w, shapes = None, ()
    out = _rs.fused_range_scan(
        feats_lo, feats_hi, packed_w, scan_pack, tiers,
        dim=int(feats_lo.shape[1]), shapes=shapes, scan_cap=scan_cap,
        use_flow=flow is not None)
    n_trunc = int((out[2] > scan_cap).sum())
    with counters.LOCK:
        fused_range_scan.truncated += n_trunc
        _bump(scan_dispatch_count=1, scan_fused_count=1,
              scan_trunc_count=n_trunc)
    return out


fused_range_scan.truncated = 0


def index_probe(qkey: torch.Tensor, qhi: torch.Tensor, qlo: torch.Tensor,
                slope, intercept, etype: torch.Tensor, ehi: torch.Tensor,
                elo: torch.Tensor, epayload: torch.Tensor,
                echild: torch.Tensor):
    """Probe one model node with a query batch -> (payload, entry code,
    child id), each i32[B] on the batch's device (the JAX package's
    ``tile`` argument sizes TPU blocks and has no counterpart)."""
    return _ip.index_probe(qkey, qhi, qlo, slope, intercept, etype, ehi,
                           elo, epayload, echild)


def mamba_scan(dt: torch.Tensor, xi: torch.Tensor, b_in: torch.Tensor,
               c_out: torch.Tensor, a_log: torch.Tensor) -> torch.Tensor:
    """Mamba1 selective scan -> y f32[B, L, di] on the inputs' device
    (the JAX package's ``chunk`` and ``dblock`` size TPU blocks; the
    kernel's own cut is ``mamba_scan.scan_plan``)."""
    return _ms.mamba_scan(dt, xi, b_in, c_out, a_log)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kv_len: torch.Tensor) -> torch.Tensor:
    """One-token GQA decode attention -> f32 [B, H, D] on the inputs'
    device (the JAX package's ``block`` sizes TPU blocks; the kernel and
    the plain version both follow ``flash_decode.decode_plan``)."""
    return _fd.flash_decode(q, k, v, kv_len)


def launch_counts(reset: bool = False) -> Dict[str, int]:
    """Kernel launches since the last reset, per kernel; ``reset=True``
    zeroes them (as ``reset_launch_counts``) in the same critical
    section as the snapshot."""
    with counters.LOCK:
        out = {"nf_forward": nf_forward.launches,
               "fused_lookup": _fl.fused_lookup.launches,
               "streamed_lookup": _sl.streamed_lookup.launches,
               "fused_range_scan": _rs.fused_range_scan.launches,
               "index_probe": _ip.index_probe.launches,
               "mamba_scan": _ms.mamba_scan.launches,
               "flash_decode": _fd.flash_decode.launches}
        if reset:
            reset_launch_counts()
    return out


def fused_lookup_launch_sizes() -> Dict[int, int]:
    """``fused_lookup`` launches since the last reset, per batch size."""
    with counters.LOCK:
        return dict(_fl.fused_lookup.launch_sizes)


def nf_forward_launch_sizes() -> Dict[int, int]:
    """``nf_forward`` launches since the last reset, per batch size."""
    with counters.LOCK:
        return dict(nf_forward.launch_sizes)


def reset_launch_counts() -> None:
    """Zero the launch counters and the range scans' truncation count."""
    with counters.LOCK:
        for fn in (nf_forward, _fl.fused_lookup, _sl.streamed_lookup,
                   _rs.fused_range_scan, _ip.index_probe, _ms.mamba_scan,
                   _fd.flash_decode):
            fn.launches = 0
        nf_forward.launch_sizes.clear()
        _fl.fused_lookup.launch_sizes.clear()
        fused_range_scan.truncated = 0


# ------------------------------------------------------- dispatch telemetry
# Cumulative dispatch counters of the two shims, on every device (the
# plain versions on the CPU count as the rung they stand for).  The JAX
# counters with no counterpart here are left out: ``host_probe_count``
# and ``retrace_count`` (every rung probes the tiers in the kernel, and
# nothing is traced), ``stream_fallback_count`` and
# ``streamed_tiles_count`` (the port has no VMEM budget, so the streamed
# rung neither falls back nor streams tiles), and ``fallback_count``,
# ``scan_fallback_count`` and ``fallback_reasons`` (no dispatch falls
# back: the JAX routes "point-tiers" and "point-streamed" are VMEM
# budget misses, and the forced oracle rung has no counterpart).
_DISPATCH = {
    "dispatch_count": 0,     # fused_lookup shim calls past the gate
    "fused_count": 0,        # fused rung taken
    "streamed_count": 0,     # streamed rung taken
    "tier_kernel_count": 0,  # calls that probed the write tiers in-kernel
    "scan_dispatch_count": 0,  # fused_range_scan shim calls past the gate
    "scan_fused_count": 0,     # range kernel taken
    "scan_trunc_count": 0,     # queries whose candidate span > scan_cap
}


def _bump(**counts) -> None:
    with counters.LOCK:
        for k, v in counts.items():
            _DISPATCH[k] += v


def fused_lookup_stats(reset: bool = False) -> Dict[str, int]:
    """Snapshot of the dispatch counters.  ``reset=True`` zeroes them in
    the same critical section: a dispatch from another thread lands in
    this snapshot or the next, never in none.  The JAX package's
    ``host_probe_count``, ``retrace_count``, ``stream_fallback_count``,
    ``streamed_tiles_count``, ``fallback_count``,
    ``scan_fallback_count`` and ``fallback_reasons`` have no
    counterpart here (see ``_DISPATCH``)."""
    with counters.LOCK:
        out = dict(_DISPATCH)
        if reset:
            reset_fused_lookup_stats()
    return out


def reset_fused_lookup_stats() -> None:
    with counters.LOCK:
        for k in _DISPATCH:
            _DISPATCH[k] = 0


# --------------------------------------------------------- fault injection
class TransientDispatchError(RuntimeError):
    """Injected transient dispatch failure (``serve.faults.FaultPlan``).

    Raised before the launch, with no change to index state, so a failed
    dispatch is safe to retry; the front end's bounded
    retry with backoff (DESIGN.md §16) is the intended handler."""


# the injection state lives here, where every dispatch route passes;
# ``serve.faults.inject`` installs a ``FaultPlan`` and clears it on exit
_FAULT_PLAN = {
    "stall_s": 0.0,           # sleep before dispatch (device-stall model)
    "stall_every": 1,         # ...on every Nth dispatch
    "fold_stall_s": 0.0,      # sleep inside each incremental fold tick
    "error_every": 0,         # raise TransientDispatchError on every Nth
}
_FAULT_COUNTS = {
    "dispatches_seen": 0, "stalls": 0, "fold_stalls": 0,
    "transient_errors": 0,
}


def set_fault_plan(**knobs) -> None:
    """Install fault-injection knobs; unknown keys are an error."""
    with counters.LOCK:
        for k, v in knobs.items():
            if k not in _FAULT_PLAN:
                raise KeyError(f"unknown fault knob: {k!r}")
            _FAULT_PLAN[k] = v


def clear_fault_plan() -> None:
    with counters.LOCK:
        _FAULT_PLAN.update(stall_s=0.0, stall_every=1, fold_stall_s=0.0,
                           error_every=0)


def fault_injection_stats(reset: bool = False) -> Dict[str, int]:
    with counters.LOCK:
        out = dict(_FAULT_COUNTS)
        if reset:
            for k in _FAULT_COUNTS:
                _FAULT_COUNTS[k] = 0
    return out


def _fault_gate(route: str) -> None:
    """Apply the installed fault plan to one dispatch: maybe raise a
    transient error, else maybe stall."""
    with counters.LOCK:
        plan = dict(_FAULT_PLAN)
        _FAULT_COUNTS["dispatches_seen"] += 1
        n = _FAULT_COUNTS["dispatches_seen"]
        err = bool(plan["error_every"]) and n % plan["error_every"] == 0
        stall = (plan["stall_s"] > 0
                 and n % max(int(plan["stall_every"]), 1) == 0)
        if err:
            _FAULT_COUNTS["transient_errors"] += 1
        elif stall:
            _FAULT_COUNTS["stalls"] += 1
    if err:
        raise TransientDispatchError(
            f"injected transient fault on {route} dispatch #{n}")
    if stall:
        time.sleep(plan["stall_s"])


def fault_stall(point: str) -> None:
    """Injection hook for non-dispatch stall points (``"fold"`` is the
    incremental-fold tick on the write path)."""
    with counters.LOCK:
        s = _FAULT_PLAN["fold_stall_s"] if point == "fold" else 0.0
        if s > 0:
            _FAULT_COUNTS["fold_stalls"] += 1
    if s > 0:
        time.sleep(s)
