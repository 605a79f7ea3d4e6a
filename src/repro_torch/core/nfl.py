"""NFL — the two-stage Normalizing-Flow Learned index (paper §3), PyTorch.

Port of ``repro.core.nfl`` for the flat backend.  Stage 1 trains the
Numerical NF on a sample of the bulk-loaded keys and transforms every
key through the NF kernel; the paper's switching mechanism (AutoSwitch)
keeps the flow only if it lowers the tail conflict degree.  Stage 2
builds ``FlatAFLI`` over the (possibly transformed) keys and verifies
the serve path end to end.  Every ``lookup_batch`` is one point-read
kernel launch (the fused rung, or the streamed rung when the index's
``pool_budget`` selects it) and every ``scan_batch`` one range-scan
launch (NF forward included when the flow is on); a write positions its
keys through the NF kernel and lands in the index's write tiers.

With ``shards=P > 1`` the flat backend is a ``ShardedFlatAFLI``: P
shards at flow-CDF boundaries on ``shard_mesh(P, device)`` (all on one
card when there is one), a router launch of the NF kernel per flow-on
batch, and the per-shard kernels fanned out on CUDA streams.
``lookup_batch_async`` dispatches a read batch and returns a finisher,
single or sharded.

Not ported yet, and raising ``NotImplementedError`` with the ROADMAP
item that ports them: the paper's pointer-tree backend (A13) and drift
re-flow and resharding (A11).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from repro_torch.core.conflict import should_use_flow
from repro_torch.core.feature import expand_features
from repro_torch.core.flat_afli import FlatAFLI, FlatAFLIConfig
from repro_torch.core.flow import FlowConfig
from repro_torch.core.sharded_nfl import ShardedFlatAFLI
from repro_torch.core.train_flow import FlowTrainConfig, train_flow
from repro_torch.kernels import ops
from repro_torch.kernels.backend import resolve_device

__all__ = ["NFL", "NFLConfig"]


@dataclasses.dataclass(frozen=True)
class NFLConfig:
    flow: FlowConfig = dataclasses.field(default_factory=FlowConfig)
    flow_train: FlowTrainConfig = dataclasses.field(
        default_factory=FlowTrainConfig)
    flat_index: FlatAFLIConfig = dataclasses.field(
        default_factory=FlatAFLIConfig)
    gamma: float = 0.99
    force_flow: Optional[bool] = None  # None -> paper's switching mechanism
    backend: str = "afli"              # "afli" (paper tree) | "flat" (fused)
    shards: int = 1                    # flat backend: key-space shards
    drift: Any = None                  # drift telemetry config (ROADMAP A11)
    reshard: Any = None                # resharding config (ROADMAP A11)


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP {item})")


class NFL:
    """Two-stage learned index: Numerical NF + FlatAFLI (one, or one per
    key-space shard)."""

    def __init__(self, config: NFLConfig | None = None,
                 device: Optional[Union[str, torch.device]] = None):
        self.cfg = config or NFLConfig()
        if self.cfg.backend == "afli":
            raise _not_ported("backend='afli' (the paper's pointer tree)",
                              "A13")
        if self.cfg.backend != "flat":
            raise ValueError(f"unknown NFL backend: {self.cfg.backend!r}")
        if getattr(self.cfg.drift, "enabled", False):
            raise _not_ported("drift telemetry and re-flow", "A11")
        if getattr(self.cfg.reshard, "enabled", False):
            raise _not_ported("dynamic resharding", "A11")
        self.device = resolve_device(device)
        if self.cfg.shards > 1:
            self.index = ShardedFlatAFLI(self.cfg.flat_index,
                                         n_shards=self.cfg.shards,
                                         device=self.device)
        else:
            self.index = FlatAFLI(self.cfg.flat_index, device=self.device)
        self.flow_params = None
        self.normalizer = None
        self.use_flow = False
        self.metrics: Dict[str, float] = {}
        self._packed_w = None   # pack_flow_weights row (CPU)
        self._shapes = ()

    # ------------------------------------------------------------ bulkload
    def bulkload(self, keys: np.ndarray, payloads: np.ndarray) -> None:
        """Train the flow, transform the keys through the NF kernel,
        decide the flow (AutoSwitch or ``force_flow``), build the index
        and verify the serve path.  Times land in ``metrics``."""
        keys = np.asarray(keys, dtype=np.float64)
        payloads = np.asarray(payloads, dtype=np.int64)
        t0 = time.perf_counter()
        params, normalizer, train_metrics = train_flow(
            keys, self.cfg.flow, self.cfg.flow_train, device=self.device)
        t_train = time.perf_counter() - t0

        t0 = time.perf_counter()
        transformed = ops.nf_transform_keys(params, normalizer, keys,
                                            self.cfg.flow, self.device)
        t_transform = time.perf_counter() - t0

        use, tail_orig, tail_flow = should_use_flow(keys, transformed,
                                                    self.cfg.gamma)
        if self.cfg.force_flow is not None:
            use = self.cfg.force_flow
        self.use_flow = bool(use)
        self.flow_params = params
        self.normalizer = normalizer
        self._packed_w, self._shapes = self._pack_weights(params)

        t0 = time.perf_counter()
        n_shadow = 0
        if self.use_flow:
            self.index.build(transformed, payloads, ikeys=keys)
            self.index.set_serve_flow(normalizer, self.cfg.flow,
                                      self._packed_w, self._shapes)
            n_shadow = self.index.verify_serve_flow(
                self._feats(keys), keys, self._packed_w, self._shapes,
                payloads)
        else:
            self.index.build(keys, payloads)
        t_build = time.perf_counter() - t0

        self.metrics = {
            **{f"flow_{k}": v for k, v in train_metrics.items()},
            "flow_train_s": t_train,
            "transform_s": t_transform,
            "index_build_s": t_build,
            "tail_conflict_original": float(tail_orig),
            "tail_conflict_transformed": float(tail_flow),
            "use_flow": float(self.use_flow),
            "serve_verify_shadowed": float(n_shadow),
        }

    def _pack_weights(self, params):
        """The flow's ``pack_flow_weights`` row (fused-kernel serve input)."""
        return ops.pack_params(params, self.cfg.flow)

    # ------------------------------------------------------------ batch ops
    def lookup_batch(self, keys: np.ndarray) -> np.ndarray:
        """Batched point lookups; -1 marks not-found.  One fused kernel
        launch per call (NF forward in-kernel when the flow is on)."""
        keys = np.asarray(keys, dtype=np.float64)
        if not self.use_flow:
            return self.index.lookup_batch(keys)
        return self.index.lookup_batch_flow(self._feats(keys), keys,
                                            self._packed_w, self._shapes)

    def lookup_batch_async(self, keys: np.ndarray):
        """Dispatch a batched point lookup without waiting for it; returns
        a zero-argument finisher that returns the payload array.  The
        kernels read the index as it is at dispatch, so a caller can keep
        a second batch in flight behind the first, or write in between,
        and each batch still reads the state it was dispatched into."""
        keys = np.asarray(keys, dtype=np.float64)
        if not self.use_flow:
            return self.index.lookup_batch_async(keys)
        return self.index.lookup_batch_flow_async(
            self._feats(keys), keys, self._packed_w, self._shapes)

    def _pkeys(self, keys: np.ndarray) -> np.ndarray:
        """Positioning keys of a batch: the keys themselves without the
        flow, else z from the NF kernel (bit-equal to the in-kernel NF of
        the lookup and range kernels)."""
        if not self.use_flow:
            return keys
        return ops.nf_transform_keys(self.flow_params, self.normalizer,
                                     keys, self.cfg.flow, self.device)

    def _feats(self, keys: np.ndarray) -> np.ndarray:
        return expand_features(keys, self.normalizer, self.cfg.flow.dim,
                               self.cfg.flow.theta, dtype=np.float32)

    def insert_batch(self, keys: np.ndarray, payloads: np.ndarray) -> None:
        """Batched inserts (an existing key's payload is overwritten)."""
        keys = np.asarray(keys, dtype=np.float64)
        payloads = np.asarray(payloads, dtype=np.int64)
        self.index.insert_batch(self._pkeys(keys), payloads,
                                ikeys=keys if self.use_flow else None)

    def update_batch(self, keys: np.ndarray,
                     payloads: np.ndarray) -> np.ndarray:
        """Batched updates of present keys; per-key success (False: the
        key is absent and is not created).  The write path is last write
        wins by identity, so an update is an insert of present keys."""
        keys = np.asarray(keys, dtype=np.float64)
        ok = self.index.contains_batch(keys)
        if ok.any():
            self.insert_batch(keys[ok], np.asarray(payloads)[ok])
        return ok

    def delete_batch(self, keys: np.ndarray) -> np.ndarray:
        """Batched deletes; per-key success (False: the key is absent).
        Deleted keys vanish from point and range results at once and are
        dropped from the tree by the next fold."""
        keys = np.asarray(keys, dtype=np.float64)
        return self.index.delete_batch(self._pkeys(keys),
                                       ikeys=keys if self.use_flow else None)

    def scan_batch(self, lo_keys: np.ndarray, hi_keys: np.ndarray,
                   cap: int | None = None):
        """Batched ``[lo, hi)`` range scans -> ``(payloads i32[n, cap]
        (-1 padded), counts i32[n], totals i32[n])``: per query the first
        ``counts[i]`` lanes hold the live payloads in range, in
        positioning-key order; ``totals[i] > cap`` flags truncation.
        The order is the key order with the flow off and the z order with
        it on (both endpoints go through the same NF as every stored
        key)."""
        lo_keys = np.asarray(lo_keys, dtype=np.float64)
        hi_keys = np.asarray(hi_keys, dtype=np.float64)
        if not self.use_flow:
            return self.index.scan_batch(lo_keys, hi_keys, cap=cap)
        return self.index.scan_batch_flow(
            self._feats(lo_keys), self._feats(hi_keys), self._packed_w,
            self._shapes, cap=cap)

    # the established range-query spelling beside the batched name
    lookup_range = scan_batch

    def stats(self):
        """The index's ``stats()``; sharded, with each shard's block and
        the router's fan-out counters."""
        return self.index.stats()

    def dispatch_stats(self) -> Dict[str, int]:
        """Kernel launch counters and truncated range queries
        (process-wide, since the last ``ops.reset_launch_counts``), and
        this index's shadowed keys and completed folds."""
        counts = ops.launch_counts()
        return {"nf_forward_launches": counts["nf_forward"],
                "fused_lookup_launches": counts["fused_lookup"],
                "streamed_lookup_launches": counts["streamed_lookup"],
                "fused_range_scan_launches": counts["fused_range_scan"],
                "scan_truncated": ops.fused_range_scan.truncated,
                "shadowed": int(self.index.n_shadowed),
                "rebuilds": int(self.index.n_rebuilds)}
