"""NFL — the two-stage Normalizing-Flow Learned index (paper §3), PyTorch.

Port of ``repro.core.nfl``.  Stage 1 trains the Numerical NF on a sample
of the bulk-loaded keys and transforms every key; the paper's switching
mechanism (AutoSwitch) keeps the flow only if it lowers the tail
conflict degree.  Stage 2 indexes the (possibly transformed) keys.  Two
backends:

* ``backend="afli"`` (the default): the paper's pointer tree
  (``core.afli.AFLI``), on the host, probed key by key, with the full
  read and write API (no range scans).  The flow trains on the device
  and every batch is positioned through ``core.flow.transform_keys``
  (f32 flow on the params' device, f64 sum decode on the host), as the
  reference positions its tree; this path launches no kernel.
* ``backend="flat"``: ``FlatAFLI``, its keys transformed through the NF
  kernel, its serve path verified end to end.

On the flat backend every ``lookup_batch`` is one point-read
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

Drift (DESIGN.md §14): ``NFLConfig.drift`` keeps the telemetry on by
default, as in the JAX package.  Every ``insert_batch`` feeds a decayed
reservoir of the inserted keys (``core.drift.DriftMonitor``) and ticks a
``ReflowManager``, which every ``check_every`` keys measures the
reservoir's tail conflict degree under the serving transform (through
the NF kernel when the flow serves).  With ``drift.reflow`` on, a score
past ``threshold`` trains a candidate flow a few minibatches per write
call, validates it against the identity and the serving tail, and
starts ``FlatAFLI.start_reflow``: a re-keying fold the write calls
advance while the index serves, whose swap installs the new tree, serve
flow and re-keyed delta in one step.  ``dispatch_stats()["drift"]``
reports the manager's counters and the index's drift signals.  With
``shards > 1`` the re-flow is the cross-shard re-key
(``ShardedFlatAFLI.start_reflow``), which also re-derives the shard
boundaries from the new flow.

Resharding (DESIGN.md §18): with ``NFLConfig.reshard.enabled`` (sharded
only) every routed batch, reads and writes alike, feeds a
``ReshardManager``, which every ``check_every`` keys reads the router's
decayed per-shard load gauges and, when one shard takes ``hot_frac / P``
of the load, starts a boundary migration of the window around it
(``ShardedFlatAFLI.start_reshard``).  The two managers share one
exclusion token, so a migration and a re-key never interleave.
``dispatch_stats()["reshard"]`` reports the manager and the gauges.

Drift telemetry and re-flow, and resharding, ride the flat backend only:
``drift.reflow`` or ``reshard.enabled`` on the AFLI backend raises
``ValueError``, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from repro_torch.core.afli import AFLI, AFLIConfig
from repro_torch.core.conflict import dataset_tail_conflict, should_use_flow
from repro_torch.core.drift import (DriftConfig, DriftMonitor, ExclusionLock,
                                    ReflowManager, ReshardConfig,
                                    ReshardManager)
from repro_torch.core.feature import expand_features
from repro_torch.core.flat_afli import FlatAFLI, FlatAFLIConfig
from repro_torch.core.flow import FlowConfig, transform_keys
from repro_torch.core.sharded_nfl import ShardedFlatAFLI
from repro_torch.core.train_flow import (FlowTrainConfig, FlowTrainer,
                                         train_flow)
from repro_torch.kernels import counters, ops
from repro_torch.kernels.backend import resolve_device

__all__ = ["NFL", "NFLConfig"]


@dataclasses.dataclass(frozen=True)
class NFLConfig:
    flow: FlowConfig = dataclasses.field(default_factory=FlowConfig)
    flow_train: FlowTrainConfig = dataclasses.field(
        default_factory=FlowTrainConfig)
    index: AFLIConfig = dataclasses.field(default_factory=AFLIConfig)
    flat_index: FlatAFLIConfig = dataclasses.field(
        default_factory=FlatAFLIConfig)
    gamma: float = 0.99
    force_flow: Optional[bool] = None  # None -> paper's switching mechanism
    backend: str = "afli"              # "afli" (paper tree) | "flat" (fused)
    shards: int = 1                    # flat backend: key-space shards
    drift: DriftConfig = dataclasses.field(default_factory=DriftConfig)
                                       # drift telemetry + background
                                       # re-flow (flat backend, §14)
    reshard: ReshardConfig = dataclasses.field(
        default_factory=ReshardConfig)
                                       # hot-shard load telemetry +
                                       # boundary migration (sharded
                                       # flat backend, §18)


class NFL:
    """Two-stage learned index: Numerical NF + AFLI (the paper's tree) or
    FlatAFLI (one, or one per key-space shard)."""

    def __init__(self, config: NFLConfig | None = None,
                 device: Optional[Union[str, torch.device]] = None):
        self.cfg = config or NFLConfig()
        if self.cfg.backend not in ("afli", "flat"):
            raise ValueError(f"unknown NFL backend: {self.cfg.backend!r}")
        self._flat = self.cfg.backend == "flat"
        if self.cfg.drift.reflow and not self._flat:
            raise ValueError("drift.reflow requires backend='flat' (the "
                             "re-key rides the incremental-fold machinery)")
        if self.cfg.reshard.enabled and (not self._flat
                                         or self.cfg.shards < 2):
            raise ValueError("reshard.enabled requires backend='flat' "
                             "with shards > 1 (boundary migration moves "
                             "the sharded router's boundaries)")
        self.device = resolve_device(device)
        if not self._flat:
            self.index = AFLI(self.cfg.index)
        elif self.cfg.shards > 1:
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
        # drift telemetry + background re-flow (§14) and resharding
        # (§18).  The lock serializes the ticks on the serving path
        # against a dispatch_stats(reset=True) from another thread
        # (RLock: the ticks' callables may read stats); one exclusion
        # token, shared by both managers, keeps a re-key and a migration
        # from interleaving
        self._telemetry_lock = threading.RLock()
        self._exclusion = ExclusionLock()
        self._drift: Optional[DriftMonitor] = None
        self._reflow: Optional[ReflowManager] = None
        self._reshard: Optional[ReshardManager] = None
        if self._flat and self.cfg.drift.enabled:
            self._drift = DriftMonitor(self.cfg.drift)
            self._reflow = ReflowManager(
                self.cfg.drift, self._drift,
                serving_tail=self._drift_serving_tail,
                train_factory=self._drift_train_factory,
                evaluate=self._drift_evaluate,
                apply=self._drift_apply,
                exclusion=self._exclusion)
        if self.cfg.reshard.enabled:
            self.index.load_window_keys = int(
                self.cfg.reshard.load_window_keys)
            self._reshard = ReshardManager(
                self.cfg.reshard,
                load_snapshot=self.index.load_snapshot,
                start_migration=self._reshard_apply,
                exclusion=self._exclusion)

    # ------------------------------------------------------------ bulkload
    def bulkload(self, keys: np.ndarray, payloads: np.ndarray) -> None:
        """Train the flow on the device, transform the keys (the NF
        kernel on the flat backend, ``transform_keys`` on the AFLI
        backend), decide the flow (AutoSwitch or ``force_flow``), build
        the index and, on the flat backend, verify the serve path.
        Times land in ``metrics``."""
        keys = np.asarray(keys, dtype=np.float64)
        payloads = np.asarray(payloads, dtype=np.int64)
        t0 = time.perf_counter()
        params, normalizer, train_metrics = train_flow(
            keys, self.cfg.flow, self.cfg.flow_train, device=self.device)
        t_train = time.perf_counter() - t0

        t0 = time.perf_counter()
        transformed = self._transform(params, normalizer, keys)
        t_transform = time.perf_counter() - t0

        use, tail_orig, tail_flow = should_use_flow(keys, transformed,
                                                    self.cfg.gamma)
        if self.cfg.force_flow is not None:
            use = self.cfg.force_flow
        self.use_flow = bool(use)
        self.flow_params = params
        self.normalizer = normalizer
        if self._flat:
            self._packed_w, self._shapes = self._pack_weights(params)

        t0 = time.perf_counter()
        n_shadow = 0
        if not self._flat:
            if self.use_flow:
                self.index.bulkload(transformed, payloads, ikeys=keys)
            else:
                self.index.bulkload(keys, payloads)
        elif self.use_flow:
            self.index.build(transformed, payloads, ikeys=keys)
            self.index.set_serve_flow(normalizer, self.cfg.flow,
                                      self._packed_w, self._shapes)
            n_shadow = self.index.verify_serve_flow(
                self._feats(keys), keys, self._packed_w, self._shapes,
                payloads)
        else:
            self.index.build(keys, payloads)
        t_build = time.perf_counter() - t0

        if self._drift is not None:
            # prime the reservoir with the build distribution and anchor
            # the score at the accepted transform's tail over all the
            # bulk-loaded keys
            self._drift.seed(keys)
            self._reflow.set_baseline(tail_flow if self.use_flow
                                      else tail_orig)

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

    def _transform(self, params, normalizer, keys: np.ndarray) -> np.ndarray:
        """Positioning keys on the backend's path: the NF kernel on the
        flat backend (build and serve placement bit-identical), the f32
        flow and f64 decode of ``transform_keys`` on the AFLI backend
        (the reference positions its tree so)."""
        if self._flat:
            return ops.nf_transform_keys(params, normalizer, keys,
                                         self.cfg.flow, self.device)
        return transform_keys(params, normalizer, keys, self.cfg.flow)

    def _pack_weights(self, params):
        """The flow's ``pack_flow_weights`` row (fused-kernel serve input)."""
        return ops.pack_params(params, self.cfg.flow)

    # ----------------------------------------------- drift callbacks (§14)
    def _drift_serving_tail(self, sample: np.ndarray) -> int:
        """Tail conflict degree of the reservoir sample under the
        transform now serving: z from the NF kernel when the flow
        serves, the keys themselves when it does not."""
        sample = np.asarray(sample, dtype=np.float64)
        if self.use_flow:
            z = ops.nf_transform_keys(self.flow_params, self.normalizer,
                                      sample, self.cfg.flow, self.device)
            if not np.all(np.isfinite(z)):
                raise ValueError("serving flow produced non-finite z on "
                                 "the drift sample")
            return dataset_tail_conflict(z, self.cfg.drift.gamma)
        return dataset_tail_conflict(sample, self.cfg.drift.gamma)

    def _drift_train_factory(self, sample: np.ndarray, attempt: int):
        """A step-wise retrainer over the reservoir sample, on the
        index's device; the attempt index perturbs the seed so a failed
        episode does not repeat itself."""
        d = self.cfg.drift
        tcfg = FlowTrainConfig(
            sample_frac=1.0,
            epochs=max(int(d.train_epochs), 1),
            batch_size=max(min(int(d.train_batch), len(sample)), 1),
            lr=self.cfg.flow_train.lr,
            seed=int(d.seed) + int(attempt),
            feature_standardize=self.cfg.flow_train.feature_standardize)
        return FlowTrainer(np.asarray(sample, np.float64), self.cfg.flow,
                           tcfg, device=self.device)

    def _drift_evaluate(self, trainer, sample: np.ndarray):
        """Finish the retrained flow into a candidate and measure its
        tail on the sample through the NF kernel.  Raises on non-finite
        z: an unusable candidate is a failed episode, never a served
        transform."""
        params, normalizer, _metrics = trainer.result()
        z = ops.nf_transform_keys(params, normalizer,
                                  np.asarray(sample, np.float64),
                                  self.cfg.flow, self.device)
        if not np.all(np.isfinite(z)):
            raise ValueError("candidate flow produced non-finite z")
        return (dataset_tail_conflict(z, self.cfg.drift.gamma),
                (params, normalizer))

    def _drift_apply(self, candidate, use_flow: bool,
                     accepted_tail: int) -> bool:
        """Start the re-key under the accepted candidate (flow or
        identity).  The index owns the atomicity; ``on_swap`` installs
        this object's flow state at the instant the structure adopts the
        new positioning keys, then closes the manager's episode."""
        if use_flow:
            params, normalizer = candidate
            packed_w, shapes = self._pack_weights(params)
            flow_cfg, dev = self.cfg.flow, self.device

            def transform_fn(k64):
                return ops.nf_transform_keys(params, normalizer, k64,
                                             flow_cfg, dev)

            serve_ctx = (normalizer, flow_cfg, packed_w, shapes)

            def on_swap():
                self.use_flow = True
                self.flow_params = params
                self.normalizer = normalizer
                self._packed_w, self._shapes = packed_w, shapes
                self._reflow.note_swap()
        else:  # flow -> identity: position by the raw keys again
            def transform_fn(k64):
                return np.asarray(k64, np.float64)

            serve_ctx = None

            def on_swap():
                self.use_flow = False
                self._reflow.note_swap()

        return self.index.start_reflow(transform_fn, serve_ctx, on_swap)

    # -------------------------------------------- reshard callbacks (§18)
    def _reshard_apply(self, lo: int, hi: int) -> bool:
        """Start the boundary migration of the shard window ``[lo, hi]``.
        The index owns the atomicity and the rollback; its swap and abort
        callbacks close the manager's episode."""
        return self.index.start_reshard(
            lo, hi, on_swap=self._reshard.note_swap,
            on_abort=self._reshard.note_failure)

    def _reshard_note(self, n_keys: int) -> None:
        """Feed one routed batch (reads and writes alike: read skew is
        the trigger) to the reshard manager and give it one tick, under
        the lock the drift tick takes."""
        if self._reshard is None:
            return
        with self._telemetry_lock:
            self._reshard.observe(int(n_keys))
            self._reshard.tick()

    # ------------------------------------------------------------ batch ops
    def lookup_batch(self, keys: np.ndarray) -> np.ndarray:
        """Batched point lookups; -1 marks not-found.  One fused kernel
        launch per call (NF forward in-kernel when the flow is on)."""
        keys = np.asarray(keys, dtype=np.float64)
        if not self._flat:
            found = map(self.index.lookup, self._pkeys(keys).tolist(),
                        keys.tolist())
            return np.fromiter((-1 if r is None else r for r in found),
                               dtype=np.int64, count=keys.shape[0])
        if not self.use_flow:
            res = self.index.lookup_batch(keys)
        else:
            res = self.index.lookup_batch_flow(self._feats(keys), keys,
                                               self._packed_w, self._shapes)
        self._reshard_note(keys.shape[0])
        return res

    def lookup_batch_async(self, keys: np.ndarray):
        """Dispatch a batched point lookup without waiting for it; returns
        a zero-argument finisher that returns the payload array.  The
        kernels read the index as it is at dispatch, so a caller can keep
        a second batch in flight behind the first, or write in between,
        and each batch still reads the state it was dispatched into.
        The AFLI backend has no device path: its lookup runs eagerly and
        the finisher hands the result back."""
        keys = np.asarray(keys, dtype=np.float64)
        if not self._flat:
            res = self.lookup_batch(keys)
            return lambda: res
        if not self.use_flow:
            finish = self.index.lookup_batch_async(keys)
        else:
            finish = self.index.lookup_batch_flow_async(
                self._feats(keys), keys, self._packed_w, self._shapes)
        # the kernels are in flight: the reshard tick overlaps them
        self._reshard_note(keys.shape[0])
        return finish

    def _pkeys(self, keys: np.ndarray) -> np.ndarray:
        """Positioning keys of a batch: the keys themselves without the
        flow, else z on the backend's path (on the flat backend bit-equal
        to the in-kernel NF of the lookup and range kernels)."""
        if not self.use_flow:
            return keys
        return self._transform(self.flow_params, self.normalizer, keys)

    def _feats(self, keys: np.ndarray) -> np.ndarray:
        return expand_features(keys, self.normalizer, self.cfg.flow.dim,
                               self.cfg.flow.theta, dtype=np.float32)

    def insert_batch(self, keys: np.ndarray, payloads: np.ndarray) -> None:
        """Batched inserts (an existing key's payload is overwritten)."""
        keys = np.asarray(keys, dtype=np.float64)
        payloads = np.asarray(payloads, dtype=np.int64)
        if not self._flat:
            insert = self.index.insert
            for p, v, k in zip(self._pkeys(keys).tolist(), payloads.tolist(),
                               keys.tolist()):
                insert(p, v, k)
            return
        self.index.insert_batch(self._pkeys(keys), payloads,
                                ikeys=keys if self.use_flow else None)
        if self._drift is not None:
            with self._telemetry_lock:
                self._drift.observe(keys)
                self._reflow.tick()
        self._reshard_note(keys.shape[0])

    def update_batch(self, keys: np.ndarray,
                     payloads: np.ndarray) -> np.ndarray:
        """Batched updates of present keys; per-key success (False: the
        key is absent and is not created).  The write path is last write
        wins by identity, so an update is an insert of present keys."""
        keys = np.asarray(keys, dtype=np.float64)
        if not self._flat:
            return np.fromiter(
                map(self.index.update, self._pkeys(keys).tolist(),
                    np.asarray(payloads, np.int64).tolist(), keys.tolist()),
                dtype=bool, count=keys.shape[0])
        ok = self.index.contains_batch(keys)
        if ok.any():
            self.insert_batch(keys[ok], np.asarray(payloads)[ok])
        return ok

    def delete_batch(self, keys: np.ndarray) -> np.ndarray:
        """Batched deletes; per-key success (False: the key is absent).
        Deleted keys vanish from point and range results at once and are
        dropped from the tree by the next fold."""
        keys = np.asarray(keys, dtype=np.float64)
        if not self._flat:
            return np.fromiter(
                map(self.index.delete, self._pkeys(keys).tolist(),
                    keys.tolist()),
                dtype=bool, count=keys.shape[0])
        res = self.index.delete_batch(self._pkeys(keys),
                                      ikeys=keys if self.use_flow else None)
        self._reshard_note(keys.shape[0])
        return res

    def scan_batch(self, lo_keys: np.ndarray, hi_keys: np.ndarray,
                   cap: int | None = None):
        """Batched ``[lo, hi)`` range scans -> ``(payloads i32[n, cap]
        (-1 padded), counts i32[n], totals i32[n])``: per query the first
        ``counts[i]`` lanes hold the live payloads in range, in
        positioning-key order; ``totals[i] > cap`` flags truncation.
        The order is the key order with the flow off and the z order with
        it on (both endpoints go through the same NF as every stored
        key).  The flat backend only: the AFLI backend raises
        ``NotImplementedError``."""
        if not self._flat:
            raise NotImplementedError(
                "range scans are served by the flat backend's fused "
                "range-scan kernel; use backend='flat'")
        lo_keys = np.asarray(lo_keys, dtype=np.float64)
        hi_keys = np.asarray(hi_keys, dtype=np.float64)
        if not self.use_flow:
            res = self.index.scan_batch(lo_keys, hi_keys, cap=cap)
        else:
            res = self.index.scan_batch_flow(
                self._feats(lo_keys), self._feats(hi_keys), self._packed_w,
                self._shapes, cap=cap)
        self._reshard_note(lo_keys.shape[0])
        return res

    # the established range-query spelling beside the batched name
    lookup_range = scan_batch

    def stats(self):
        """The index's ``stats()``: ``AFLIStats`` on the AFLI backend;
        sharded, with each shard's block and the router's fan-out
        counters."""
        return self.index.stats()

    def dispatch_stats(self, reset: bool = False) -> Dict[str, Any]:
        """Serving telemetry: the kernel launch counters and truncated
        range queries (process-wide, CUDA launches only, since the last
        ``ops.reset_launch_counts``), the dispatch counters of the two
        shims (``dispatch``: ``ops.fused_lookup_stats``, on every
        device), this index's
        shadowed keys and completed folds, the serving-state block
        (``serving``; sharded, the shards' aggregate beside ``shards``
        and ``router``), the drift block (``drift``: the re-flow
        manager's state and counters and the index's drift signals) and
        the reshard block (``reshard``: the migration manager's state and
        counters and the router's load gauges).

        ``reset=True`` zeroes the counters after the snapshot: the
        launch and dispatch counters, the serving-state and router
        counters.  Every process-wide counter is read and zeroed in one
        critical section of ``kernels.counters.LOCK``, so a dispatch
        from another thread lands in this snapshot or the next, never in
        none.  Gauges (capacities, windows, the load gauges) and the
        episode counters of both managers are state and stay.

        The AFLI backend launches nothing: its block is ``dispatch``
        alone, as in the JAX package."""
        if not self._flat:
            with counters.LOCK:
                return {"dispatch": ops.fused_lookup_stats(reset=reset)}
        with self._telemetry_lock:
            with counters.LOCK:
                truncated = ops.fused_range_scan.truncated
                counts = ops.launch_counts(reset=reset)
                dispatch = ops.fused_lookup_stats(reset=reset)
            out: Dict[str, Any] = {
                "nf_forward_launches": counts["nf_forward"],
                "fused_lookup_launches": counts["fused_lookup"],
                "streamed_lookup_launches": counts["streamed_lookup"],
                "fused_range_scan_launches": counts["fused_range_scan"],
                "scan_truncated": truncated,
                "dispatch": dispatch,
                "shadowed": int(self.index.n_shadowed),
                "rebuilds": int(self.index.n_rebuilds)}
            out.update(self.index.serving_telemetry())
            if self._reflow is not None:
                out["drift"] = {"enabled": True, "use_flow": self.use_flow,
                                **self._reflow.stats(),
                                "signals": self.index.drift_signals()}
            else:
                out["drift"] = {"enabled": False}
            if self._reshard is not None:
                out["reshard"] = {"enabled": True, **self._reshard.stats(),
                                  "load": self.index.load_snapshot()}
            else:
                out["reshard"] = {"enabled": False}
            if reset:
                self.index.reset_telemetry()
        return out
