"""The port's SLO front end and fault injection (DESIGN.md §16) on the CPU.

Mirrors ``tests/test_frontend.py`` case by case on ``repro_torch``
(plain versions of the kernels): exact terminal accounting, dict-oracle
correctness under overload, mid-fold and mid-re-flow write storms
(single and sharded), every injectable fault, and the concurrent
telemetry reset.  Two cases differ from the reference on purpose: the
overload case overloads with an injected device stall, so it sheds on
any machine, and the retrain-failure case uses drift knobs under which
the drift check triggers (the reference's never trigger, so its fault
never fires).  Then a cross-package parity check: one flow-off index
and one request list through the JAX ``FrontEnd`` and the port's, both
on the same step clock, fault-free and under transient errors; and unit
checks of the new ``ops`` dispatch counters, launch counters and fault
plan.

The oracle seam is ``FrontEnd.on_batch_dispatched``: the hook fires
once per batch in dispatch order, which is the order the index applies,
so a dict oracle driven from it is exact even while read batches are in
flight behind writes.
"""

import dataclasses
import os
import sys
import threading
import time

import numpy as np
import pytest

from repro_torch.core.drift import DriftConfig, ReshardConfig
from repro_torch.core.flat_afli import FlatAFLI, FlatAFLIConfig
from repro_torch.core.nfl import NFL, NFLConfig
from repro_torch.core.train_flow import FlowTrainConfig
from repro_torch.kernels import counters, ops
from repro_torch.kernels import fused_lookup as t_fl
from repro_torch.kernels import nf_forward as t_nf
from repro_torch.serve import faults
from repro_torch.serve import frontend as t_frontend
from repro_torch.serve.frontend import (COMPLETED, EXPIRED, SHED, FrontEnd,
                                        FrontEndConfig, ServiceRequest)

_TERMINAL = (COMPLETED, SHED, EXPIRED)
_SLACK = 60.0   # "no deadline pressure" SLO for correctness-only tests
# batches the overload test serves under its stall before the burst, so
# the service model's EWMA (step 0.25) keeps 0.75^8 = 0.1 of its seed
_WARM_BATCHES = 8


@pytest.fixture(autouse=True)
def _no_fault_plan():
    """Every case starts and ends without an installed fault plan."""
    ops.clear_fault_plan()
    yield
    ops.clear_fault_plan()


def _build_nfl(n=1500, seed=0, shards=1, **cfg_kw):
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.uniform(0.0, 1e6, 3 * n))[:n]
    pay = np.arange(keys.shape[0], dtype=np.int64)
    nfl = NFL(NFLConfig(backend="flat", shards=shards, force_flow=False,
                        **cfg_kw), device="cpu")
    nfl.bulkload(keys, pay)
    return nfl, keys, dict(zip(keys.tolist(), pay.tolist()))


class _Oracle:
    """Dict oracle applied in dispatch order via the front-end hook;
    records per-request expectations by request id."""

    def __init__(self, oracle: dict):
        self.d = oracle
        self.expected = {}

    def hook(self, op, reqs):
        if op == "point":
            for r in reqs:
                self.expected[r.rid] = self.d.get(r.key, -1)
        elif op == "range":
            for r in reqs:
                ks = sorted(k for k in self.d if r.key <= k < r.hi)
                self.expected[r.rid] = [self.d[k] for k in ks]
        elif op == "insert":
            for r in reqs:
                self.d[r.key] = r.payload
        else:  # delete
            for r in reqs:
                self.expected[r.rid] = r.key in self.d
                self.d.pop(r.key, None)

    def check(self, reqs) -> int:
        """Count served results diverging from the dispatch-time
        expectation (completed AND late-expired: late results must still
        be correct, they are just useless)."""
        wrong = 0
        for r in reqs:
            if r.rid not in self.expected or r.result is None:
                continue
            exp = self.expected[r.rid]
            if r.op == "point" or r.op == "delete":
                wrong += int(r.result != exp)
            elif r.op == "range":
                got, _tot = r.result
                wrong += int(list(got) != list(exp))
        return wrong


def _mixed_requests(rng, n, known, spare, deadline_s,
                    p=(0.7, 0.1, 0.15, 0.05), make=ServiceRequest):
    reqs, si = [], 0
    pool = list(known)
    for rid in range(n):
        u = rng.random()
        if u < p[0] or si >= len(spare):
            r = make(rid, "point", float(rng.choice(pool)),
                     deadline_s=deadline_s)
        elif u < p[0] + p[1]:
            lo = float(rng.choice(pool))
            r = make(rid, "range", lo, hi=lo * (1 + 1e-3),
                     deadline_s=deadline_s)
        elif u < p[0] + p[1] + p[2]:
            r = make(rid, "insert", float(spare[si]),
                     payload=1_000_000 + si, deadline_s=deadline_s)
            pool.append(float(spare[si]))
            si += 1
        else:
            r = make(rid, "delete", float(rng.choice(pool)),
                     deadline_s=deadline_s)
        reqs.append(r)
    return reqs


def _submit_drain(fe, reqs):
    for r in reqs:
        fe.submit(r)
    fe.drain()


def _assert_terminal_exactly_once(fe, reqs):
    c = fe.counters
    assert c["admitted"] == len(reqs)
    assert c["admitted"] == c["completed"] + c["shed"] + c["expired"]
    for r in reqs:
        assert r.state in _TERMINAL, (r.rid, r.state)
        assert r.t_done >= r.t_submit >= 0.0


# ------------------------------------------------------------- mirrors
def test_terminal_state_property_mixed_deadlines():
    """Random op mixes with a spread of deadlines (some unmeetably
    tight, some slack): every request lands in exactly one terminal
    state, the accounting identity is exact, and every served result
    matches the dispatch-time oracle."""
    nfl, keys, oracle = _build_nfl()
    spare = np.unique(np.random.default_rng(9).uniform(2e6, 3e6, 600))
    si = 0
    for trial in range(4):
        rng = np.random.default_rng(100 + trial)
        orc = _Oracle(oracle)
        fe = FrontEnd(nfl, FrontEndConfig(max_batch=32,
                                          batch_timeout_s=5e-4))
        fe.on_batch_dispatched = orc.hook
        reqs = _mixed_requests(rng, 150, keys, spare[si:si + 40],
                               deadline_s=_SLACK)
        si += 40
        for r in reqs:
            if rng.random() < 0.33:
                r.deadline_s = 1e-6
        _submit_drain(fe, reqs)
        _assert_terminal_exactly_once(fe, reqs)
        assert orc.check(reqs) == 0
        assert fe.counters["shed"] + fe.counters["expired"] > 0


def test_admission_off_serves_everything_exactly():
    nfl, keys, oracle = _build_nfl(seed=1)
    rng = np.random.default_rng(2)
    spare = np.unique(rng.uniform(2e6, 3e6, 200))
    orc = _Oracle(oracle)
    fe = FrontEnd(nfl, FrontEndConfig(max_batch=64, batch_timeout_s=1e-3,
                                      admission=False,
                                      expire_queued=False))
    fe.on_batch_dispatched = orc.hook
    reqs = _mixed_requests(rng, 300, keys, spare, deadline_s=_SLACK)
    _submit_drain(fe, reqs)
    _assert_terminal_exactly_once(fe, reqs)
    assert fe.counters["shed"] == 0
    assert fe.counters["completed"] == len(reqs)
    assert orc.check(reqs) == 0


def test_overload_sheds_and_stays_exact():
    """Everything submitted at once with a deadline shorter than the
    backlog can serve: admission control must shed rather than serve
    late, and nothing served may be wrong.  The overload is an injected
    5 ms stall on every dispatch (25 batches of 32 take at least 125 ms
    against a 20 ms deadline), so it does not depend on the host's
    speed.  The front end's service model learns the stalled dispatch
    (``_WARM_BATCHES`` batches under the same plan, served before the
    burst): admission then sees the backlog from its first batch.  With
    the model at its 5 ms seed instead, a host slow enough that the
    first stalled dispatch outlasts the deadline meets every other
    request already expired in the queue, and nothing is shed by
    admission."""
    nfl, keys, oracle = _build_nfl(seed=3)
    rng = np.random.default_rng(4)
    orc = _Oracle(oracle)
    fe = FrontEnd(nfl, FrontEndConfig(max_batch=32, batch_timeout_s=1e-4))
    fe.on_batch_dispatched = orc.hook
    for _ in range(3):
        nfl.lookup_batch(rng.choice(keys, 32, replace=False))
    warm = [ServiceRequest(-1 - i, "point", float(rng.choice(keys)),
                           deadline_s=_SLACK)
            for i in range(32 * _WARM_BATCHES)]
    reqs = [ServiceRequest(i, "point", float(rng.choice(keys)),
                           deadline_s=0.02) for i in range(800)]
    plan = faults.FaultPlan(device_stall_s=5e-3)
    with faults.inject(plan):
        _submit_drain(fe, warm)
    assert fe.counters["completed"] == len(warm)
    faults.injection_stats(reset=True)
    with faults.inject(plan):
        _submit_drain(fe, reqs)
    assert faults.injection_stats()["stalls"] > 0
    _assert_terminal_exactly_once(fe, warm + reqs)
    assert fe.counters["shed"] + fe.counters["expired"] > 0
    assert fe.reasons["shed-admission"] > 0
    assert orc.check(reqs) == 0
    for r in reqs:
        if r.state == COMPLETED:
            assert r.latency_s <= r.deadline_s + 1e-9


def test_sharded_frontend_mixed_exact():
    nfl, keys, oracle = _build_nfl(n=1200, seed=5, shards=2)
    rng = np.random.default_rng(6)
    spare = np.unique(rng.uniform(2e6, 3e6, 300))
    orc = _Oracle(oracle)
    fe = FrontEnd(nfl, FrontEndConfig(max_batch=48, batch_timeout_s=1e-3))
    fe.on_batch_dispatched = orc.hook
    reqs = _mixed_requests(rng, 400, keys, spare, deadline_s=_SLACK)
    _submit_drain(fe, reqs)
    _assert_terminal_exactly_once(fe, reqs)
    assert orc.check(reqs) == 0
    assert fe.counters["completed"] > 0


def test_mid_fold_write_storm_exact():
    """A write-heavy stream through squeezed tier bounds: batches land
    mid-fold constantly; reads dispatched around fold ticks must still
    match the dispatch-time oracle."""
    nfl, keys, oracle = _build_nfl(
        n=1200, seed=7,
        flat_index=FlatAFLIConfig(delta_cap=24, fold_step_keys=48,
                                  fold_work_factor=4.0))
    rng = np.random.default_rng(8)
    spare = np.unique(rng.uniform(2e6, 3e6, 2000))
    orc = _Oracle(oracle)
    fe = FrontEnd(nfl, FrontEndConfig(max_batch=24, batch_timeout_s=5e-4))
    fe.on_batch_dispatched = orc.hook
    reqs = _mixed_requests(rng, 500, keys, spare, deadline_s=_SLACK,
                           p=(0.40, 0.05, 0.45, 0.10))
    _submit_drain(fe, reqs)
    _assert_terminal_exactly_once(fe, reqs)
    assert orc.check(reqs) == 0


def _drift_nfl(keys, drift):
    nfl = NFL(NFLConfig(
        backend="flat", force_flow=True,
        flow_train=FlowTrainConfig(epochs=1),
        flat_index=FlatAFLIConfig(fold_step_keys=2048), drift=drift),
        device="cpu")
    nfl.bulkload(keys, np.arange(keys.shape[0], dtype=np.int64))
    return nfl


def test_mid_reflow_write_storm_exact():
    """Flow-on serving with an aggressive background re-flow: the §14
    machinery retrains and re-keys underneath the front end while the
    stream keeps flowing.  Every served result stays oracle-exact
    across the swap."""
    rng = np.random.default_rng(11)
    keys = np.unique(rng.lognormal(0, 2.0, 4000))[:1500]
    nfl = _drift_nfl(keys, DriftConfig(
        reflow=True, threshold=1.2, min_tail=2, check_every=64,
        window_keys=1024, cooldown_keys=512, train_epochs=1,
        train_batch=128, steps_per_tick=8, seed=0))
    oracle = dict(zip(keys.tolist(), range(keys.shape[0])))
    centers = np.quantile(keys, np.linspace(0.9, 0.999, 8))
    drift = np.unique(np.concatenate(
        [c * (1 + rng.uniform(0, 1e-4, 150)) for c in centers]))
    drift = drift[~np.isin(drift, keys)]
    orc = _Oracle(oracle)
    fe = FrontEnd(nfl, FrontEndConfig(max_batch=32, batch_timeout_s=5e-4))
    fe.on_batch_dispatched = orc.hook
    reqs, si = [], 0
    pool = list(keys)
    for rid in range(420):
        if rng.random() < 0.5 and si < drift.shape[0]:
            r = ServiceRequest(rid, "insert", float(drift[si]),
                               payload=2_000_000 + si, deadline_s=_SLACK)
            pool.append(float(drift[si]))
            si += 1
        else:
            r = ServiceRequest(rid, "point", float(rng.choice(pool)),
                               deadline_s=_SLACK)
        reqs.append(r)
    _submit_drain(fe, reqs)
    _assert_terminal_exactly_once(fe, reqs)
    assert orc.check(reqs) == 0
    st = nfl.dispatch_stats()["drift"]
    assert st["enabled"] and st["checks"] > 0


# ------------------------------------------------------- fault injection
def test_fault_forced_fallback_exact_and_attributed():
    """The JAX package's forced oracle rung has no counterpart: the port
    has no oracle rung, and no kernel gives way to its plain version on
    the card.  ``inject`` refuses ``force_oracle`` before it installs
    anything, and the trace is then served exactly on the fused rung."""
    nfl, keys, oracle = _build_nfl(n=800, seed=12)
    rng = np.random.default_rng(13)
    orc = _Oracle(oracle)
    fe = FrontEnd(nfl, FrontEndConfig(max_batch=32, batch_timeout_s=1e-3,
                                      admission=False,
                                      expire_queued=False))
    fe.on_batch_dispatched = orc.hook
    nfl.dispatch_stats(reset=True)
    faults.injection_stats(reset=True)
    reqs = [ServiceRequest(i, "point", float(rng.choice(keys)),
                           deadline_s=_SLACK) for i in range(200)]
    defaults = dict(ops._FAULT_PLAN)
    with pytest.raises(ValueError, match="force_oracle.*no counterpart"):
        with faults.inject(faults.FaultPlan(force_oracle=True,
                                            dispatch_error_every=1)):
            pass
    assert ops._FAULT_PLAN == defaults
    _submit_drain(fe, reqs)
    assert nfl.index.last_dispatch["path"] == "fused"
    _assert_terminal_exactly_once(fe, reqs)
    assert orc.check(reqs) == 0
    d = nfl.dispatch_stats()["dispatch"]
    assert d["fused_count"] == d["dispatch_count"] == fe.counters["batches"]
    assert "fallback_count" not in d and "fallback_reasons" not in d
    assert faults.injection_stats()["transient_errors"] == 0
    assert nfl.index.last_dispatch["path"] == "fused"


def test_fault_transient_errors_are_retried():
    nfl, keys, oracle = _build_nfl(n=800, seed=14)
    rng = np.random.default_rng(15)
    orc = _Oracle(oracle)
    fe = FrontEnd(nfl, FrontEndConfig(max_batch=32, batch_timeout_s=1e-3,
                                      admission=False, expire_queued=False,
                                      retry_backoff_s=1e-4))
    fe.on_batch_dispatched = orc.hook
    reqs = [ServiceRequest(i, "point", float(rng.choice(keys)),
                           deadline_s=_SLACK) for i in range(150)]
    with faults.inject(faults.FaultPlan(dispatch_error_every=3)):
        _submit_drain(fe, reqs)
    _assert_terminal_exactly_once(fe, reqs)
    assert fe.counters["completed"] == len(reqs)
    assert fe.counters["retries"] > 0
    assert fe.counters["retry_giveups"] == 0
    assert orc.check(reqs) == 0


def test_fault_retry_exhaustion_sheds_loudly():
    """Every dispatch fails, including every retry: the batch resolves
    as shed(reason=error) — bounded retries, no silent drop, no
    unbounded spin — and the index is unchanged."""
    nfl, keys, _ = _build_nfl(n=400, seed=16)
    fe = FrontEnd(nfl, FrontEndConfig(max_batch=16, batch_timeout_s=1e-4,
                                      admission=False, expire_queued=False,
                                      max_retries=2, retry_backoff_s=1e-5))
    reqs = [ServiceRequest(i, "point", float(keys[i]), deadline_s=_SLACK)
            for i in range(40)]
    before = nfl.lookup_batch(keys)
    with faults.inject(faults.FaultPlan(dispatch_error_every=1)):
        _submit_drain(fe, reqs)
    _assert_terminal_exactly_once(fe, reqs)
    assert fe.counters["shed"] == len(reqs)
    assert fe.counters["retry_giveups"] > 0
    assert all(r.reason == "error" for r in reqs)
    assert np.array_equal(nfl.lookup_batch(keys), before)


def test_fault_stalls_and_slow_folds_degrade_not_break():
    nfl, keys, oracle = _build_nfl(
        n=600, seed=17,
        flat_index=FlatAFLIConfig(delta_cap=24, fold_step_keys=48,
                                  fold_work_factor=4.0,
                                  rebuild_frac=0.02))
    rng = np.random.default_rng(18)
    spare = np.unique(rng.uniform(2e6, 3e6, 400))
    orc = _Oracle(oracle)
    fe = FrontEnd(nfl, FrontEndConfig(max_batch=16, batch_timeout_s=1e-4,
                                      admission=False, expire_queued=False))
    fe.on_batch_dispatched = orc.hook
    faults.injection_stats(reset=True)
    reqs = _mixed_requests(rng, 120, keys, spare, deadline_s=_SLACK,
                           p=(0.5, 0.0, 0.4, 0.1))
    with faults.inject(faults.FaultPlan(device_stall_s=1e-3, stall_every=4,
                                        fold_stall_s=1e-3)):
        _submit_drain(fe, reqs)
    _assert_terminal_exactly_once(fe, reqs)
    assert fe.counters["completed"] == len(reqs)
    assert orc.check(reqs) == 0
    st = faults.injection_stats()
    assert st["stalls"] > 0 and st["fold_stalls"] > 0


def test_fault_retrain_failure_backs_off_and_serves():
    """The reference's workload with drift knobs that make the check
    trigger (threshold 0, so the first check past the cooldown starts an
    episode): the injected trainer raises, the manager counts the
    failure and backs off, no re-flow completes, and every read stays
    exact on the incumbent flow."""
    rng = np.random.default_rng(19)
    keys = np.unique(rng.lognormal(0, 2.0, 3000))[:1200]
    nfl = _drift_nfl(keys, DriftConfig(
        reflow=True, threshold=0.0, min_tail=0, check_every=64,
        window_keys=1024, cooldown_keys=512, train_epochs=1,
        train_batch=128, steps_per_tick=8, seed=0))
    oracle = dict(zip(keys.tolist(), range(keys.shape[0])))
    centers = np.quantile(keys, np.linspace(0.9, 0.999, 8))
    drift = np.unique(np.concatenate(
        [c * (1 + rng.uniform(0, 1e-4, 120)) for c in centers]))
    drift = drift[~np.isin(drift, keys)]
    orc = _Oracle(oracle)
    fe = FrontEnd(nfl, FrontEndConfig(max_batch=32, batch_timeout_s=5e-4))
    fe.on_batch_dispatched = orc.hook
    reqs, si, pool = [], 0, list(keys)
    for rid in range(300):
        if rng.random() < 0.55 and si < drift.shape[0]:
            r = ServiceRequest(rid, "insert", float(drift[si]),
                               payload=3_000_000 + si, deadline_s=_SLACK)
            pool.append(float(drift[si]))
            si += 1
        else:
            r = ServiceRequest(rid, "point", float(rng.choice(pool)),
                               deadline_s=_SLACK)
        reqs.append(r)
    factory = nfl._reflow.train_factory
    with faults.inject(faults.FaultPlan(retrain_failure=True), nfl=nfl):
        _submit_drain(fe, reqs)
    assert nfl._reflow.train_factory == factory      # seam restored
    _assert_terminal_exactly_once(fe, reqs)
    assert orc.check(reqs) == 0
    st = nfl.dispatch_stats()["drift"]
    assert st["triggers"] >= 1, "the drift check never triggered"
    assert st["retrain_failures"] >= 1
    assert st["reflows_completed"] == 0
    assert st["state"] == "idle"


def _reshard_nfl(seed):
    return _build_nfl(
        n=1500, seed=seed, shards=4,
        flat_index=FlatAFLIConfig(rebuild_frac=0.1, delta_cap=24,
                                  fold_step_keys=48, fold_work_factor=4.0),
        reshard=ReshardConfig(enabled=True, hot_frac=1.8, min_load=128.0,
                              min_keys=256, check_every=256,
                              cooldown_keys=512, load_window_keys=1024))


@pytest.mark.parametrize("mode", ["contention", "snapshot", "fold"])
def test_fault_reshard_failure_backs_off_and_serves(mode):
    """A poisoned §18 migration — swap-window contention, a snapshot that
    raises mid-freeze, or a candidate fold that dies in flight — leaves
    boundaries and serving untouched, counts a monotone failure and
    doubles the cooldown; after the fault clears, an explicit episode
    migrates."""
    nfl, keys, oracle = _reshard_nfl(seed=21)
    idx = nfl.index
    b0 = idx.boundaries.copy()
    span0 = nfl._reshard._cooldown_span
    hot = keys[keys.astype(np.float32) < b0[0]]
    rng = np.random.default_rng(22)
    orc = _Oracle(oracle)
    fe = FrontEnd(nfl, FrontEndConfig(max_batch=32, batch_timeout_s=5e-4,
                                      admission=False, expire_queued=False))
    fe.on_batch_dispatched = orc.hook
    reqs = [ServiceRequest(rid, "point",
                           float(rng.choice(hot if rng.random() < 0.8
                                            else keys)),
                           deadline_s=_SLACK)
            for rid in range(700)]
    with faults.inject(faults.FaultPlan(fail_reshard=mode), nfl=nfl):
        _submit_drain(fe, reqs)
    _assert_terminal_exactly_once(fe, reqs)
    assert fe.counters["completed"] == len(reqs)
    assert orc.check(reqs) == 0, f"{mode}: served wrong results"
    st = nfl.dispatch_stats()["reshard"]
    assert st["migrations_failed"] >= 1, f"{mode}: fault never fired"
    assert st["migrations_completed"] == 0
    assert st["resharding_episodes"] == st["migrations_failed"]
    assert st["cooldown_span"] >= 2 * span0, f"{mode}: no backoff"
    assert st["state"] == "idle"
    assert np.array_equal(idx.boundaries, b0)
    assert idx.n_reshards == 0
    assert not any(s._tier_hold for s in idx.shards)
    again = nfl.dispatch_stats(reset=True)["reshard"]
    assert again["migrations_failed"] == st["migrations_failed"]
    assert again["resharding_episodes"] == st["resharding_episodes"]
    assert idx._reshard_fault is None
    swapped = []
    assert idx.start_reshard(0, 1, on_swap=lambda: swapped.append(1))
    idx.rebuild()
    assert swapped == [1] and idx.n_reshards == 1
    live = np.array(sorted(orc.d))
    res = nfl.lookup_batch(live)
    exp = np.array([orc.d[k] for k in live.tolist()])
    assert int((res != exp).sum()) == 0


def test_reshard_fault_plan_validates():
    nfl, _, _ = _build_nfl(n=200, seed=23)   # single-shard: no §18
    with pytest.raises(ValueError, match="sharded"):
        with faults.inject(faults.FaultPlan(fail_reshard="fold"), nfl=nfl):
            pass
    nfl2, _, _ = _reshard_nfl(seed=24)
    with pytest.raises(ValueError, match="unknown fail_reshard"):
        with faults.inject(faults.FaultPlan(fail_reshard="typo"), nfl=nfl2):
            pass
    # both rejections left nothing installed
    assert nfl2.index._reshard_fault is None
    assert "start_reshard" not in vars(nfl2.index)
    assert ops._FAULT_PLAN["error_every"] == 0
    nfl2.lookup_batch(np.array([1.0]))


def test_retrain_failure_plan_requires_reflow_nfl():
    nfl, _, _ = _build_nfl(n=200, seed=20,
                           drift=DriftConfig(enabled=False))
    with pytest.raises(ValueError):
        with faults.inject(faults.FaultPlan(retrain_failure=True,
                                            dispatch_error_every=1),
                           nfl=nfl):
            pass
    # and nothing was installed: no injected fault fires
    seen = ops.fault_injection_stats()["transient_errors"]
    nfl.lookup_batch(np.array([1.0]))
    assert ops.fault_injection_stats()["transient_errors"] == seen


def test_invalid_reshard_mode_leaves_the_trainer_seam_alone():
    """A plan with a valid retrain failure and an invalid reshard mode
    raises before either seam is touched."""
    rng = np.random.default_rng(25)
    keys = np.unique(rng.lognormal(0, 2.0, 1200))[:400]
    nfl = _drift_nfl(keys, DriftConfig(reflow=True))
    factory = nfl._reflow.train_factory
    with pytest.raises(ValueError, match="sharded"):
        with faults.inject(faults.FaultPlan(retrain_failure=True,
                                            fail_reshard="fold"), nfl=nfl):
            pass
    assert nfl._reflow.train_factory == factory


# ----------------------------------------------- concurrent telemetry reset
def test_dispatch_stats_reset_is_atomic_under_concurrency():
    """Snapshot-and-reset racing live dispatches never loses counts: the
    per-window snapshots plus the final residue sum to exactly the
    dispatches issued (the shims' dispatch counters, on the CPU)."""
    nfl, keys, _ = _build_nfl(n=600, seed=21)
    q = keys[:64]
    nfl.lookup_batch(q)
    nfl.dispatch_stats(reset=True)

    n_calls = 150
    snapshots = []
    stop = threading.Event()

    def reader():
        while not stop.is_set():
            snapshots.append(
                nfl.dispatch_stats(reset=True)["dispatch"]
                ["dispatch_count"])
            time.sleep(1e-4)

    t = threading.Thread(target=reader)
    t.start()
    try:
        for _ in range(n_calls):
            nfl.lookup_batch(q)
    finally:
        stop.set()
        t.join(timeout=60)
    assert not t.is_alive()
    residue = nfl.dispatch_stats()["dispatch"]["dispatch_count"]
    assert sum(snapshots) + residue == n_calls


def test_launch_counters_lose_nothing_under_a_resetting_reader():
    """The launch counters' bump (``counters.launched``) against
    ``ops.launch_counts(reset=True)`` from another thread: more writer
    threads than cores, alternating two kernels, count 5,000 launches
    each with a batch size, under a shortened switch interval, while a
    reader snapshots and resets without pause; the snapshots plus the
    residue equal the launches, per kernel and in the per-size counts."""
    ops.reset_launch_counts()
    n, writers = 5_000, 2 * ((os.cpu_count() or 2) + 1)
    snaps, sizes = [], []
    stop = threading.Event()

    def writer(fn):
        for i in range(n):
            counters.launched(fn, 1 + i % 3)

    def reader():
        while not stop.is_set():
            with counters.LOCK:
                sizes.append(ops.fused_lookup_launch_sizes())
                snaps.append(ops.launch_counts(reset=True))

    threads = [threading.Thread(target=writer, args=(fn,))
               for fn in (t_fl.fused_lookup, t_nf.nf_forward) * (writers // 2)]
    r = threading.Thread(target=reader)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        r.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        stop.set()
        r.join(timeout=60)
    finally:
        stop.set()
        sys.setswitchinterval(interval)
    assert not r.is_alive() and not any(t.is_alive() for t in threads)
    snaps.append(ops.launch_counts(reset=True))
    sizes.append(ops.fused_lookup_launch_sizes())
    assert len(snaps) > 2
    for name in ("fused_lookup", "nf_forward"):
        assert sum(s[name] for s in snaps) == n * writers // 2, name
    assert sum(sum(s.values()) for s in sizes) == n * writers // 2
    assert ops.launch_counts() == dict.fromkeys(ops.launch_counts(), 0)


# ---------------------------------------------- ops counters and fault plan
def _flat_index(n=400, seed=30, **cfg):
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.uniform(0.0, 1e6, 3 * n))[:n]
    idx = FlatAFLI(FlatAFLIConfig(**cfg), device="cpu")
    idx.build(keys, np.arange(keys.shape[0], dtype=np.int64))
    return idx, keys


def test_dispatch_counters_count_every_route_on_the_cpu():
    idx, keys = _flat_index()
    ops.reset_fused_lookup_stats()
    idx.lookup_batch(keys[:32])
    d = ops.fused_lookup_stats()
    assert (d["dispatch_count"], d["fused_count"], d["streamed_count"],
            d["tier_kernel_count"]) == (1, 1, 0, 0)
    idx.insert_batch(np.array([2e6, 3e6]), np.array([7, 8]))
    idx.lookup_batch(keys[:32])
    assert ops.fused_lookup_stats()["tier_kernel_count"] == 1
    idx.cfg = dataclasses.replace(idx.cfg, pool_budget=0)
    assert np.array_equal(idx.lookup_batch(np.array([2e6, keys[0]])),
                          [7, 0])
    d = ops.fused_lookup_stats()
    assert (d["dispatch_count"], d["fused_count"], d["streamed_count"],
            d["tier_kernel_count"]) == (3, 2, 1, 2)
    pv, cnt, tot = idx.scan_batch(keys[:4], keys[1:5], cap=1)
    d = ops.fused_lookup_stats(reset=True)
    assert (d["scan_dispatch_count"], d["scan_fused_count"]) == (1, 1)
    assert d["scan_trunc_count"] == int((tot > 1).sum())
    assert set(d) == {"dispatch_count", "fused_count", "streamed_count",
                      "tier_kernel_count", "scan_dispatch_count",
                      "scan_fused_count", "scan_trunc_count"}
    d = ops.fused_lookup_stats()
    assert all(v == 0 for v in d.values())


def test_forced_fallback_takes_the_plain_versions_and_names_the_cause():
    """No route forces a plain version: ``ops`` has no such knob, and
    ``inject`` refuses ``force_oracle`` with its cause named, before it
    arms any seam (here ``fail_reshard``'s, on a sharded index).  The
    reads and scans after it take the kernels' rungs, counted as such."""
    nfl, keys, _oracle = _build_nfl(n=800, seed=31, shards=2)
    with pytest.raises(KeyError, match="unknown fault knob"):
        ops.set_fault_plan(force_fallback=True)
    with pytest.raises(ValueError, match="no oracle rung"):
        with faults.inject(faults.FaultPlan(force_oracle=True,
                                            fail_reshard="fold"), nfl=nfl):
            pass
    assert nfl.index._reshard_fault is None
    want = nfl.lookup_batch(keys[:64])
    ops.reset_fused_lookup_stats()
    got = nfl.lookup_batch(keys[:64])
    nfl.scan_batch(keys[:8], keys[8:16])
    assert np.array_equal(got, want)
    d = ops.fused_lookup_stats()
    assert d["dispatch_count"] == d["fused_count"] > 0
    assert d["scan_dispatch_count"] == d["scan_fused_count"] > 0
    assert "forced_fallbacks" not in ops.fault_injection_stats()


def test_unknown_fault_knob_raises():
    defaults = dict(ops._FAULT_PLAN)
    for knob in ("force_oracle", "force_fallback"):
        with pytest.raises(KeyError, match="unknown fault knob"):
            ops.set_fault_plan(**{knob: True})
    assert ops._FAULT_PLAN == defaults


def test_clear_fault_plan_resets_every_knob():
    defaults = dict(ops._FAULT_PLAN)
    ops.set_fault_plan(stall_s=1.0, stall_every=3, fold_stall_s=1.0,
                       error_every=2)
    assert ops._FAULT_PLAN != defaults
    ops.clear_fault_plan()
    assert ops._FAULT_PLAN == defaults
    ops.fault_injection_stats(reset=True)
    ops._fault_gate("point")
    ops.fault_stall("fold")
    st = ops.fault_injection_stats()
    assert st == {"dispatches_seen": 1, "stalls": 0, "fold_stalls": 0,
                  "transient_errors": 0}


def test_fault_gate_raises_before_it_stalls():
    """On a dispatch both knobs select, the gate raises at once and does
    not sleep; the next stalled one sleeps."""
    ops.fault_injection_stats(reset=True)
    ops.set_fault_plan(stall_s=0.2, stall_every=2, error_every=2)
    ops._fault_gate("point")                              # #1: neither
    t0 = time.perf_counter()
    with pytest.raises(ops.TransientDispatchError, match="#2"):
        ops._fault_gate("scan")                           # #2: both
    assert time.perf_counter() - t0 < 0.1
    st = ops.fault_injection_stats()
    assert (st["transient_errors"], st["stalls"]) == (1, 0)
    ops.set_fault_plan(error_every=0, stall_s=0.02)
    t0 = time.perf_counter()
    ops._fault_gate("point")                              # #3: no stall
    ops._fault_gate("point")                              # #4: stall
    assert time.perf_counter() - t0 >= 0.02
    st = ops.fault_injection_stats(reset=True)
    assert (st["dispatches_seen"], st["stalls"]) == (4, 1)
    assert ops.fault_injection_stats()["dispatches_seen"] == 0


def test_a_failed_dispatch_changes_no_state():
    """The gate raises before the shim uploads or launches anything: the
    dispatch counters, the launch counters and the index stay as they
    were."""
    idx, keys = _flat_index(seed=32)
    ops.reset_fused_lookup_stats()
    ops.set_fault_plan(error_every=1)
    with pytest.raises(ops.TransientDispatchError):
        idx.lookup_batch(keys[:8])
    with pytest.raises(ops.TransientDispatchError):
        idx.scan_batch(keys[:2], keys[2:4])
    ops.clear_fault_plan()
    d = ops.fused_lookup_stats()
    assert d["dispatch_count"] == d["scan_dispatch_count"] == 0
    assert np.array_equal(idx.lookup_batch(keys[:8]), np.arange(8))


# --------------------------------------------------- parity with the JAX
class _StepClock:
    """A clock that advances a fixed step on every read."""

    def __init__(self, step=1e-4):
        self.t, self.step = 0.0, step

    def __call__(self):
        self.t += self.step
        return self.t


@pytest.mark.parametrize("leg", ["fault-free", "errors"])
def test_frontend_matches_the_jax_frontend_on_a_step_clock(leg):
    """One flow-off index (the same keys in both packages, no fold: the
    packages pay fold work per call differently) and one request list
    through the JAX ``FrontEnd`` and the port's, each on its own step
    clock of 1e-4 s a read.  Every request gets the same terminal
    state, reason and result, and the loop's counters, reasons, service
    model and latencies are equal.  ``fault-free``: a mixed trace, a
    third of the deadlines tight enough to shed and expire; ``errors``:
    a point-only trace under ``dispatch_error_every=3``."""
    from repro.core.flat_afli import FlatAFLIConfig as JFlatAFLIConfig
    from repro.core.nfl import NFL as JNFL
    from repro.core.nfl import NFLConfig as JNFLConfig
    from repro.core.train_flow import FlowTrainConfig as JFlowTrainConfig
    from repro.serve import faults as jfaults
    from repro.serve import frontend as jfrontend

    rng = np.random.default_rng(40)
    keys = np.unique(rng.uniform(0.0, 1e6, 3000))[:1000]
    pay = np.arange(keys.shape[0], dtype=np.int64)
    port = NFL(NFLConfig(backend="flat", force_flow=False,
                         flow_train=FlowTrainConfig(epochs=1),
                         flat_index=FlatAFLIConfig(rebuild_frac=10.0)),
               device="cpu")
    port.bulkload(keys, pay)
    jax_nfl = JNFL(JNFLConfig(backend="flat", force_flow=False,
                              flow_train=JFlowTrainConfig(epochs=1),
                              flat_index=JFlatAFLIConfig(rebuild_frac=10.0)))
    jax_nfl.bulkload(keys, pay)
    spare = np.unique(rng.uniform(2e6, 3e6, 200))
    p = (0.7, 0.1, 0.15, 0.05) if leg == "fault-free" else (1.0, 0, 0, 0)
    tight = np.random.default_rng(41).random(240) < 0.33

    def requests(make):
        reqs = _mixed_requests(np.random.default_rng(42), 240, keys, spare,
                               _SLACK, p=p, make=make)
        if leg == "fault-free":
            for r, t in zip(reqs, tight):
                if t:
                    r.deadline_s = 2e-3
        return reqs

    cfg = dict(max_batch=16, batch_timeout_s=5e-4, retry_backoff_s=1e-5)
    plan = dict(dispatch_error_every=3 if leg == "errors" else 0)
    runs = {}
    for name, nfl, mod, fmod in (("jax", jax_nfl, jfrontend, jfaults),
                                 ("port", port, t_frontend, faults)):
        fe = mod.FrontEnd(nfl, mod.FrontEndConfig(**cfg), clock=_StepClock())
        reqs = requests(mod.ServiceRequest)
        fmod.injection_stats(reset=True)
        with fmod.inject(fmod.FaultPlan(**plan)):
            _submit_drain(fe, reqs)
        runs[name] = (fe, reqs, fmod.injection_stats())
    (jfe, jreqs, jst), (tfe, treqs, tst) = runs["jax"], runs["port"]
    for a, b in zip(jreqs, treqs):
        assert (a.rid, a.state, a.reason, a.t_submit, a.t_done) == \
            (b.rid, b.state, b.reason, b.t_submit, b.t_done)
        if a.op == "range" and a.result is not None:
            assert (list(a.result[0]), a.result[1]) == \
                (list(b.result[0]), b.result[1]), a.rid
        else:
            assert a.result == b.result, a.rid
    assert jfe.stats() == tfe.stats()
    assert jst["transient_errors"] == tst["transient_errors"]
    if leg == "errors":
        assert tfe.counters["retries"] > 0
        assert tfe.counters["completed"] + tfe.counters["expired"] + \
            tfe.counters["shed"] == len(treqs)
    else:
        assert tfe.counters["shed"] + tfe.counters["expired"] > 0
        assert {r.op for r in treqs} == {"point", "range", "insert",
                                         "delete"}
