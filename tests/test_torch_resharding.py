"""repro_torch online boundary migration under skew (DESIGN.md §18) on the
CPU (plain kernels), after ``tests/test_resharding.py``, and held to the
JAX package.

Mirrors the 15 test functions of ``tests/test_resharding.py`` on
``device="cpu"``, each against a last-write-wins dict oracle with the
same squeezed tier bounds (``_TIGHT``), so a migration spans many serving
batches: interleaved point / range / insert / delete traffic while a
split and a merge are in flight (flow on and off), ranges straddling the
moving boundary (truncated ones included), the load-triggered path end
to end, the ``ReshardManager`` state machine, the exclusion token shared
with the re-flow, the abort rollbacks, and which telemetry survives a
reset.

Against the JAX package, on shared numpy inputs (every comparison
exact; integers, f32 keys and f64 gauges bit-equal):

- both ``ReshardManager``s driven tick by tick by the same scripted load
  snapshots and the same stub ``start_migration``: state, every counter,
  the window and the cooldown equal after every tick;
- one migration of the same sharded index in both packages after the
  same routed reads and writes, flow off (positioning keys are the keys)
  and flow on (positioning keys are one flow's z, computed once by the
  port's NF on the CPU, identities the raw keys; a flow-on shard is
  probed by the routed z, so that is the migration's whole input).  Each
  package is held to the oracle first, then to the other: the load
  gauges, the interior boundaries and every candidate's pools equal.
  Shadow counts are reported, not compared (ROADMAP's parity rules).
"""

import numpy as np
import pytest
import torch

import repro.core.drift as jdrift
from repro.core import flat_afli as jfa
from repro.core.sharded_nfl import ShardedFlatAFLI as JSharded

from repro_torch.core.drift import (ExclusionLock, LockDisciplineError,
                                    ReshardConfig, ReshardManager)
from repro_torch.core.flat_afli import FlatAFLIConfig
from repro_torch.core.flow import FlowConfig
from repro_torch.core.nfl import NFL, NFLConfig
from repro_torch.core.sharded_nfl import ShardedFlatAFLI
from repro_torch.core.train_flow import FlowTrainConfig, train_flow
from repro_torch.kernels import ops
from repro_torch.kernels.shard_dispatch import refresh_boundaries

torch.set_num_threads(1)

# squeezed tier + fold budgets so a migration spans many serving
# batches (in-flight interleavings) instead of swapping on its first
# tick
_TIGHT = FlatAFLIConfig(rebuild_frac=0.1, delta_cap=24, fold_step_keys=48,
                        fold_work_factor=4.0)


def _mk(shards, keys, pv, *, flow=False, reshard=None, epochs=1):
    nfl = NFL(NFLConfig(backend="flat", shards=shards, force_flow=flow,
                        flat_index=_TIGHT,
                        flow_train=FlowTrainConfig(epochs=epochs),
                        reshard=reshard or ReshardConfig()), device="cpu")
    nfl.bulkload(keys, pv)
    return nfl


def _keyset(seed, n=4096, lo=0.0, hi=100.0):
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.uniform(lo, hi, n))
    return keys, np.arange(len(keys), dtype=np.int64)


def _check_all(nfl, oracle, step=""):
    live = np.array(sorted(oracle))
    res = nfl.lookup_batch(live)
    exp = np.array([oracle[k] for k in live.tolist()])
    wrong = int((res != exp).sum())
    assert wrong == 0, f"{step}: {wrong} wrong lookups"


def _range_check(nfl, oracle, lo, hi, cap, step=""):
    """Oracle-checked [lo, hi) range (flow off: key order is positioning
    order), including the gapless-prefix truncation contract."""
    pvs, cnt, tot = nfl.scan_batch([lo], [hi], cap=cap)
    live = np.array(sorted(oracle))
    lo32, hi32 = np.float32(lo), np.float32(hi)
    exp = [oracle[k] for k in live.tolist()
           if lo32 <= np.float32(k) < hi32]
    got = pvs[0, :cnt[0]].tolist()
    if tot[0] <= cap:
        assert got == exp, f"{step}: untruncated range mismatch"
    else:
        # truncated: an exact prefix of the global order, no gaps
        assert cnt[0] <= cap
        assert got == exp[:cnt[0]], f"{step}: truncated prefix has gaps"


# -------------------------------------------------- boundary splice unit
def test_refresh_boundaries_splices_values_only():
    b = np.array([10.0, 20.0, 30.0], np.float32)
    out = refresh_boundaries(b, np.array([12.0], np.float32), 0)
    assert out.tolist() == [12.0, 20.0, 30.0]
    assert out.shape == b.shape and out.dtype == np.float32
    # empty interior = untouched copy
    assert refresh_boundaries(b, np.empty(0, np.float32), 1).tolist() \
        == b.tolist()
    with pytest.raises(ValueError, match="monotonicity"):
        refresh_boundaries(b, np.array([25.0], np.float32), 0)
    with pytest.raises(ValueError, match="outside"):
        refresh_boundaries(b, np.array([40.0, 50.0], np.float32), 2)


# ------------------------------------------- in-flight migration oracle
@pytest.mark.parametrize("flow", [False, True])
def test_split_migration_interleaved(flow):
    """A hot shard 0 (an insert storm grew its key mass) splits while
    point / range / insert / delete traffic interleaves with the folds in
    flight; every answer equals the oracle's before, during and after
    the swap, and the split moves the hot boundary."""
    keys, pv = _keyset(0)
    nfl = _mk(4, keys, pv, flow=flow)
    idx = nfl.index
    oracle = dict(zip(keys.tolist(), pv.tolist()))
    rng = np.random.default_rng(1)
    b0 = idx.boundaries.copy()
    # storm below the first quartile of the keys (with the flow on the
    # routed shard is the z's, and the flow is monotone)
    hot_hi = float(np.quantile(keys, 0.25))
    storm = np.unique(rng.uniform(0.0, hot_hi, 3000))
    storm = storm[~np.isin(storm, keys)]
    sv = np.arange(len(storm), dtype=np.int64) + 10_000_000
    nfl.insert_batch(storm, sv)
    oracle.update(zip(storm.tolist(), sv.tolist()))
    idx.rebuild()

    swapped = []
    assert idx.start_reshard(0, 1, on_swap=lambda: swapped.append(1))
    assert idx.stats()["reshard_active"]
    steps_in_flight = 0
    fresh = 20_000_000
    live = np.array(sorted(oracle))
    for step in range(400):
        if idx._reshard is not None:
            steps_in_flight += 1
        op = rng.choice(["insert", "delete", "lookup", "range"],
                        p=[0.3, 0.15, 0.4, 0.15])
        if op == "insert":
            k = np.unique(rng.uniform(0, 100, 12))
            k = k[~np.isin(k, live)]
            if not k.shape[0]:
                continue
            v = np.arange(fresh, fresh + k.shape[0])
            fresh += k.shape[0]
            nfl.insert_batch(k, v)
            oracle.update(zip(k.tolist(), v.tolist()))
            live = np.array(sorted(oracle))
        elif op == "delete":
            k = rng.choice(live, 8, replace=False)
            assert nfl.delete_batch(k).all(), f"step {step}: live delete"
            for kk in k.tolist():
                del oracle[kk]
            live = np.array(sorted(oracle))
        elif op == "lookup":
            k = rng.choice(live, 16, replace=False)
            res = nfl.lookup_batch(np.concatenate([k, k + 0.12345]))
            exp = np.array([oracle[kk] for kk in k.tolist()])
            assert (res[:16] == exp).all(), f"step {step}: wrong lookup"
            assert (res[16:] == -1).all(), f"step {step}: ghost hit"
        elif not flow:
            i = int(rng.integers(0, len(live) - 50))
            _range_check(nfl, oracle, live[i], live[i + 49], 4096,
                         step=f"step {step}")
        if swapped:
            break
    assert swapped == [1], "migration never swapped"
    assert steps_in_flight >= 2, \
        "migration did not stay in flight across interleaved traffic"
    assert idx.n_reshards == 1 and idx.n_reshard_aborts == 0
    assert idx.boundaries.shape == b0.shape
    if not flow:
        # the storm tripled shard 0's mass: the split moved B[0] down
        assert float(idx.boundaries[0]) < float(b0[0])
    assert float(idx.boundaries[2]) == float(b0[2]), \
        "migration touched a boundary outside the window"
    _check_all(nfl, oracle, "post-swap")


def test_merge_migration_interleaved():
    """A cold shard (most of its keys deleted) merges into its hot
    neighbour's re-partition; traffic stays oracle-exact throughout and
    the cold slot absorbs domain from the hot one."""
    keys, pv = _keyset(2)
    nfl = _mk(4, keys, pv)
    idx = nfl.index
    oracle = dict(zip(keys.tolist(), pv.tolist()))
    rng = np.random.default_rng(3)
    b0 = idx.boundaries.copy()
    # empty out shard 1 (cold), leaving shard 0 fat
    in1 = keys[(keys.astype(np.float32) >= b0[0])
               & (keys.astype(np.float32) < b0[1])]
    dels = in1[:-20]
    assert nfl.delete_batch(dels).all()
    for k in dels.tolist():
        del oracle[k]
    idx.rebuild()
    # the mass delete counted as write load on the emptied slot; the
    # scenario is a shard that has gone cold since, so clear the gauges
    # and let key mass alone drive the re-partition
    idx._load_reads[:] = 0.0
    idx._load_writes[:] = 0.0

    swapped = []
    assert idx.start_reshard(0, 1, on_swap=lambda: swapped.append(1))
    live = np.array(sorted(oracle))
    for step in range(400):
        k = rng.choice(live, 16, replace=False)
        res = nfl.lookup_batch(k)
        exp = np.array([oracle[kk] for kk in k.tolist()])
        assert (res == exp).all(), f"step {step}: wrong mid-merge"
        if step % 3 == 0:
            i = int(rng.integers(0, len(live) - 50))
            _range_check(nfl, oracle, live[i], live[i + 49], 4096,
                         step=f"step {step}")
        if swapped:
            break
    assert swapped == [1]
    # the emptied slot now owns part of the fat shard's old domain
    assert float(idx.boundaries[0]) < float(b0[0])
    assert float(idx.boundaries[2]) == float(b0[2])
    _check_all(nfl, oracle, "post-merge")
    # the merged slots keep serving writes routed by the new boundaries
    k = np.unique(rng.uniform(0, float(b0[1]), 64))
    k = k[~np.isin(k, np.array(sorted(oracle)))]
    v = np.arange(len(k), dtype=np.int64) + 30_000_000
    nfl.insert_batch(k, v)
    oracle.update(zip(k.tolist(), v.tolist()))
    _check_all(nfl, oracle, "post-merge insert")


def test_straddling_range_across_moving_boundary():
    """A range straddling the boundary the migration is about to move
    answers as the oracle does (and keeps the gapless-prefix truncation
    contract) before, during and after the swap: one query, three
    boundary regimes."""
    keys, pv = _keyset(4)
    nfl = _mk(4, keys, pv)
    idx = nfl.index
    oracle = dict(zip(keys.tolist(), pv.tolist()))
    rng = np.random.default_rng(5)
    b0 = idx.boundaries.copy()
    hot_hi = float(np.quantile(keys, 0.25))
    storm = np.unique(rng.uniform(0.0, hot_hi, 2500))
    storm = storm[~np.isin(storm, keys)]
    sv = np.arange(len(storm), dtype=np.int64) + 10_000_000
    nfl.insert_batch(storm, sv)
    oracle.update(zip(storm.tolist(), sv.tolist()))
    idx.rebuild()
    # the query straddles B[0], the boundary the split will move
    qlo, qhi = float(b0[0]) - 5.0, float(b0[0]) + 5.0
    small_cap = 64   # force truncation: the prefix contract must hold
    _range_check(nfl, oracle, qlo, qhi, small_cap, "pre-migration")
    _range_check(nfl, oracle, qlo, qhi, 8192, "pre-migration full")

    swapped = []
    live = np.array(sorted(oracle))
    assert idx.start_reshard(0, 1, on_swap=lambda: swapped.append(1))
    for step in range(400):
        _range_check(nfl, oracle, qlo, qhi, small_cap,
                     f"in-flight {step}")
        _range_check(nfl, oracle, qlo, qhi, 8192,
                     f"in-flight full {step}")
        # scans never fund migration ticks (boundaries may not move
        # mid-query): interleaved point lookups drive the folds
        k = rng.choice(live, 32, replace=False)
        res = nfl.lookup_batch(k)
        exp = np.array([oracle[kk] for kk in k.tolist()])
        assert (res == exp).all(), f"step {step}: wrong mid-straddle"
        if swapped:
            break
    assert swapped == [1]
    assert float(idx.boundaries[0]) != float(b0[0]), \
        "the straddled boundary never moved"
    _range_check(nfl, oracle, qlo, qhi, small_cap, "post-swap")
    _range_check(nfl, oracle, qlo, qhi, 8192, "post-swap full")


# --------------------------------------------------- load-triggered path
def test_load_trigger_migrates_hot_shard():
    """End to end through NFL: skewed reads concentrate on shard 0, the
    decayed load gauges cross the hot threshold, the manager opens an
    episode, and the swap moves the hot boundary, while serving stays
    oracle-exact."""
    keys, pv = _keyset(6)
    nfl = _mk(4, keys, pv, reshard=ReshardConfig(
        enabled=True, hot_frac=1.8, min_load=128.0, min_keys=512,
        check_every=256, cooldown_keys=2048, load_window_keys=1024))
    idx = nfl.index
    oracle = dict(zip(keys.tolist(), pv.tolist()))
    rng = np.random.default_rng(7)
    b0 = idx.boundaries.copy()
    allk = np.array(sorted(oracle))
    hot = allk[allk.astype(np.float32) < b0[0]]
    for step in range(80):
        q = np.concatenate([rng.choice(hot, 48), rng.choice(allk, 16)])
        res = nfl.lookup_batch(q)
        exp = np.array([oracle[k] for k in q.tolist()])
        assert (res == exp).all(), f"step {step}: wrong under skew"
        if nfl._reshard.migrations_completed >= 1 \
                and idx._reshard is None:
            break
    st = nfl.dispatch_stats()["reshard"]
    assert st["enabled"] and st["migrations_completed"] >= 1
    assert st["resharding_episodes"] >= st["migrations_completed"]
    assert st["last_hot_shard"] == 0
    # the load-weighted split moved the hot boundary down: the read-hot
    # range now spreads across two slots
    assert float(idx.boundaries[0]) < float(b0[0])
    _check_all(nfl, oracle, "post-trigger")
    # per-shard load gauges ride dispatch_stats()["shards"]
    ds = nfl.dispatch_stats()
    for t in ds["shards"]:
        assert set(t["load"]) == {"reads", "writes"}
    assert sum(t["load"]["reads"] for t in ds["shards"]) > 0


def test_migrate_off_detects_but_never_moves():
    """``ReshardConfig(migrate=False)``: the hot-shard score is telemetry
    only; checks run, the hot shard is named, the boundaries never
    move."""
    keys, pv = _keyset(8)
    nfl = _mk(4, keys, pv, reshard=ReshardConfig(
        enabled=True, migrate=False, hot_frac=1.8, min_load=128.0,
        min_keys=512, check_every=256, load_window_keys=1024))
    idx = nfl.index
    b0 = idx.boundaries.copy()
    hot = keys[keys.astype(np.float32) < b0[0]]
    rng = np.random.default_rng(9)
    for _ in range(40):
        nfl.lookup_batch(np.concatenate([rng.choice(hot, 48),
                                         rng.choice(keys, 16)]))
    st = nfl.dispatch_stats()["reshard"]
    assert st["checks"] >= 1 and st["last_hot_shard"] == 0
    assert st["resharding_episodes"] == 0
    assert np.array_equal(idx.boundaries, b0)
    assert idx.n_reshards == 0


# ---------------------------------------------------- abort + exclusion
def test_fold_abort_rolls_back_and_next_attempt_succeeds():
    """A candidate fold that raises aborts the episode in place:
    boundaries and serving untouched, the window released, the abort
    counted; the next attempt, without the fault, migrates."""
    keys, pv = _keyset(10)
    nfl = _mk(4, keys, pv)
    idx = nfl.index
    oracle = dict(zip(keys.tolist(), pv.tolist()))
    b0 = idx.boundaries.copy()
    assert idx.start_reshard(0, 1, on_swap=lambda: None)
    idx._reshard_fault = "fold"
    nfl.lookup_batch(keys[:32])          # the tick hits the fault
    assert idx._reshard is None
    assert idx.n_reshard_aborts == 1 and idx.n_reshards == 0
    assert np.array_equal(idx.boundaries, b0)
    assert not any(s._tier_hold for s in idx.shards), \
        "abort left a window shard frozen"
    _check_all(nfl, oracle, "post-abort")
    idx._reshard_fault = None
    swapped = []
    assert idx.start_reshard(0, 1, on_swap=lambda: swapped.append(1))
    idx.rebuild()
    assert swapped == [1] and idx.n_reshards == 1
    _check_all(nfl, oracle, "post-retry")


def test_snapshot_abort_unfreezes_partial_window():
    keys, pv = _keyset(11)
    nfl = _mk(4, keys, pv)
    idx = nfl.index
    oracle = dict(zip(keys.tolist(), pv.tolist()))
    b0 = idx.boundaries.copy()
    idx._reshard_fault = "snapshot"
    with pytest.raises(RuntimeError, match="snapshot"):
        idx.start_reshard(0, 2, on_swap=lambda: None)
    assert idx._reshard is None and idx.n_reshard_aborts == 1
    assert np.array_equal(idx.boundaries, b0)
    assert not any(s._tier_hold for s in idx.shards)
    idx._reshard_fault = None
    _check_all(nfl, oracle, "post-snapshot-abort")
    # the partly frozen shard's data survived (the snapshot merges the
    # delta into the run tier): writes and folds still work
    rng = np.random.default_rng(12)
    k = np.unique(rng.uniform(0, 100, 200))
    k = k[~np.isin(k, keys)]
    v = np.arange(len(k), dtype=np.int64) + 40_000_000
    nfl.insert_batch(k, v)
    oracle.update(zip(k.tolist(), v.tolist()))
    idx.rebuild()
    _check_all(nfl, oracle, "post-abort fold")


def test_reshard_vs_reflow_exclusion():
    """The shared ExclusionLock serializes structural episodes: while a
    re-flow owns the token the trigger becomes a backed-off failure
    (boundaries untouched), and releasing it lets the next episode
    migrate."""
    keys, pv = _keyset(13)
    nfl = _mk(4, keys, pv, reshard=ReshardConfig(
        enabled=True, hot_frac=1.8, min_load=128.0, min_keys=512,
        check_every=256, cooldown_keys=512, load_window_keys=1024))
    idx = nfl.index
    b0 = idx.boundaries.copy()
    assert nfl._exclusion is nfl._reshard.exclusion
    assert nfl._exclusion is nfl._reflow.exclusion
    assert nfl._exclusion.acquire("reflow")   # a re-flow owns the swap
    hot = keys[keys.astype(np.float32) < b0[0]]
    rng = np.random.default_rng(14)
    span0 = nfl._reshard._cooldown_span
    while nfl._reshard.migrations_failed == 0:
        nfl.lookup_batch(np.concatenate([rng.choice(hot, 48),
                                         rng.choice(keys, 16)]))
    st = nfl._reshard.stats()
    assert st["migrations_failed"] >= 1 and st["state"] == "idle"
    assert st["cooldown_span"] >= 2 * span0, "contention did not back off"
    assert np.array_equal(idx.boundaries, b0)
    assert nfl._exclusion.owner == "reflow", \
        "a refused episode stole or dropped the re-flow's token"
    nfl._exclusion.release("reflow")
    while nfl._reshard.migrations_completed == 0:
        nfl.lookup_batch(np.concatenate([rng.choice(hot, 48),
                                         rng.choice(keys, 16)]))
    assert idx.n_reshards >= 1
    assert nfl._exclusion.owner is None, \
        "the completed migration kept the exclusion token"


def test_index_refuses_concurrent_structural_episodes():
    keys, pv = _keyset(15)
    nfl = _mk(2, keys, pv)
    idx = nfl.index
    assert idx.start_reshard(0, 1, on_swap=lambda: None)
    # a second migration and a re-flow are both refused while in flight
    assert not idx.start_reshard(0, 1, on_swap=lambda: None)
    assert not idx.start_reflow(lambda k: np.asarray(k, np.float64),
                                None, lambda: None)
    idx.rebuild()
    assert idx.n_reshards == 1


# ------------------------------------------------- manager state machine
def _snap(reads, writes, n_keys):
    return {"reads": list(reads), "writes": list(writes),
            "n_keys": list(n_keys)}


def test_manager_backoff_doubles_and_counters_stay_monotone():
    cfg = ReshardConfig(enabled=True, hot_frac=1.5, min_load=10.0,
                        min_keys=10, check_every=100, cooldown_keys=200,
                        max_backoff=8)
    mgr = ReshardManager(
        cfg, load_snapshot=lambda: _snap([100, 1, 1, 1], [0] * 4,
                                         [50, 50, 50, 50]),
        start_migration=lambda lo, hi: False)   # index always busy
    spans, fails = [], []
    for _ in range(6):
        mgr.observe(mgr.cooldown_until - mgr.keys_routed
                    + cfg.check_every)
        mgr.tick()
        spans.append(mgr._cooldown_span)
        fails.append(mgr.migrations_failed)
    assert fails == sorted(fails) and fails[-1] >= 4, \
        "failure counter must be monotone and climbing"
    assert spans[1] == 2 * spans[0] and spans[2] == 4 * spans[0]
    assert max(spans) <= cfg.max_backoff * cfg.cooldown_keys
    assert mgr.migrations_completed == 0
    assert mgr.resharding_episodes == mgr.migrations_failed


def test_manager_lock_discipline():
    calls = {"n": 0}

    def reentrant_snapshot():
        calls["n"] += 1
        mgr.tick()   # an injected callable must never drive the machine
        return _snap([1, 1], [0, 0], [10, 10])

    cfg = ReshardConfig(enabled=True, check_every=1)
    mgr = ReshardManager(cfg, load_snapshot=reentrant_snapshot,
                         start_migration=lambda lo, hi: True)
    mgr.observe(100)
    with pytest.raises(LockDisciplineError):
        mgr.tick()
    assert calls["n"] == 1


def test_manager_respects_gates():
    """Cold shards, tiny tables and in-cooldown windows never open an
    episode, even when one shard tops the load ranking."""
    started = []
    cfg = ReshardConfig(enabled=True, hot_frac=2.0, min_load=1000.0,
                        min_keys=10_000, check_every=10)
    mgr = ReshardManager(
        cfg, load_snapshot=lambda: _snap([30, 1, 1, 1], [0] * 4,
                                         [10, 10, 10, 10]),
        start_migration=lambda lo, hi: started.append((lo, hi)) or True)
    mgr.observe(100)
    mgr.tick()
    # the hot share qualifies, min_load and min_keys do not
    assert mgr.last_hot_shard == 0 and not started
    assert mgr.resharding_episodes == 0


def test_exclusion_lock_semantics():
    ex = ExclusionLock()
    assert ex.acquire("reflow")
    assert ex.acquire("reflow")          # re-entrant for the owner
    assert not ex.acquire("reshard")
    ex.release("reshard")                # non-owner release is a no-op
    assert ex.owner == "reflow"
    ex.release("reflow")
    assert ex.acquire("reshard")


# --------------------------------------------- telemetry reset semantics
def test_reshard_counters_and_load_gauges_survive_reset():
    keys, pv = _keyset(16)
    nfl = _mk(4, keys, pv, reshard=ReshardConfig(
        enabled=True, hot_frac=1.8, min_load=128.0, min_keys=512,
        check_every=256, cooldown_keys=2048, load_window_keys=1024))
    idx = nfl.index
    b0 = idx.boundaries.copy()
    hot = keys[keys.astype(np.float32) < b0[0]]
    rng = np.random.default_rng(17)
    while nfl._reshard.migrations_completed == 0:
        nfl.lookup_batch(np.concatenate([rng.choice(hot, 48),
                                         rng.choice(keys, 16)]))
    before = nfl.dispatch_stats(reset=True)
    after = nfl.dispatch_stats()
    # the episode counters are state: they survive the reset
    for k in ("checks", "resharding_episodes", "migrations_completed",
              "migrations_failed"):
        assert after["reshard"][k] == before["reshard"][k], k
    # so do the decayed load gauges (the trigger's memory), while the
    # router's fan-out counters reset
    assert sum(after["reshard"]["load"]["reads"]) > 0
    assert after["reshard"]["load"] == before["reshard"]["load"]
    assert after["router"]["point_queries"] == 0
    assert after["router"]["per_shard_points"] == [0] * 4


# ------------------------------------------------------ against the JAX side
# scripted manager scenarios: per tick (keys routed, load snapshot, what
# start_migration does, what the index reports after the tick)
_HOT = ([90.0, 5.0, 3.0, 2.0], [10.0, 0.0, 0.0, 0.0], [400, 300, 300, 300])
_EDGE = ([1.0, 2.0, 3.0, 120.0], [0.0, 0.0, 0.0, 4.0], [300] * 4)
_FLAT = ([25.0, 25.0, 25.0, 25.0], [0.0] * 4, [300] * 4)
_COLD = ([9.0, 1.0, 0.0, 0.0], [0.0] * 4, [300] * 4)
_SCENARIOS = {
    # a migration starts, stays in flight two ticks, swaps; the cooldown
    # holds the next check back, then a second episode swaps
    "swap": [(128, _HOT, "start", None), (128, _HOT, None, None),
             (128, _HOT, None, "swap"), (128, _HOT, "start", None),
             (512, _HOT, "start", None), (128, _HOT, None, "swap"),
             (128, _FLAT, "start", None)],
    # the index refuses every start: the cooldown doubles to its cap
    "busy": [(128, _HOT, "busy", None)] * 3
            + [(1024, _HOT, "busy", None)] * 6,
    # a start that raises, a fold abort reported later, a synchronous
    # swap (an empty window), and the hot edge shard's window
    "faults": [(128, _HOT, "raise", None), (2048, _EDGE, "start", None),
               (128, _EDGE, None, "abort"), (4096, _HOT, "sync_swap", None),
               (4096, _EDGE, "start", None), (128, _EDGE, None, "swap")],
    # gates: too little load, too few keys, no hot shard
    "gates": [(128, _COLD, "start", None),
              (128, (_HOT[0], _HOT[1], [10, 10, 10, 10]), "start", None),
              (128, _FLAT, "start", None), (128, _HOT, "start", None)],
    # a re-flow owns the exclusion token for the first ticks
    "contended": [(128, _HOT, "start", None)] * 2
                 + [(2048, _HOT, "release", None),
                    (2048, _HOT, "start", None), (128, _HOT, None, "swap")],
}


@pytest.mark.parametrize("migrate", [True, False])
@pytest.mark.parametrize("scenario", sorted(_SCENARIOS))
def test_manager_matches_jax_tick_by_tick(scenario, migrate):
    """Both packages' ``ReshardManager`` under the same scripted load
    snapshots and the same stub index: state, every counter, the window
    and the cooldown equal after every tick, and the exclusion token
    held alike."""
    cfg_kw = dict(enabled=True, migrate=migrate, hot_frac=2.0,
                  min_load=64.0, min_keys=1024, check_every=100,
                  cooldown_keys=256, neighbors=1, max_backoff=8)
    out = {}
    for name, mod in (("jax", jdrift), ("torch", None)):
        Cfg = jdrift.ReshardConfig if mod else ReshardConfig
        Mgr = jdrift.ReshardManager if mod else ReshardManager
        Lock = jdrift.ExclusionLock if mod else ExclusionLock
        lock = Lock()
        state = {"snap": _FLAT, "do": None, "starts": []}

        def start(lo, hi, state=state):
            state["starts"].append((lo, hi))
            do = state["do"]
            if do == "busy":
                return False
            if do == "raise":
                raise RuntimeError("injected freeze fault")
            if do == "sync_swap":
                mgr.note_swap()
            return True

        mgr = Mgr(Cfg(**cfg_kw),
                  load_snapshot=lambda state=state: _snap(*state["snap"]),
                  start_migration=start, exclusion=lock)
        if scenario == "contended":
            lock.acquire("reflow")
        rows = []
        for n, snap, do, after in _SCENARIOS[scenario]:
            state["snap"], state["do"] = snap, do
            if do == "release":
                lock.release("reflow")
            mgr.observe(n)
            mgr.tick()
            if after == "swap" and mgr.state == mgr.MIGRATING:
                mgr.note_swap()
            elif after == "abort" and mgr.state == mgr.MIGRATING:
                mgr.note_failure()
            rows.append((mgr.stats(), lock.owner))
        out[name] = (rows, state["starts"])
    assert out["torch"] == out["jax"]
    if migrate and scenario in ("swap", "faults"):
        assert out["torch"][0][-1][0]["migrations_completed"] >= 1


def _migration_pair(pk, ik, pv, new_pk, new_ik, new_pv):
    """One migration of ``[0, 1]`` in both packages after the same
    traffic: skewed reads, an insert storm into shard 0, deletes; then
    writes held while the window's folds are in flight (a fold budget
    too small to finish in those calls, in either package), then both
    driven to the swap.  Returns (port, jax, oracle, gauges before the
    freeze, interiors)."""
    cfg = dict(fold_step_keys=64, fold_work_factor=1.0)
    port = ShardedFlatAFLI(FlatAFLIConfig(**cfg), n_shards=4, device="cpu")
    jx = JSharded(jfa.FlatAFLIConfig(**cfg), n_shards=4)
    for side in (port, jx):
        side.build(pk, pv, ikeys=ik)
    assert np.array_equal(port.boundaries, jx.boundaries)
    oracle = dict(zip((pk if ik is None else ik).tolist(), pv.tolist()))
    ids = pk if ik is None else ik
    rng = np.random.default_rng(21)
    hot = np.flatnonzero(pk.astype(np.float32) < port.boundaries[0])
    for step in range(24):
        j = np.concatenate([rng.choice(hot, 48),
                            rng.integers(0, pk.shape[0], 16)])
        exp = pv[j]
        for side in (port, jx):
            got = side.lookup_batch(pk[j], None if ik is None else ik[j])
            assert np.array_equal(got, exp), f"read {step}"
    n_storm = new_pk.shape[0] - 40      # the last 40 land while held
    dels = rng.choice(pk.shape[0], 64, replace=False)
    for side in (port, jx):
        side.insert_batch(new_pk[:n_storm], new_pv[:n_storm],
                          ikeys=None if ik is None else new_ik[:n_storm])
        assert side.delete_batch(
            pk[dels], ikeys=None if ik is None else ik[dels]).all()
    oracle.update(zip(new_ik[:n_storm].tolist(), new_pv[:n_storm].tolist()))
    for k in ids[dels].tolist():
        del oracle[k]
    gauges = (port._load_reads.copy(), port._load_writes.copy())
    assert np.array_equal(port._load_reads, jx._load_reads)
    assert np.array_equal(port._load_writes, jx._load_writes)
    swaps = {"port": 0, "jax": 0}
    untouched = port.shards[2:]
    for name, side in (("port", port), ("jax", jx)):
        assert side.start_reshard(0, 1, on_swap=lambda n=name: swaps.
                                  __setitem__(n, swaps[n] + 1))
    interiors = (port._reshard.interior.copy(), jx._reshard.interior.copy())
    # writes held by the frozen window: small calls, folds stay in flight
    held = slice(n_storm, new_pk.shape[0])
    for a in range(held.start, held.stop, 8):
        b = min(a + 8, held.stop)
        for side in (port, jx):
            side.insert_batch(new_pk[a:b], new_pv[a:b],
                              ikeys=None if ik is None else new_ik[a:b])
            assert side._reshard is not None, "a fold finished early"
        oracle.update(zip(new_ik[a:b].tolist(), new_pv[a:b].tolist()))
    for side in (port, jx):
        while side._reshard is not None:
            side._reshard_tick(1 << 50)
    assert swaps == {"port": 1, "jax": 1}
    assert port.shards[2:] == untouched
    return port, jx, oracle, gauges, interiors


def _hold_pair(port, jx, oracle, pk_of):
    """Each package against the oracle, then against the other: the
    boundaries (B[1] and B[2] kept), each window candidate's pools, bucket
    tail, verdict and key count."""
    live = np.array(sorted(oracle))
    want = np.array([oracle[k] for k in live.tolist()])
    zl = pk_of(live)
    for side in (port, jx):
        assert np.array_equal(side.lookup_batch(zl, live), want)
        assert side.n_keys == live.shape[0]
    assert np.array_equal(port.boundaries, jx.boundaries)
    assert np.array_equal(port._load_reads, jx._load_reads)
    for t, j in zip(port.shards[:2], jx.shards[:2]):
        assert t.d_tail == j.d_tail and t.autoswitch == j.autoswitch
        assert t.n_keys == j.n_keys and t.max_depth == j.max_depth
        for field, x, y in zip(j.arrays._fields, j.arrays, t.arrays):
            x = np.asarray(x)
            assert x.dtype == y.dtype and np.array_equal(x, y), field
    print("shadowed at the swap (port, jax):",
          [(t.n_shadowed, int(j._run_pk.shape[0]))
           for t, j in zip(port.shards[:2], jx.shards[:2])])


def test_migration_matches_jax_flow_off():
    rng = np.random.default_rng(20)
    keys = np.unique(rng.uniform(0.0, 100.0, 3000))
    pv = np.arange(keys.shape[0], dtype=np.int64)
    new = np.unique(rng.uniform(0.0, float(np.quantile(keys, 0.25)), 800))
    new = rng.permutation(new[~np.isin(new, keys)])
    new_pv = np.arange(new.shape[0], dtype=np.int64) + 10 ** 6
    b0 = ShardedFlatAFLI(n_shards=4, device="cpu")
    b0.build(keys, pv)
    port, jx, oracle, gauges, (ti, ji) = _migration_pair(
        keys, None, pv, new, new, new_pv)
    assert gauges[0][0] > gauges[0][1]           # shard 0 is read-hot
    assert np.array_equal(ti, ji) and ti.shape == (1,)
    assert float(port.boundaries[0]) < float(b0.boundaries[0])
    assert np.array_equal(port.boundaries[1:], b0.boundaries[1:])
    _hold_pair(port, jx, oracle, lambda k: k)


def test_migration_matches_jax_flow_on():
    rng = np.random.default_rng(22)
    keys = np.unique(rng.lognormal(10.0, 2.0, 3000))
    pv = np.arange(keys.shape[0], dtype=np.int64)
    params, norm, _m = train_flow(keys, FlowConfig(),
                                  FlowTrainConfig(epochs=1), device="cpu")

    def z_of(k):
        return ops.nf_transform_keys(params, norm, k, FlowConfig(), "cpu")

    z = z_of(keys)
    new = np.unique(rng.lognormal(10.0, 2.0, 4000))
    new = new[~np.isin(new, keys)]
    zn = z_of(new)
    # the storm aims at shard 0's z range
    cut = np.sort(z.astype(np.float32))[keys.shape[0] // 4]
    new = rng.permutation(new[zn.astype(np.float32) < cut])[:800]
    new_pv = np.arange(new.shape[0], dtype=np.int64) + 10 ** 6
    port, jx, oracle, _g, (ti, ji) = _migration_pair(
        z, keys, pv, z_of(new), new, new_pv)
    assert np.array_equal(ti, ji)
    _hold_pair(port, jx, oracle, z_of)
