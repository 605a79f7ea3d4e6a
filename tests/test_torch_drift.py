"""repro_torch drift telemetry and background re-flow (DESIGN.md §14) on
the CPU, against the JAX package and a dict oracle.

Mirrors ``tests/test_drift.py`` (all its test functions, the sharded
re-flow among them) on the port, and holds the port to the JAX package
on shared numpy inputs:

- ``DriftMonitor``: reservoir, ``sample()`` and ``should_check()`` equal
  after the same keys and seed;
- each scripted ``ReflowManager`` scenario runs through both managers
  with the same stub callbacks, state and every counter equal after
  every tick;
- ``FlatAFLI.start_reflow(np.log1p, ...)`` on the same keys and inserts
  in both packages: refused while active, driven to the swap by writes
  with every answer equal to the oracle, and the tree pools bit-equal
  after ``rebuild()``.  The shadow counts are reported, not compared
  (the JAX verify runs through XLA, which rounds the slot arithmetic
  differently on rint boundaries);
- ``ShardedFlatAFLI.start_reflow(np.log1p, ...)`` on the same sharded
  keys and writes in both packages: the re-derived boundaries and every
  candidate shard's pools bit-equal at the swap, every answer the
  oracle's;
- the flow-on ``NFL`` legs check each package against the dict oracle:
  the two packages' trainers start from different initial weights, so
  their episodes are not held to each other.

Every comparison is exact.
"""

import jax  # noqa: F401  (JAX on the CPU beside torch in one process)
import numpy as np
import pytest
import torch

import repro.core.drift as jdrift
from repro.core import flat_afli as jfa
from repro.core import nfl as j_nfl
from repro.core.flow import FlowConfig as JFlowConfig
from repro.core.sharded_nfl import ShardedFlatAFLI as JSharded
from repro.core.train_flow import FlowTrainConfig as JTrainConfig

import repro_torch.core.drift as tdrift
from repro_torch.core import flat_afli as tfa
from repro_torch.core.drift import DriftConfig, DriftMonitor
from repro_torch.core.flat_afli import FlatAFLI, FlatAFLIConfig
from repro_torch.core.flow import FlowConfig
from repro_torch.core.nfl import NFL, NFLConfig
from repro_torch.core.sharded_nfl import ShardedFlatAFLI
from repro_torch.core.train_flow import FlowTrainConfig

torch.set_num_threads(1)


# ------------------------------------------------------------- DriftMonitor
def test_monitor_fill_then_decay():
    cfg = DriftConfig(sample_size=128, window_keys=256, seed=0)
    mon = DriftMonitor(cfg)
    old = -np.arange(1.0, 500.0)
    mon.seed(old)
    assert mon.keys_observed == 0  # seeding is not insert traffic
    assert (mon.sample() < 0).all() and mon.sample().shape == (128,)
    new = np.arange(1.0, 1.0 + 8 * 256)
    for i in range(0, new.shape[0], 64):
        mon.observe(new[i:i + 64])
    assert mon.keys_observed == new.shape[0]
    assert (mon.sample() > 0).mean() > 0.9, "reservoir kept old keys"


def test_monitor_fill_before_decay():
    cfg = DriftConfig(sample_size=16, window_keys=64, seed=1)
    mon = DriftMonitor(cfg)
    mon.observe(np.arange(10.0))
    assert np.array_equal(mon.sample(), np.arange(10.0))
    mon.observe(np.arange(10.0, 20.0))  # fills to 16, the rest decays
    assert mon.sample().shape == (16,)
    assert np.isin(mon.sample(), np.arange(20.0)).all()


def test_monitor_check_cadence():
    cfg = DriftConfig(check_every=100, seed=2)
    mon = DriftMonitor(cfg)
    assert not mon.should_check()  # an empty reservoir never checks
    mon.observe(np.arange(50.0))
    assert not mon.should_check()
    mon.observe(np.arange(50.0))
    assert mon.should_check()
    assert not mon.should_check()  # cadence, not a level trigger
    mon.observe(np.arange(100.0))
    assert mon.should_check()


@pytest.mark.parametrize("seed", [0, 3])
def test_monitor_matches_jax(seed):
    """The same seed, bulk keys and insert batches: both reservoirs, their
    samples and the check cadence equal after every batch."""
    rng = np.random.default_rng(seed)
    base = rng.lognormal(0, 2, 700) * 1e6
    batches = [rng.uniform(0, 1e9, int(n))
               for n in rng.integers(1, 300, 24)]
    kw = dict(sample_size=64, window_keys=256, check_every=100, seed=seed)
    mons = [mod.DriftMonitor(mod.DriftConfig(**kw))
            for mod in (jdrift, tdrift)]
    for m in mons:
        m.seed(base)
    for b in batches:
        out = []
        for m in mons:
            m.observe(b)
            out.append((m.sample(), m.should_check(), m.keys_observed,
                        m._fill, m._res.copy()))
        (js, jc, jn, jf, jr), (ts, tc, tn, tf, tr) = out
        assert np.array_equal(js, ts) and np.array_equal(jr, tr)
        assert (jc, jn, jf) == (tc, tn, tf)


# ------------------------------------------------------------ ReflowManager
class _StubTrainer:
    """FlowTrainer-shaped stub: done after ``steps`` calls, raising at
    call ``fail_at`` if set."""

    def __init__(self, steps=3, fail_at=None):
        self.n = 0
        self.steps = steps
        self.fail_at = fail_at

    def step(self):
        if self.fail_at is not None and self.n >= self.fail_at:
            raise RuntimeError("injected trainer fault")
        self.n += 1
        return self.n >= self.steps


def _snap(mgr):
    """The manager's state and every counter (public and private)."""
    return dict(mgr.stats(), cooldown_span=mgr._cooldown_span,
                episode_attempts=mgr._episode_attempts,
                applied=mgr._applied, pending=mgr._pending,
                pending_identity=mgr._pending_identity,
                exclusion=mgr.exclusion.owner)


def _armed(mod, trace, *, serving_tail=100, evaluate=None, apply=None,
           trainer=None, **cfg_kw):
    """A manager of ``mod`` whose monitor holds 64 equal keys (so the
    identity tail is exactly 64) and is armed to check on the next tick.
    Its ``tick`` appends a snapshot to ``trace`` after every call."""
    kw = dict(reflow=True, threshold=2.0, min_tail=4, check_every=64,
              sample_size=64, window_keys=256, cooldown_keys=100,
              max_attempts=2, steps_per_tick=1, seed=3)
    kw.update(cfg_kw)
    cfg = mod.DriftConfig(**kw)
    mon = mod.DriftMonitor(cfg)
    mon.observe(np.full(64, 7.0))
    calls = {"apply": 0}

    def _apply(cand, use_flow, tail):
        calls["apply"] += 1
        return True if apply is None else apply(cand, use_flow, tail)

    mgr = mod.ReflowManager(
        cfg, mon,
        serving_tail=lambda s: serving_tail,
        train_factory=lambda s, a: trainer or _StubTrainer(steps=1),
        evaluate=evaluate or (lambda t, s: (5, "cand")),
        apply=_apply)
    real_tick = mgr.tick

    def tick():
        try:
            real_tick()
        finally:
            if not mgr._in_tick:
                trace.append(_snap(mgr))

    mgr.tick = tick
    return mgr, mon, calls


def _scn_accept(mod, trace):
    mgr, mon, calls = _armed(mod, trace, serving_tail=100,
                             evaluate=lambda t, s: (5, "cand"))
    mgr.tick()  # check -> trigger -> TRAINING
    assert mgr.state == mod.ReflowManager.TRAINING
    assert mgr.triggers == 1 and mgr.last_score == 100.0
    mgr.tick()  # one step -> done -> validate -> accept -> apply
    assert mgr.state == mod.ReflowManager.PENDING
    assert mgr.reflows_started == 1 and calls["apply"] == 1
    mgr.tick()  # fold in flight: apply is not called again
    assert calls["apply"] == 1
    mgr.note_swap()
    trace.append(_snap(mgr))
    assert mgr.state == mod.ReflowManager.IDLE
    assert mgr.reflows_completed == 1 and mgr.identity_switches == 0
    assert mgr.baseline_tail == 5
    assert mgr.cooldown_until > mon.keys_observed - 1


def _scn_identity_tie(mod, trace):
    # candidate tail 99 against the identity's 64: the identity serves
    mgr, _, _ = _armed(mod, trace, serving_tail=100,
                       evaluate=lambda t, s: (99, "cand"))
    applied = {}
    mgr.apply = lambda c, use_flow, tail: applied.update(
        cand=c, use_flow=use_flow, tail=tail) or True
    mgr.tick()
    mgr.tick()
    assert applied == {"cand": None, "use_flow": False, "tail": 64}
    mgr.note_swap()
    trace.append(_snap(mgr))
    assert mgr.identity_switches == 1 and mgr.baseline_tail == 64


def _scn_margin_reject(mod, trace):
    # the identity (64) beats the candidate (99) but misses the 10%
    # margin against serving (65): rejected, serving untouched
    mgr, mon, calls = _armed(mod, trace, serving_tail=65,
                             evaluate=lambda t, s: (99, "cand"))
    mgr.tick()
    mgr.tick()
    assert mgr.state == mod.ReflowManager.IDLE
    assert mgr.candidates_rejected == 1 and calls["apply"] == 0
    assert mgr.reflows_started == 0
    assert mgr.cooldown_until == mon.keys_observed + 100


def _scn_retrain_backoff(mod, trace):
    mgr, mon, _ = _armed(mod, trace, serving_tail=100)

    def _raise(sample, attempt):
        raise RuntimeError("injected train fault")

    mgr.train_factory = _raise
    mgr.tick()
    assert mgr.retrain_failures == 1 and mgr.state == mod.ReflowManager.IDLE
    assert mgr.cooldown_until == mon.keys_observed + 100
    # the second consecutive failure hits max_attempts=2: the span doubles
    mon.observe(np.full(128, 7.0))
    mgr.tick()
    assert mgr.retrain_failures == 2
    assert mgr.cooldown_until == mon.keys_observed + 200
    # the span is capped at 64x the base cooldown
    for _ in range(20):
        mon.observe(np.full(mgr.cooldown_until - mon.keys_observed + 64,
                            7.0))
        mgr.tick()
    assert mgr.cooldown_until - mon.keys_observed <= 64 * 100
    assert mgr.reflows_started == 0


def _scn_trainer_fault(mod, trace):
    mgr, _, calls = _armed(mod, trace,
                           trainer=_StubTrainer(steps=3, fail_at=1))
    mgr.tick()  # -> TRAINING
    assert mgr.state == mod.ReflowManager.TRAINING
    mgr.tick()  # the first step is fine
    mgr.tick()  # the second raises
    assert mgr.state == mod.ReflowManager.IDLE
    assert mgr.retrain_failures == 1 and calls["apply"] == 0


def _scn_busy_apply(mod, trace):
    busy = {"n": 0}

    def _apply(cand, use_flow, tail):
        busy["n"] += 1
        return busy["n"] > 2  # a fold is in flight twice

    mgr, _, _ = _armed(mod, trace, apply=_apply)
    mgr.tick()
    mgr.tick()  # validate -> apply refused (1)
    assert mgr.state == mod.ReflowManager.PENDING
    assert mgr.reflows_started == 0
    mgr.tick()  # refused (2)
    mgr.tick()  # started (3)
    assert mgr.reflows_started == 1 and busy["n"] == 3


def _scn_reentrant(mod, trace):
    box = {}

    def _apply(cand, use_flow, tail):
        box["m"].stats()  # reading stats from a callable is legal
        box["m"].tick()   # driving the machine from one is not
        return True

    mgr, _, _ = _armed(mod, trace, apply=_apply)
    box["m"] = mgr
    mgr.tick()  # -> TRAINING
    with pytest.raises(mod.LockDisciplineError):
        mgr.tick()  # step -> validate -> apply -> re-entrant tick
    # a programming error, not a failed episode: no cooldown, no count
    assert mgr.retrain_failures == 0
    assert mgr.state == mod.ReflowManager.PENDING
    mgr.apply = lambda c, f, t: True
    mgr.tick()
    assert mgr.reflows_started == 1


def _scn_stats_mid_commit(mod, trace):
    mgr, _, _ = _armed(mod, trace)
    with pytest.raises(mod.LockDisciplineError):
        with mgr._commit():
            mgr.stats()
    trace.append(_snap(mgr))  # the window is closed: reads are legal
    with pytest.raises(mod.LockDisciplineError):
        with mgr._commit():
            with mgr._commit():  # a transition inside a transition
                pass
    trace.append(_snap(mgr))


def _scn_immediate_swap(mod, trace):
    box = {}

    def _apply(cand, use_flow, tail):
        box["m"].note_swap()  # an empty snapshot swaps inside apply()
        return True

    mgr, mon, _ = _armed(mod, trace, apply=_apply)
    box["m"] = mgr
    mgr.tick()
    mgr.tick()
    assert mgr.state == mod.ReflowManager.IDLE
    assert mgr.reflows_started == 1 and mgr.reflows_completed == 1
    # a second episode runs end to end: nothing waits on a swap that
    # already happened
    mon.observe(np.full(mgr.cooldown_until - mon.keys_observed + 64, 7.0))
    mgr.tick()
    assert mgr.state == mod.ReflowManager.TRAINING
    mgr.tick()
    assert mgr.reflows_started == 2 and mgr.reflows_completed == 2
    assert mgr.state == mod.ReflowManager.IDLE


_SCENARIOS = {
    "accept": _scn_accept, "identity_tie": _scn_identity_tie,
    "margin_reject": _scn_margin_reject,
    "retrain_backoff": _scn_retrain_backoff,
    "trainer_fault": _scn_trainer_fault, "busy_apply": _scn_busy_apply,
    "reentrant_tick": _scn_reentrant,
    "stats_mid_commit": _scn_stats_mid_commit,
    "immediate_swap": _scn_immediate_swap,
}


def test_manager_accepts_flow_candidate():
    _scn_accept(tdrift, [])


def test_manager_identity_wins_ties_and_worse_flows():
    _scn_identity_tie(tdrift, [])


def test_manager_margin_rejection():
    _scn_margin_reject(tdrift, [])


def test_manager_retrain_failure_backoff():
    _scn_retrain_backoff(tdrift, [])


def test_manager_trainer_fault_mid_training():
    _scn_trainer_fault(tdrift, [])


def test_manager_busy_apply_retries():
    _scn_busy_apply(tdrift, [])


def test_manager_reentrant_tick_trips():
    """An injected callable driving tick() recursively raises
    LockDisciplineError, which the degradation ladder does not swallow."""
    _scn_reentrant(tdrift, [])


def test_manager_stats_blocked_mid_commit():
    _scn_stats_mid_commit(tdrift, [])


def test_manager_immediate_swap_not_wedged():
    """apply() may swap synchronously (an empty snapshot's start_reflow
    calls on_swap before it returns); the episode must not stay marked
    in flight."""
    _scn_immediate_swap(tdrift, [])


@pytest.mark.parametrize("name", sorted(_SCENARIOS))
def test_manager_scenario_matches_jax(name):
    """Each scripted scenario through both managers: the state and every
    counter equal after every tick."""
    traces = []
    for mod in (jdrift, tdrift):
        trace = []
        _SCENARIOS[name](mod, trace)
        traces.append(trace)
    assert len(traces[0]) == len(traces[1]) > 0
    for i, (j, t) in enumerate(zip(*traces)):
        assert j == t, f"{name}: tick {i}"


# ----------------------------------------------------------- NFL end-to-end
def _drift_nfl(**drift_kw):
    kw = dict(reflow=True, threshold=1.5, min_tail=2, check_every=512,
              window_keys=2048, cooldown_keys=1024, train_epochs=1,
              steps_per_tick=8, seed=0)
    kw.update(drift_kw)
    return NFL(NFLConfig(
        backend="flat", force_flow=True, flow=FlowConfig(),
        flow_train=FlowTrainConfig(epochs=1),
        flat_index=FlatAFLIConfig(fold_step_keys=1024),
        drift=DriftConfig(**kw)), device="cpu")


def _jax_drift_nfl(**drift_kw):
    kw = dict(reflow=True, threshold=1.5, min_tail=2, check_every=512,
              window_keys=2048, cooldown_keys=1024, train_epochs=1,
              steps_per_tick=8, seed=0)
    kw.update(drift_kw)
    return j_nfl.NFL(j_nfl.NFLConfig(
        backend="flat", force_flow=True, flow=JFlowConfig(),
        flow_train=JTrainConfig(epochs=1),
        flat_index=jfa.FlatAFLIConfig(fold_step_keys=1024),
        drift=jdrift.DriftConfig(**kw)))


def _storm(nfl, oracle, batches, rng, probe_every=1):
    """Insert drifting batches, probing live keys after every
    ``probe_every``-th one (the write storm during the re-flow)."""
    for step, (k, v) in enumerate(batches):
        nfl.insert_batch(k, v)
        oracle.update(zip(k.tolist(), v.tolist()))
        if step % probe_every == 0:
            live = np.array(sorted(oracle))
            q = rng.choice(live, min(64, live.shape[0]), replace=False)
            exp = np.array([oracle[kk] for kk in q.tolist()])
            assert (nfl.lookup_batch(q) == exp).all(), \
                f"wrong answer mid-storm, step {step}"


def _drain(nfl, oracle, hi, max_ticks=400):
    """Single-key inserts until an episode in flight (and its fold) lands."""
    j = 0
    while j < max_ticks:
        st = nfl._reflow
        if (st.state == "idle"
                and st.reflows_started == st.reflows_completed):
            break
        k = np.asarray([hi * (1.7 + j * 1e-6)])
        v = np.asarray([900_000 + j], dtype=np.int64)
        nfl.insert_batch(k, v)
        oracle[float(k[0])] = int(v[0])
        j += 1
    return j


def _base_and_drift(seed=0, n_base=6000, n_drift=4000, batch=96):
    """Micro-clusters at high in-range quantiles of a lognormal base: the
    stale flow maps each into a few slots (bench_drift.py's workload)."""
    rng = np.random.default_rng(seed)
    base = np.unique(rng.lognormal(0, 2, n_base) * 1e6)
    pv = np.arange(base.shape[0], dtype=np.int64)
    hi = float(base.max())
    centers = np.quantile(base, np.linspace(0.80, 0.999, 16))
    drift = np.unique(np.concatenate(
        [c * (1 + rng.uniform(0, 1e-4, n_drift // 16)) for c in centers]))
    drift = drift[~np.isin(drift, base)]
    rng.shuffle(drift)
    batches = [(drift[i:i + batch],
                np.arange(drift[i:i + batch].shape[0], dtype=np.int64)
                + 100_000 + i)
               for i in range(0, drift.shape[0], batch)]
    return rng, base, pv, hi, batches


def _check_all(nfl, oracle):
    qk = np.array(sorted(oracle))
    qv = np.array([oracle[k] for k in qk.tolist()])
    assert int((nfl.lookup_batch(qk) != qv).sum()) == 0, \
        "wrong answers after the drift storm"


def test_nfl_reflow_off_score_still_visible():
    rng, base, pv, hi, batches = _base_and_drift(seed=1, n_base=4000,
                                                 n_drift=2500)
    nfl = _drift_nfl(reflow=False)
    nfl.bulkload(base, pv)
    oracle = dict(zip(base.tolist(), pv.tolist()))
    _storm(nfl, oracle, batches, rng, probe_every=4)
    d = nfl.dispatch_stats()["drift"]
    assert d["enabled"] and d["checks"] >= 1
    assert d["last_score"] >= 1.5, "the drift score did not surface"
    assert d["triggers"] == 0 and d["reflows_started"] == 0
    _check_all(nfl, oracle)


def test_nfl_reflow_end_to_end_under_write_storm():
    rng, base, pv, hi, batches = _base_and_drift(seed=0)
    nfl = _drift_nfl()
    nfl.bulkload(base, pv)
    oracle = dict(zip(base.tolist(), pv.tolist()))
    _storm(nfl, oracle, batches, rng)
    _drain(nfl, oracle, hi)
    d = nfl.dispatch_stats()["drift"]
    assert d["triggers"] >= 1 and d["reflows_completed"] >= 1
    assert d["reflows_started"] == d["reflows_completed"]
    assert d["state"] == "idle"
    assert d["signals"]["n_reflows"] >= 1
    assert not d["signals"]["reflow_active"]
    assert d["baseline_tail"] >= 1
    # the swap installed the AutoSwitch verdict over the re-keyed snapshot
    sw = d["signals"]["autoswitch"]
    assert sw["use_flow"] is not None and sw["tail_transformed"] >= 1
    assert nfl.index.last_fold["reflow"]
    _check_all(nfl, oracle)
    # deletes still route under the new transform
    dels = np.array(sorted(oracle))[::7][:100]
    assert nfl.delete_batch(dels).all()
    assert (nfl.lookup_batch(dels) == -1).all()


def test_nfl_reflow_each_package_against_oracle():
    """The same drifting storm through both packages' NFL: each answers
    every read as the oracle does and completes a re-flow.  The
    trainers start from different weights, so the two episodes are
    reported, not compared."""
    out = {}
    for name, make in (("jax", _jax_drift_nfl), ("torch", _drift_nfl)):
        rng, base, pv, hi, batches = _base_and_drift(seed=0)
        nfl = make()
        nfl.bulkload(base, pv)
        oracle = dict(zip(base.tolist(), pv.tolist()))
        _storm(nfl, oracle, batches, rng, probe_every=2)
        _drain(nfl, oracle, hi)
        _check_all(nfl, oracle)
        d = nfl.dispatch_stats()["drift"]
        assert d["reflows_completed"] >= 1, name
        out[name] = {k: d[k] for k in ("checks", "triggers",
                                       "reflows_completed", "baseline_tail")}
    print(f"episodes: {out}")


def test_nfl_forced_retrain_failure_never_stalls():
    rng, base, pv, hi, batches = _base_and_drift(seed=2, n_base=4000,
                                                 n_drift=2500)
    nfl = _drift_nfl(max_attempts=2, cooldown_keys=512)
    nfl.bulkload(base, pv)

    def _boom(sample, attempt):
        raise RuntimeError("injected retrain fault")

    nfl._reflow.train_factory = _boom
    oracle = dict(zip(base.tolist(), pv.tolist()))
    _storm(nfl, oracle, batches, rng, probe_every=4)
    d = nfl.dispatch_stats()["drift"]
    assert d["triggers"] >= 1 and d["retrain_failures"] >= 1
    assert d["reflows_started"] == 0 and d["state"] == "idle"
    assert d["cooldown_until"] > 0
    assert nfl.use_flow, "a failed retrain must leave serving untouched"
    _check_all(nfl, oracle)


def test_nfl_worse_candidate_rejected(monkeypatch):
    rng, base, pv, hi, batches = _base_and_drift(seed=3, n_base=4000,
                                                 n_drift=2500)
    nfl = _drift_nfl(max_attempts=2, cooldown_keys=512)
    nfl.bulkload(base, pv)
    # the candidate and the identity both far worse than serving
    nfl._reflow.evaluate = lambda trainer, sample: (10 ** 9, None)
    monkeypatch.setattr(tdrift, "dataset_tail_conflict",
                        lambda keys, gamma=0.99: 10 ** 9)
    oracle = dict(zip(base.tolist(), pv.tolist()))
    _storm(nfl, oracle, batches, rng, probe_every=4)
    d = nfl.dispatch_stats()["drift"]
    assert d["candidates_rejected"] >= 1
    assert d["reflows_started"] == 0 and d["retrain_failures"] == 0
    assert nfl.use_flow
    _check_all(nfl, oracle)


def test_nfl_flow_to_identity_switch():
    rng = np.random.default_rng(4)
    base = np.unique(rng.lognormal(0, 2, 4000) * 1e6)
    pv = np.arange(base.shape[0], dtype=np.int64)
    nfl = _drift_nfl()
    nfl.bulkload(base, pv)
    assert nfl.use_flow
    # the retrained flow loses, so the identity must win: the drifted
    # traffic is wide and uniform, where the stale flow's tail is huge
    nfl._reflow.evaluate = lambda trainer, sample: (10 ** 9, None)
    hi = float(base.max())
    drift = np.unique(rng.uniform(hi, 5 * hi, 4000))
    oracle = dict(zip(base.tolist(), pv.tolist()))
    batches = [(drift[i:i + 96],
                np.arange(drift[i:i + 96].shape[0], dtype=np.int64)
                + 100_000 + i)
               for i in range(0, drift.shape[0], 96)]
    _storm(nfl, oracle, batches, rng, probe_every=4)
    _drain(nfl, oracle, 4 * hi)
    d = nfl.dispatch_stats()["drift"]
    assert d["identity_switches"] >= 1, "the identity never won the switch"
    assert not nfl.use_flow
    assert d["signals"]["autoswitch"]["use_flow"] is False
    _check_all(nfl, oracle)


def test_nfl_sharded_reflow_end_to_end():
    rng, base, pv, hi, batches = _base_and_drift(seed=5, n_base=5000,
                                                 n_drift=3000)
    nfl = NFL(NFLConfig(
        backend="flat", shards=2, force_flow=True, flow=FlowConfig(),
        flow_train=FlowTrainConfig(epochs=1),
        flat_index=FlatAFLIConfig(fold_step_keys=1024),
        drift=DriftConfig(reflow=True, threshold=1.5, min_tail=2,
                          check_every=512, window_keys=2048,
                          cooldown_keys=1024, train_epochs=1,
                          steps_per_tick=8)), device="cpu")
    nfl.bulkload(base, pv)
    b_before = np.asarray(nfl.index.boundaries).copy()
    oracle = dict(zip(base.tolist(), pv.tolist()))
    _storm(nfl, oracle, batches, rng, probe_every=2)
    _drain(nfl, oracle, hi)
    d = nfl.dispatch_stats()["drift"]
    assert d["reflows_completed"] >= 1
    st = nfl.index.stats()
    assert st["n_reflows"] >= 1 and not st["reflow_active"]
    b_after = np.asarray(nfl.index.boundaries)
    assert b_after.shape == b_before.shape
    assert not np.array_equal(b_after, b_before), \
        "router boundaries were not re-derived at the swap"
    _check_all(nfl, oracle)
    # per-shard drift signals stay attributable after the swap, and the
    # fold-built candidates carry a fresh AutoSwitch verdict (a candidate
    # never runs build(), where the verdict lands otherwise)
    sig = d["signals"]
    assert len(sig["shards"]) == 2 and len(sig["autoswitch"]) == 2
    for sw in sig["autoswitch"]:
        assert sw["use_flow"] is not None
        assert sw["tail_original"] >= 1 and sw["tail_transformed"] >= 1


def test_sharded_start_reflow_matches_jax():
    """``ShardedFlatAFLI.start_reflow(np.log1p)`` on the same keys and
    writes in both packages: refused while in flight, the writes made
    during the episode held and re-keyed at the swap, every answer the
    oracle's before and after, and at the swap the re-derived boundaries
    (``boundaries_new``) and every candidate's pools, bucket tail,
    verdict and key count bit-equal."""
    rng = np.random.default_rng(31)
    keys = np.unique(rng.lognormal(0, 2, 4000) * 1e6)
    pv = np.arange(keys.shape[0], dtype=np.int64)
    cfg = dict(fold_step_keys=64, fold_work_factor=1.0)
    pt = ShardedFlatAFLI(FlatAFLIConfig(**cfg), n_shards=4, device="cpu")
    jx = JSharded(jfa.FlatAFLIConfig(**cfg), n_shards=4)
    oracle = dict(zip(keys.tolist(), pv.tolist()))
    new = np.unique(rng.lognormal(0, 2, 400) * 1e6)
    new = new[~np.isin(new, keys)]
    nv = np.arange(new.shape[0], dtype=np.int64) + 10 ** 6
    dels = rng.choice(keys, 100, replace=False)
    for side in (pt, jx):
        side.build(keys, pv)
        side.insert_batch(new[:300], nv[:300])
        assert side.delete_batch(dels).all()
    oracle.update(zip(new[:300].tolist(), nv[:300].tolist()))
    for k in dels.tolist():
        del oracle[k]
    swaps = {"jax": 0, "torch": 0}
    for name, side in (("jax", jx), ("torch", pt)):
        assert side.start_reflow(np.log1p, None,
                                 lambda n=name: swaps.__setitem__(
                                     n, swaps[n] + 1))
        assert not side.start_reflow(np.log1p, None, lambda: None)
        assert not side.start_reshard(0, 1, lambda: None)
    assert np.array_equal(pt._reflow.boundaries_new,
                          jx._reflow.boundaries_new)
    # writes during the episode carry the old positioning keys; the
    # calls are too small to finish a candidate in either package
    held = new[300:]
    for a in range(0, held.shape[0], 8):
        k, v = held[a:a + 8], nv[300 + a:300 + a + 8]
        for side in (jx, pt):
            side.insert_batch(k, v)
            assert side._reflow is not None, "a candidate finished early"
            got = side.lookup_batch(k)
            assert np.array_equal(got, v)
        oracle.update(zip(k.tolist(), v.tolist()))
    for side in (jx, pt):
        while side._reflow is not None:
            side._reflow_tick(1 << 50)
    assert swaps == {"jax": 1, "torch": 1}
    assert pt.n_reflows == jx.n_reflows == 1
    assert np.array_equal(pt.boundaries, jx.boundaries)
    live = np.array(sorted(oracle))
    want = np.array([oracle[k] for k in live.tolist()])
    z = np.log1p(live).astype(np.float32)
    for side in (pt, jx):
        assert np.array_equal(side.lookup_batch(z, ikeys=live), want)
        assert side.n_keys == live.shape[0]
    for t, j in zip(pt.shards, jx.shards):
        assert t.d_tail == j.d_tail and t.autoswitch == j.autoswitch
        assert t.n_keys == j.n_keys
        for field, x, y in zip(j.arrays._fields, j.arrays, t.arrays):
            x = np.asarray(x)
            assert x.dtype == y.dtype and np.array_equal(x, y), field
    print("shadowed at the sharded re-flow swap (port, jax):",
          [(t.n_shadowed, int(j._run_pk.shape[0]))
           for t, j in zip(pt.shards, jx.shards)])


# ----------------------------------------------- flat-index re-key (no NFL)
def _reflow_pair(seed, n):
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.lognormal(0, 2, n) * 1e6)
    pv = np.arange(keys.shape[0], dtype=np.int64)
    jx = jfa.FlatAFLI(jfa.FlatAFLIConfig(fold_step_keys=256))
    pt = FlatAFLI(FlatAFLIConfig(fold_step_keys=256), device="cpu")
    for idx in (jx, pt):
        idx.build(keys, pv)
    return rng, keys, jx, pt


def test_flat_start_reflow_refused_while_active():
    rng, keys, _jx, idx = _reflow_pair(6, 3000)
    assert idx.start_reflow(np.log1p, None, lambda: None)
    assert idx._fold is not None and idx._fold.reflow is not None
    assert idx.stats()["reflow_active"]
    # a second re-key, or any competing fold, is refused
    assert not idx.start_reflow(np.log1p, None, lambda: None)
    oracle = dict(zip(keys.tolist(), range(keys.shape[0])))
    fresh = 10 ** 6
    i = 0
    while idx._fold is not None and i < 200:
        k = np.unique(rng.lognormal(0, 2, 40) * 1e6)
        k = k[~np.isin(k, sorted(oracle))]
        idx.insert_batch(k, np.arange(fresh, fresh + k.shape[0]))
        oracle.update(zip(k.tolist(), range(fresh, fresh + k.shape[0])))
        fresh += k.shape[0]
        i += 1
    assert idx.n_reflows == 1
    live = np.array(sorted(oracle))
    got = idx.lookup_batch(np.log1p(live).astype(np.float32), ikeys=live)
    exp = np.array([oracle[k] for k in live.tolist()])
    assert (got == exp).all()


@pytest.mark.parametrize("seed", [6, 9])
def test_flat_start_reflow_matches_jax(seed):
    """``start_reflow(np.log1p)`` on the same keys and inserts in both
    packages: both refuse a second one while active, both answer every
    live key as the oracle does across the swap, the same verdict is
    installed, and after ``rebuild()`` the tree pools are bit-equal."""
    rng, keys, jx, pt = _reflow_pair(seed, 3000)
    swaps = {"jax": 0, "torch": 0}
    for name, idx in (("jax", jx), ("torch", pt)):
        assert idx.start_reflow(np.log1p, None,
                                lambda n=name: swaps.__setitem__(
                                    n, swaps[n] + 1))
        assert not idx.start_reflow(np.log1p, None, lambda: None)
    oracle = dict(zip(keys.tolist(), range(keys.shape[0])))
    fresh = 10 ** 6
    i = 0
    while (jx._fold is not None or pt._fold is not None) and i < 200:
        k = np.unique(rng.lognormal(0, 2, 40) * 1e6)
        k = k[~np.isin(k, sorted(oracle))]
        v = np.arange(fresh, fresh + k.shape[0])
        for idx in (jx, pt):
            idx.insert_batch(np.log1p(k) if idx.n_reflows else k, v,
                             ikeys=k)
        oracle.update(zip(k.tolist(), v.tolist()))
        fresh += k.shape[0]
        live = np.array(sorted(oracle))
        q = rng.choice(live, 64, replace=False)
        exp = np.array([oracle[x] for x in q.tolist()])
        for idx in (jx, pt):
            pk = np.log1p(q) if idx.n_reflows else q
            got = idx.lookup_batch(pk.astype(np.float32), ikeys=q)
            assert np.array_equal(got, exp), f"write {i}"
        i += 1
    assert jx.n_reflows == pt.n_reflows == 1
    assert swaps == {"jax": 1, "torch": 1}
    assert pt.autoswitch == jx.autoswitch
    live = np.array(sorted(oracle))
    exp = np.array([oracle[x] for x in live.tolist()])
    z = np.log1p(live).astype(np.float32)
    for idx in (jx, pt):
        assert np.array_equal(idx.lookup_batch(z, ikeys=live), exp)
    print(f"shadowed at the re-flow swap: jax {jx._run_pk.shape[0]}, "
          f"port {pt.n_shadowed}")
    for idx in (jx, pt):
        idx.rebuild()
    for field, x, y in zip(jx.arrays._fields, jx.arrays, pt.arrays):
        x = np.asarray(x)
        assert x.dtype == y.dtype and np.array_equal(x, y), field
    for idx in (jx, pt):
        assert np.array_equal(idx.lookup_batch(z, ikeys=live), exp)


def test_flat_start_reflow_empty_snapshot_rekeys_tiers():
    """An index with nothing live to fold (every key deleted) adopts the
    transform at once: the tiers are re-keyed in place, ``on_swap`` runs
    before ``start_reflow`` returns, and the tombstones keep masking."""
    keys = np.unique(np.random.default_rng(5).uniform(1, 1e6, 400))
    idx = FlatAFLI(FlatAFLIConfig(rebuild_frac=100.0), device="cpu")
    idx.build(keys, np.arange(keys.shape[0]))
    assert idx.delete_batch(keys).all()
    seen = []
    assert idx.start_reflow(np.log1p, None, lambda: seen.append(1))
    assert seen == [1] and idx.n_reflows == 1 and idx._fold is None
    run_pk = idx._run_pk
    assert np.array_equal(run_pk, np.sort(np.log1p(keys).astype(np.float32)))
    got = idx.lookup_batch(np.log1p(keys).astype(np.float32), ikeys=keys)
    assert (got == -1).all()


# ------------------------------------------------- resettable counters
def test_dispatch_stats_reset():
    rng = np.random.default_rng(7)
    keys = np.unique(rng.uniform(0, 1e6, 3000))
    pv = np.arange(keys.shape[0], dtype=np.int64)
    nfl = NFL(NFLConfig(backend="flat", force_flow=False,
                        flow_train=FlowTrainConfig(epochs=1)), device="cpu")
    nfl.bulkload(keys, pv)
    nfl.lookup_batch(keys[:256])
    nfl.insert_batch(keys[:8] + 0.5, pv[:8])
    nfl.scan_batch([keys[0]], [keys[100]])
    ds1 = nfl.dispatch_stats(reset=True)
    assert ds1["serving"]["tree_packs"] >= 1
    assert ds1["serving"]["scan_reuses"] >= 1
    assert ds1["serving"]["tier_uploads"] >= 1
    assert ds1["reshard"] == {"enabled": False}
    ds2 = nfl.dispatch_stats()
    # the counters are zeroed by the reset...
    for c in ("tree_packs", "scan_reuses", "tier_uploads", "tier_reuses",
              "scan_uploads", "router_builds"):
        assert ds2["serving"][c] == 0, c
    for c in ("nf_forward_launches", "fused_lookup_launches",
              "streamed_lookup_launches", "fused_range_scan_launches",
              "scan_truncated"):
        assert ds2[c] == 0, c
    # ...the gauges survive (they describe resident state)
    for g in ("run_capacity", "delta_capacity", "scan_capacity",
              "static_max_depth", "static_dense_window", "run_window"):
        assert ds2["serving"][g] == ds1["serving"][g]
    # the drift episode counters are state, not per-phase counts
    assert ds2["drift"]["enabled"] and not ds2["drift"]["use_flow"]
    assert ds2["drift"]["checks"] == ds1["drift"]["checks"]
    assert ds2["drift"]["keys_observed"] == 8
    # counting resumes from zero
    nfl.scan_batch([keys[0]], [keys[100]])
    assert nfl.dispatch_stats()["serving"]["scan_reuses"] == 1


def test_sharded_dispatch_stats_reset():
    rng = np.random.default_rng(8)
    keys = np.unique(rng.uniform(0, 1e6, 3000))
    pv = np.arange(keys.shape[0], dtype=np.int64)
    nfl = NFL(NFLConfig(backend="flat", shards=2, force_flow=False,
                        flow_train=FlowTrainConfig(epochs=1)), device="cpu")
    nfl.bulkload(keys, pv)
    nfl.lookup_batch(keys[:256])
    ds1 = nfl.dispatch_stats(reset=True)
    assert ds1["router"]["point_queries"] == 256
    assert ds1["drift"]["enabled"]
    assert len(ds1["drift"]["signals"]["shards"]) == 2
    ds2 = nfl.dispatch_stats()
    assert ds2["router"]["point_queries"] == 0
    assert ds2["router"]["per_shard_points"] == [0, 0]
    assert ds2["serving"]["tree_packs"] == 0
    for g in ("run_capacity", "static_max_depth"):
        assert ds2["serving"][g] == ds1["serving"][g]


def test_telemetry_matches_jax_after_the_same_writes():
    """The serving gauges the two packages share, and the drift signals,
    agree on the same flow-off writes: delta merges, no fold (the two
    packages schedule a fold's work per write call differently)."""
    rng = np.random.default_rng(12)
    keys = np.unique(rng.uniform(0, 1e6, 2000))
    pv = np.arange(keys.shape[0], dtype=np.int64)
    cfg = dict(delta_cap=64, rebuild_frac=10.0)
    jx = jfa.FlatAFLI(jfa.FlatAFLIConfig(**cfg))
    pt = tfa.FlatAFLI(tfa.FlatAFLIConfig(**cfg), device="cpu")
    for idx in (jx, pt):
        idx.build(keys, pv)
    for b in range(6):
        k = np.unique(rng.uniform(0, 1e6, 80))
        for idx in (jx, pt):
            idx.insert_batch(k, np.arange(k.shape[0]) + 10_000 * (b + 1))
    js, ts = jx.drift_signals(), pt.drift_signals()
    for key in ("max_depth", "delta_len", "run_len", "run_ratio",
                "fold_active", "reflow_active", "n_rebuilds", "n_reflows",
                "autoswitch"):
        assert js[key] == ts[key], key
    # the JAX windows are ratcheted to its traced shapes; the port's are
    # the tiers' exact longest runs of equal keys
    assert ts["run_window"] == pt._serving.run.window
    assert ts["delta_window"] == pt._serving.delta.window
    jt, tt = jx.serving_telemetry(), pt.serving_telemetry()
    assert jt["autoswitch"] == tt["autoswitch"]
    assert tt["serving"]["static_max_depth"] == pt.max_depth
