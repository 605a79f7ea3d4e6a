"""repro_torch write path against the JAX package and a dict oracle, on
the CPU (plain versions of the kernels).

The same random op trace (insert, re-insert, lookup, update, delete with
definite misses, explicit rebuild) runs on the JAX ``FlatAFLI`` and the
port's, with tier bounds squeezed so a short trace crosses delta merges
and fold boundaries.  At every step both must equal a last-write-wins
dict oracle and each other: lookups, ``ok`` masks and ``n_keys``.  All
comparisons are exact.  The folded tree is held to the JAX builder's
one-shot build of the same snapshot, bit for bit.  Inputs are made with
numpy and passed between the packages as numpy."""

import jax
import numpy as np
import pytest
import torch

import repro.core.nfl as j_nfl
from repro.core import flat_afli as jfa

import repro_torch.core.nfl as t_nfl
from repro_torch.core import flat_afli as tfa
from repro_torch.core.train_flow import FlowTrainConfig
from repro_torch.weights import params_from_numpy

torch.set_num_threads(1)

_TIGHT = dict(rebuild_frac=0.1, delta_cap=24, fold_step_keys=48,
              fold_work_factor=4.0)


class _Side:
    """One index under test, a FlatAFLI of either package or an NFL."""

    def __init__(self, idx):
        self.idx = idx
        self.flat = getattr(idx, "index", idx)

    def build(self, keys, pv):
        if self.flat is self.idx:
            self.idx.build(keys, pv)
        else:
            self.idx.bulkload(keys, pv)

    def update(self, keys, pv):
        if hasattr(self.idx, "update_batch"):
            return self.idx.update_batch(keys, pv)
        ok = self.flat.contains_batch(keys)
        self.idx.insert_batch(keys[ok], pv[ok])
        return ok


def _drive(sides, rng, key_pool, n_ops, payload_base):
    """Run one random op trace on every side in lockstep, checking each
    against the dict oracle (and so against each other) after every op.
    Returns the op counts."""
    oracle = {}
    n0 = len(key_pool) // 2
    for s in sides:
        s.build(key_pool[:n0], np.arange(n0, dtype=np.int64))
    oracle.update(zip(key_pool[:n0], range(n0)))
    seen = {}
    for step in range(n_ops):
        op = rng.choice(["insert", "reinsert", "lookup", "update", "delete",
                         "rebuild"], p=[0.26, 0.14, 0.3, 0.12, 0.13, 0.05])
        seen[op] = seen.get(op, 0) + 1
        if op == "rebuild":
            for s in sides:
                s.flat.rebuild()
            continue
        size = int(rng.integers(1, 24))
        live = np.array(sorted(oracle))
        if op in ("reinsert", "update", "delete"):
            k = rng.choice(live, min(size, len(live)), replace=False)
        else:
            k = rng.choice(key_pool, size, replace=False)
        if op in ("lookup", "update", "delete") and rng.random() < 0.4:
            k = np.concatenate([k, k + 0.123])       # definite misses
        if op == "delete" and rng.random() < 0.5:
            k = np.concatenate([k, k[:3]])           # repeats in one batch
        v = np.arange(len(k), dtype=np.int64) + (step + 1) * payload_base
        if op in ("insert", "reinsert"):
            for s in sides:
                s.idx.insert_batch(k, v)
            oracle.update(zip(k, v))
        elif op == "update":
            exp = np.array([x in oracle for x in k])
            for s in sides:
                assert np.array_equal(s.update(k, v), exp), f"step {step}"
            oracle.update((x, p) for x, p, o in zip(k, v, exp) if o)
        elif op == "delete":
            exp = np.zeros(len(k), bool)
            for i, x in enumerate(k):
                exp[i] = oracle.pop(x, None) is not None
            for s in sides:
                assert np.array_equal(s.idx.delete_batch(k), exp), \
                    f"step {step}"
        else:
            exp = np.array([oracle.get(x, -1) for x in k])
            for s in sides:
                got = s.idx.lookup_batch(k)
                assert np.array_equal(got, exp), (
                    f"step {step}: {type(s.flat).__module__} "
                    f"{int(np.sum(got != exp))} wrong")
        for s in sides:
            assert s.flat.n_keys == len(oracle), f"step {step}: n_keys"
    live = np.array(sorted(oracle))
    exp = np.array([oracle[x] for x in live])
    for s in sides:
        assert np.array_equal(s.idx.lookup_batch(live), exp)
        assert (s.idx.lookup_batch(live + 0.321) == -1).all()
        assert s.flat.contains_batch(live).all()
    return seen


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_interleaving_flat_matches_jax_and_oracle(seed):
    """FlatAFLI of both packages, flow off: tight tiers, many merges and
    folds (in-stream and explicit)."""
    rng = np.random.default_rng(seed)
    pool = np.unique(rng.uniform(0, 1e9, 400))
    pool = np.concatenate([pool, 1e15 + np.arange(24.0)])  # f32 collisions
    port = tfa.FlatAFLI(tfa.FlatAFLIConfig(**_TIGHT), device="cpu")
    sides = [_Side(jfa.FlatAFLI(jfa.FlatAFLIConfig(**_TIGHT))),
             _Side(port)]
    seen = _drive(sides, rng, pool, n_ops=16, payload_base=10_000)
    assert seen.get("insert", 0) + seen.get("reinsert", 0) > 0
    assert port.n_rebuilds > 0


def _shared_flow(keys, monkeypatch):
    """One flow trained by the JAX package, handed to both NFLs, so both
    position keys from the same packed weights."""
    params, norm, metrics = j_nfl.train_flow(
        keys, j_nfl.FlowConfig(),
        j_nfl.FlowTrainConfig(epochs=1))
    t_params = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    monkeypatch.setattr(j_nfl, "train_flow",
                        lambda *a, **k: (params, norm, metrics))
    monkeypatch.setattr(t_nfl, "train_flow",
                        lambda *a, **k: (t_params, norm, dict(metrics)))


@pytest.mark.parametrize("force_flow", [False, True])
def test_interleaving_nfl_matches_jax_and_oracle(force_flow, monkeypatch):
    """NFL(backend='flat') of both packages, flow forced off and on: the
    whole serving stack (NF positioning of writes, kernel NF + traversal
    + tier probe of reads) against the oracle at every step."""
    rng = np.random.default_rng(97 + int(force_flow))
    pool = np.unique(np.floor(rng.lognormal(0, 2, 600) * 1e9))
    _shared_flow(pool[:len(pool) // 2], monkeypatch)
    jx = j_nfl.NFL(j_nfl.NFLConfig(
        backend="flat", force_flow=force_flow,
        flat_index=jfa.FlatAFLIConfig(**_TIGHT)))
    pt = t_nfl.NFL(t_nfl.NFLConfig(
        backend="flat", force_flow=force_flow,
        flow_train=FlowTrainConfig(epochs=1),
        flat_index=tfa.FlatAFLIConfig(**_TIGHT)), device="cpu")
    _drive([_Side(jx), _Side(pt)], rng, pool, n_ops=14,
           payload_base=100_000)
    assert pt.use_flow == jx.use_flow == force_flow
    assert pt.dispatch_stats()["rebuilds"] == pt.index.n_rebuilds > 0


def _same_ops(indexes, rng, keys, n_ops=6):
    """Apply one write sequence (inserts, updates, deletes) to several
    FlatAFLIs of either package; no lookups."""
    for step in range(n_ops):
        k = rng.choice(keys, 30, replace=False) + (step % 2) * 0.5
        v = np.arange(30, dtype=np.int64) + 1000 * (step + 1)
        d = rng.choice(keys, 10, replace=False)
        for idx in indexes:
            idx.insert_batch(k, v)
            idx.delete_batch(d)


@pytest.mark.parametrize("seed", [0, 1])
def test_snapshot_and_folded_pools_bitwise(seed):
    """``_snapshot_live`` is bit-equal between the packages after the
    same writes, and the port's folded pools equal the JAX builder's
    one-shot build of that snapshot, bit for bit."""
    rng = np.random.default_rng(seed)
    keys = np.unique(np.concatenate([rng.lognormal(0, 2, 3000) * 1e6,
                                     1e15 + np.arange(30.0)]))
    pv = np.arange(keys.shape[0], dtype=np.int64)
    cfg = dict(rebuild_frac=10.0, delta_cap=16)     # no fold until asked
    jx = jfa.FlatAFLI(jfa.FlatAFLIConfig(**cfg))
    pt = tfa.FlatAFLI(tfa.FlatAFLIConfig(**cfg), device="cpu")
    for idx in (jx, pt):
        idx.build(keys, pv)
    _same_ops([jx, pt], rng, keys)
    assert pt.stats()["run_len"] > 0
    js, ts = jx._snapshot_live(), pt._snapshot_live()
    for x, y in zip(js, ts):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert pt.d_tail == jx.d_tail
    jb = jfa._Builder(jfa.FlatAFLIConfig(**cfg), jx.d_tail)
    jb.build(*js)
    want = jb.finalize()
    pt.rebuild()
    assert pt.n_rebuilds == 1 and pt.stats()["run_len"] == 0
    for field, x, y in zip(want._fields, want, pt.arrays):
        x = np.asarray(x)
        assert x.dtype == y.dtype and np.array_equal(x, y), field
    assert pt.max_depth == jb.max_depth + 1
    # the scan pool is the snapshot
    s = pt._serving.scan
    n = s.length
    assert n == js[0].shape[0]
    assert np.array_equal(s.pk[:n].numpy(), js[0])
    assert np.array_equal(s.pv[:n].numpy(), js[3].astype(np.int32))


def test_fold_is_bounded_per_write_and_serves_while_running():
    """A fold started by the write path runs over several write calls;
    reads in between see the old tree plus the tiers, and are right."""
    rng = np.random.default_rng(5)
    keys = np.unique(rng.uniform(0, 1e9, 6000))
    load, extra = keys[::2], keys[1::2]
    cfg = tfa.FlatAFLIConfig(rebuild_frac=0.1, delta_cap=64,
                             fold_step_keys=256, fold_work_factor=2.0)
    idx = tfa.FlatAFLI(cfg, device="cpu")
    idx.build(load, np.arange(load.shape[0]))
    oracle = dict(zip(load, range(load.shape[0])))
    mid_fold_reads = 0
    for i in range(0, extra.shape[0], 100):
        k = extra[i:i + 100]
        v = np.arange(k.shape[0]) + 10_000 + i
        idx.insert_batch(k, v)
        oracle.update(zip(k, v))
        probe = rng.choice(np.array(list(oracle)), 200)
        got = idx.lookup_batch(probe)
        assert np.array_equal(got, [oracle[x] for x in probe])
        mid_fold_reads += int(idx.stats()["fold_active"])
    assert idx.n_rebuilds >= 1 and mid_fold_reads >= 2
    live = np.array(sorted(oracle))
    assert np.array_equal(idx.lookup_batch(live), [oracle[x] for x in live])


@pytest.mark.parametrize("step", [64, 1024])
def test_fold_tick_bounds_fits_and_charges(step, monkeypatch):
    """Each build step of a fold fits and places one chunk of nodes of
    at most ``fold_step_keys`` keys (or one node above it, charged as a
    partition pass); one tick at a budget of ``step`` places at most two
    steps' worth of keys in multi-node chunks and overshoots its budget
    by at most its last step; and the folded pools equal a one-shot
    build of the same snapshot, of either package, bit for bit."""
    rng = np.random.default_rng(11)
    keys = np.unique(np.floor(rng.lognormal(0, 2, 40_000) * 1e9))
    pv = np.arange(keys.shape[0], dtype=np.int64)
    cfg = tfa.FlatAFLIConfig(fold_step_keys=step, rebuild_frac=10.0)
    idx = tfa.FlatAFLI(cfg, device="cpu")
    idx.build(keys, pv)
    fits = []                       # per _fit call: (nodes, keys)
    fit = tfa._Builder._fit

    def counting_fit(self, pk, s0, n, skip):
        fits.append((int(n.shape[0]), int(n.sum())))
        return fit(self, pk, s0, n, skip)

    monkeypatch.setattr(tfa._Builder, "_fit", counting_fit)
    idx._fold_start()
    fold = idx._fold
    snapshot = (fold.pk, fold.hi, fold.lo, fold.pv)
    charges = []
    levels = fold._levels

    def recorded():
        for c in levels:
            charges.append(c)
            yield c

    fold._levels = recorded()
    ticks = []
    while idx._fold is not None:
        f0, c0 = len(fits), len(charges)
        idx._fold_tick(step)
        ticks.append((fits[f0:], charges[c0:]))
    assert idx.n_rebuilds == 1 and len(fits) > 10
    for nodes, k in fits:
        assert nodes == 1 or k <= step, (nodes, k)
    for tick_fits, tick_charges in ticks:
        assert sum(k for nodes, k in tick_fits if nodes > 1) <= 2 * step
        if tick_charges:
            assert sum(tick_charges[:-1]) < step
    build_ticks = sum(1 for f, c in ticks if c)
    assert build_ticks >= sum(k for _, k in fits) // (16 * 2 * step)
    one = tfa._Builder(cfg, idx.d_tail)
    one.build(*snapshot)
    jb = jfa._Builder(jfa.FlatAFLIConfig(fold_step_keys=step), idx.d_tail)
    jb.build(*snapshot)
    for field, x, y, z in zip(one.finalize()._fields, one.finalize(),
                              idx.arrays, jb.finalize()):
        z = np.asarray(z)
        assert np.array_equal(x, y) and x.dtype == y.dtype, field
        assert np.array_equal(x, z) and x.dtype == z.dtype, field


def test_fold_start_call_spends_its_budget_on_the_snapshot():
    """The write call that starts a fold pays the O(n) snapshot, counts
    it against its budget and takes no build step when the snapshot
    alone exceeds the budget; the next call does, and the fold still
    swaps in-stream with every read right."""
    rng = np.random.default_rng(9)
    keys = np.unique(rng.uniform(0, 1e9, 8000))
    load, extra = keys[::2], keys[1::2]
    cfg = tfa.FlatAFLIConfig(rebuild_frac=0.05, delta_cap=64,
                             fold_step_keys=128, fold_work_factor=2.0)
    idx = tfa.FlatAFLI(cfg, device="cpu")
    idx.build(load, np.arange(load.shape[0]))
    oracle = dict(zip(load, range(load.shape[0])))
    started = None
    for i in range(0, extra.shape[0], 100):
        k = extra[i:i + 100]
        v = np.arange(k.shape[0]) + 10_000 + i
        had = idx._fold is not None
        idx.insert_batch(k, v)
        oracle.update(zip(k, v))
        if started is None and not had and idx._fold is not None:
            started = idx._fold
            assert started.n > 2 * 100           # snapshot above budget
            assert started.report["ticks"] == 0 and started.phase == "build"
        elif started is not None and idx._fold is started:
            assert started.report["ticks"] >= 1
        got = idx.lookup_batch(k)
        assert np.array_equal(got, v)
    assert started is not None and idx.n_rebuilds >= 1
    live = np.array(sorted(oracle))
    assert np.array_equal(idx.lookup_batch(live), [oracle[x] for x in live])


def test_unbuilt_index_buffers_writes_in_the_tiers():
    """Writes before any build land in the tiers and are served from
    them (the tree is empty); a build then replaces them, as in the JAX
    package."""
    keys = np.arange(1.0, 200.0) * 3.5
    for idx in (jfa.FlatAFLI(jfa.FlatAFLIConfig(delta_cap=16)),
                tfa.FlatAFLI(tfa.FlatAFLIConfig(delta_cap=16),
                             device="cpu")):
        idx.insert_batch(keys, np.arange(keys.shape[0]))
        assert np.array_equal(idx.delete_batch(keys[:5]), np.ones(5, bool))
        assert idx.n_keys == keys.shape[0] - 5
        got = idx.lookup_batch(keys)
        assert (got[:5] == -1).all()
        assert np.array_equal(got[5:], np.arange(5, keys.shape[0]))
        idx.rebuild()                       # nothing to fold into
        assert idx.n_rebuilds == 0
        idx.build(keys[:50], np.arange(50) + 7)
        assert np.array_equal(idx.lookup_batch(keys[:50]), np.arange(50) + 7)
        assert (idx.lookup_batch(keys[50:]) == -1).all()


def test_payload_sentinels_rejected():
    idx = tfa.FlatAFLI(device="cpu")
    with pytest.raises(ValueError, match="payloads"):
        idx.insert_batch(np.array([1.0]), np.array([-2]))


def test_readme_flat_session_runs_on_the_port():
    """README.md's flat-backend session, against repro_torch with
    device="cpu" and otherwise unchanged."""
    from repro_torch.core.nfl import NFL, NFLConfig

    rng = np.random.default_rng(0)
    keys = np.unique(rng.lognormal(10.0, 2.0, 8000))
    payloads = np.arange(len(keys), dtype=np.int64)

    nfl = NFL(NFLConfig(backend="flat", force_flow=False), device="cpu")
    nfl.bulkload(keys, payloads)

    hits = nfl.lookup_batch(keys[:1000])
    assert (hits == payloads[:1000]).all()

    nfl.insert_batch(keys[:10] + 0.5, payloads[:10] + 100_000)
    assert (nfl.lookup_batch(keys[:10] + 0.5) == payloads[:10] + 100_000).all()

    ok = nfl.delete_batch(keys[:5])
    assert ok.all() and (nfl.lookup_batch(keys[:5]) == -1).all()

    pv, cnt, tot = nfl.scan_batch([keys[100]], [keys[140]])
    assert cnt[0] == 40  # [lo, hi) over key order (flow off)
