"""repro_torch's baseline indexes (B-Tree, RMI, PGM, ALEX, LIPP) against
the JAX package's, on the same keys: the cases of ``tests/test_baselines.py``
run on both packages, and lookups, insert and delete traces, ``stats()``,
``size_bytes()`` and PGM's ``build_segments`` arrays must be equal.  Both
are numpy on the host.  Tolerance: none, every comparison is exact."""

import numpy as np
import pytest
try:
    from hypothesis import given, settings, strategies as st
except ModuleNotFoundError:  # optional dep: seeded-random fallback
    from _hyp_fallback import given, settings, st

import repro.index as j_index
from repro.index.pgm import build_segments as j_build_segments

import repro_torch.index as t_index
from repro_torch.index import REGISTRY, make_index
from repro_torch.index.pgm import build_segments

UPDATABLE = [n for n in REGISTRY if n != "rmi"]


def _data(n=20_000, seed=0, skewed=False):
    rng = np.random.default_rng(seed)
    if skewed:
        keys = np.unique(np.floor(rng.lognormal(0, 2, int(n * 1.4)) * 1e9))[:n]
    else:
        keys = np.unique(rng.uniform(0, 1e12, int(n * 1.2)))[:n]
    return keys.astype(np.float64), np.arange(len(keys), dtype=np.int64)


def _pair(name):
    return make_index(name), j_index.make_index(name)


def _same(port, ref):
    assert port.stats() == ref.stats()
    assert port.size_bytes() == ref.size_bytes()


def test_registry_matches():
    assert list(REGISTRY) == list(j_index.REGISTRY)
    assert set(t_index.__all__) == set(j_index.__all__)


@pytest.mark.parametrize("name", list(REGISTRY))
@pytest.mark.parametrize("skewed", [False, True])
def test_bulkload_lookup(name, skewed):
    keys, pv = _data(seed=1, skewed=skewed)
    port, ref = _pair(name)
    port.bulkload(keys, pv)
    ref.bulkload(keys, pv)
    res = port.lookup_batch(keys[::7])
    assert np.array_equal(res, pv[::7])
    assert np.array_equal(res, ref.lookup_batch(keys[::7]))
    _same(port, ref)


@pytest.mark.parametrize("name", list(REGISTRY))
def test_negative_lookup(name):
    keys, pv = _data(seed=2)
    port, ref = _pair(name)
    port.bulkload(keys[::2], pv[::2])
    ref.bulkload(keys[::2], pv[::2])
    res = port.lookup_batch(keys[1::2][:2000])
    assert (res == -1).all()
    assert np.array_equal(res, ref.lookup_batch(keys[1::2][:2000]))


@pytest.mark.parametrize("name", UPDATABLE)
def test_insert_lookup(name):
    keys, pv = _data(n=10_000, seed=3, skewed=True)
    port, ref = _pair(name)
    for idx in (port, ref):
        idx.bulkload(keys[::2], pv[::2])
        idx.insert_batch(keys[1::2], pv[1::2])
    assert np.array_equal(port.lookup_batch(keys[1::2]), pv[1::2])
    assert np.array_equal(port.lookup_batch(keys[::2]), pv[::2])
    assert np.array_equal(port.lookup_batch(keys), ref.lookup_batch(keys))
    _same(port, ref)


def test_rmi_insert_raises():
    keys, pv = _data(n=2_000, seed=3)
    idx = make_index("rmi")
    idx.bulkload(keys, pv)
    with pytest.raises(NotImplementedError, match="static"):
        idx.insert(1.5, 1)


@pytest.mark.parametrize("name", UPDATABLE)
def test_delete(name):
    keys, pv = _data(n=5_000, seed=4)
    port, ref = _pair(name)
    port.bulkload(keys, pv)
    ref.bulkload(keys, pv)
    victims = keys[100:140]
    deleted = [port.delete(float(k)) for k in victims]
    assert deleted == [ref.delete(float(k)) for k in victims]
    _same(port, ref)
    if name == "pgm":
        # LSM static runs are immutable (documented simplification)
        return
    assert all(deleted)
    assert (port.lookup_batch(victims) == -1).all()


@pytest.mark.parametrize("name", UPDATABLE)
def test_random_trace_equal(name):
    """A random trace of inserts (absent keys), deletes (present and
    absent) and lookup batches: every answer equal across the packages,
    stats and sizes equal at the end."""
    keys, pv = _data(n=6_000, seed=8, skewed=True)
    rng = np.random.default_rng(9)
    load = rng.random(keys.shape[0]) < 0.5
    port, ref = _pair(name)
    port.bulkload(keys[load], pv[load])
    ref.bulkload(keys[load], pv[load])
    live = set(keys[load].tolist())
    for step in range(600):
        k = float(keys[int(rng.integers(keys.shape[0]))])
        op = rng.choice(["insert", "delete", "lookup"], p=[0.5, 0.2, 0.3])
        if op == "insert" and k not in live:
            port.insert(k, 10_000 + step)
            ref.insert(k, 10_000 + step)
            live.add(k)
        elif op == "delete":
            ok = port.delete(k)
            assert ok == ref.delete(k)
            if ok:
                live.discard(k)
        else:
            q = keys[rng.integers(keys.shape[0], size=64)]
            assert np.array_equal(port.lookup_batch(q), ref.lookup_batch(q))
    assert np.array_equal(port.lookup_batch(keys), ref.lookup_batch(keys))
    _same(port, ref)


def test_rmi_telemetry():
    keys, pv = _data(n=30_000, seed=5, skewed=True)
    port, ref = _pair("rmi")
    port.bulkload(keys, pv)
    ref.bulkload(keys, pv)
    port.lookup_batch(keys[:1000])
    ref.lookup_batch(keys[:1000])
    assert port.n_predictions > 0
    assert port.stats()["max_leaf_err"] >= 0
    assert (port.n_predictions, port.n_pred_errors) == (ref.n_predictions,
                                                        ref.n_pred_errors)
    for a in ("leaf_slope", "leaf_intercept", "leaf_err"):
        assert np.array_equal(getattr(port, a), getattr(ref, a))
    _same(port, ref)


@pytest.mark.parametrize("eps", [8, 32, 64])
def test_pgm_segments_bit_equal(eps):
    keys = np.unique(np.random.default_rng(6).uniform(0, 1e9, 20_000))
    seg_keys, slopes, intercepts = build_segments(keys, eps=eps)
    for a, b in zip((seg_keys, slopes, intercepts),
                    j_build_segments(keys, eps=eps)):
        assert a.dtype == b.dtype
        assert np.array_equal(a.view(np.uint64), b.view(np.uint64))
    # the epsilon bound for every key against its segment
    seg_of = np.clip(np.searchsorted(seg_keys, keys, side="right") - 1, 0, None)
    pred = slopes[seg_of] * (keys - seg_keys[seg_of]) + intercepts[seg_of]
    err = np.abs(pred - np.arange(len(keys)))
    assert err.max() <= eps + 1  # eps + rounding slack


@settings(max_examples=10, deadline=None)
@given(st.lists(st.floats(min_value=0, max_value=1e15, allow_nan=False,
                          allow_infinity=False),
                min_size=8, max_size=400, unique=True))
def test_property_all_indexes_agree(keys):
    keys = np.asarray(sorted(keys), dtype=np.float64)
    pv = np.arange(len(keys), dtype=np.int64)
    half = len(keys) // 2
    results = {}
    for name in UPDATABLE:
        port, ref = _pair(name)
        for idx in (port, ref):
            idx.bulkload(keys[:half], pv[:half])
            idx.insert_batch(keys[half:], pv[half:])
        results[name] = port.lookup_batch(keys)
        assert np.array_equal(results[name], ref.lookup_batch(keys)), name
        _same(port, ref)
    for name, res in results.items():
        assert np.array_equal(res, pv), name
