"""repro_torch's AFLI (the paper's pointer tree) against the JAX package's.

Both are numpy on the host.  The behaviour tests of ``tests/test_afli.py``
run against the port; then both packages build trees from the same
``(pkeys, ikeys, payloads)`` and a walk holds them bit-equal (node kinds,
model slopes and intercepts by their bits, entry arrays, bucket lists,
dense occupancy, the slots that share a child, ``d_tail``, ``n_keys`` and
``stats()``), after the bulk load and after a random trace of inserts,
updates, deletes and lookups checked step by step against each other and
a dict.  Tolerance: none, every comparison is exact."""

import numpy as np
import pytest
try:
    from hypothesis import given, settings, strategies as st
except ModuleNotFoundError:  # optional dep: seeded-random fallback
    from _hyp_fallback import given, settings, st

import repro.core.afli as j_afli

import repro_torch.core.afli as t_afli
from repro_torch.core.afli import AFLI, AFLIConfig
from repro_torch.data.datasets import make_dataset


def _mkidx(keys, payloads=None):
    keys = np.asarray(keys, dtype=np.float64)
    payloads = np.arange(len(keys), dtype=np.int64) if payloads is None else payloads
    idx = AFLI()
    idx.bulkload(keys, payloads)
    return idx, keys, payloads


# ------------------------------------------------ tests/test_afli.py, port
def test_bulkload_lookup_uniform():
    rng = np.random.default_rng(0)
    keys = np.unique(rng.uniform(0, 1e9, 20_000))
    idx, keys, pv = _mkidx(keys)
    for i in range(0, len(keys), 37):
        assert idx.lookup(float(keys[i])) == int(pv[i])


def test_bulkload_lookup_skewed():
    rng = np.random.default_rng(1)
    keys = np.unique(np.floor(rng.lognormal(0, 2, 30_000) * 1e9))
    idx, keys, pv = _mkidx(keys)
    miss = sum(idx.lookup(float(k)) != int(p)
               for k, p in zip(keys[::11], pv[::11]))
    assert miss == 0


def test_negative_lookup():
    keys = np.arange(0, 10_000, 2, dtype=np.float64)
    idx, keys, _ = _mkidx(keys)
    for k in range(1, 200, 2):
        assert idx.lookup(float(k)) is None


def test_insert_then_lookup():
    rng = np.random.default_rng(2)
    all_keys = np.unique(rng.uniform(0, 1e9, 10_000))
    idx, loaded, pv = _mkidx(all_keys[::2])
    new = all_keys[1::2]
    for i, k in enumerate(new):
        idx.insert(float(k), 1000000 + i)
    for i, k in enumerate(new):
        assert idx.lookup(float(k)) == 1000000 + i
    for i in range(0, len(loaded), 53):
        assert idx.lookup(float(loaded[i])) == int(pv[i])


def test_delete_and_update():
    keys = np.unique(np.random.default_rng(3).uniform(0, 1e6, 5_000))
    idx, keys, pv = _mkidx(keys)
    assert idx.delete(float(keys[10]))
    assert idx.lookup(float(keys[10])) is None
    assert not idx.delete(float(keys[10]))
    assert idx.update(float(keys[11]), 777)
    assert idx.lookup(float(keys[11])) == 777


def test_height_low_on_near_uniform():
    rng = np.random.default_rng(4)
    keys = np.unique(rng.uniform(0, 1e9, 50_000))
    idx, _, _ = _mkidx(keys)
    assert idx.stats().height <= 3


def test_duplicate_pkeys_with_distinct_identity():
    pk = np.array([1.0, 1.0, 1.0, 2.0, 3.0])
    ik = np.array([10.0, 20.0, 30.0, 40.0, 50.0])
    pv = np.array([1, 2, 3, 4, 5], dtype=np.int64)
    idx = AFLI()
    idx.bulkload(pk, pv, ikeys=ik)
    assert idx.lookup(1.0, 20.0) == 2
    assert idx.lookup(1.0, 30.0) == 3
    assert idx.lookup(1.0, 99.0) is None


@settings(max_examples=20, deadline=None)
@given(st.data())
def test_property_insert_lookup_delete(data):
    """After any load/insert/delete mix, lookups reflect exactly the live
    key set."""
    keys = data.draw(
        st.lists(st.floats(min_value=-1e12, max_value=1e12,
                           allow_nan=False, allow_infinity=False),
                 min_size=4, max_size=300, unique=True))
    keys = np.asarray(sorted(keys), dtype=np.float64)
    n_load = data.draw(st.integers(min_value=2, max_value=len(keys)))
    idx = AFLI(AFLIConfig())
    idx.bulkload(keys[:n_load], np.arange(n_load, dtype=np.int64))
    live = {float(k): i for i, k in enumerate(keys[:n_load])}
    for j, k in enumerate(keys[n_load:]):
        idx.insert(float(k), 10_000 + j)
        live[float(k)] = 10_000 + j
    dels = data.draw(st.lists(
        st.integers(min_value=0, max_value=len(keys) - 1), max_size=30))
    for di in dels:
        k = float(keys[di])
        expected = k in live
        assert idx.delete(k) == expected
        live.pop(k, None)
    for k in map(float, keys):
        got = idx.lookup(k)
        assert got == live.get(k), (k, got, live.get(k))


# ------------------------------------------------ bit-equal to the JAX tree
def _bits(x):
    return np.asarray(x, np.float64).view(np.uint64)


def _same_floats(a, b):
    assert np.array_equal(_bits(a), _bits(b))


def _sharing(ptrs):
    """For every slot, the first slot holding the same object (-1: none):
    the duplicated-pointer pattern of a model node."""
    first = {}
    return [-1 if p is None else first.setdefault(id(p), i)
            for i, p in enumerate(ptrs)]


def assert_same_node(a, b):
    """Walk the port's node ``a`` and the JAX node ``b`` together."""
    kind = type(a).__name__
    assert kind == type(b).__name__
    if kind == "_DenseNode":
        assert a.n == b.n
        assert np.array_equal(a.occ, b.occ)
        occ = a.occ
        _same_floats(a.pkeys[occ], b.pkeys[occ])
        _same_floats(a.ikeys[occ], b.ikeys[occ])
        assert np.array_equal(a.payloads[occ], b.payloads[occ])
        return
    assert kind == "_ModelNode"
    _same_floats([a.slope, a.intercept], [b.slope, b.intercept])
    assert a.size == b.size
    assert np.array_equal(a.etype, b.etype)
    _same_floats(a.pkeys, b.pkeys)
    _same_floats(a.ikeys, b.ikeys)
    assert np.array_equal(a.payloads, b.payloads)
    assert _sharing(a.ptrs) == _sharing(b.ptrs)
    seen = set()
    for slot in range(a.size):
        t = int(a.etype[slot])
        if t == t_afli.BUCKET:
            ba, bb = a.ptrs[slot], b.ptrs[slot]
            assert (ba.cap, ba.ordered) == (bb.cap, bb.ordered)
            _same_floats(ba.pkeys, bb.pkeys)
            _same_floats(ba.ikeys, bb.ikeys)
            assert ba.payloads == bb.payloads
        elif t == t_afli.CHILD and id(a.ptrs[slot]) not in seen:
            seen.add(id(a.ptrs[slot]))
            assert_same_node(a.ptrs[slot], b.ptrs[slot])


def assert_same_tree(a: AFLI, b: "j_afli.AFLI"):
    assert (a.d_tail, a.n_keys) == (b.d_tail, b.n_keys)
    assert (a.root is None) == (b.root is None)
    if a.root is not None:
        assert_same_node(a.root, b.root)
    assert a.stats().as_dict() == b.stats().as_dict()


def _records(kind, n, seed=0):
    """(pkeys, ikeys or None, payloads) of one input kind."""
    rng = np.random.default_rng(seed)
    if kind in ("lognormal", "longlat"):
        pk = make_dataset(kind, n)
    elif kind == "uniform":
        pk = np.unique(rng.uniform(0, 1e12, int(n * 1.1)))[:n]
    elif kind == "f32_collided":
        # pkeys are the f32 images of distinct identities: runs collide
        ik = 1e15 + np.sort(rng.choice(1 << 24, n, replace=False)) * 3.0
        pk = ik.astype(np.float32).astype(np.float64)
        return pk, ik, rng.permutation(n).astype(np.int64)
    elif kind == "all_equal":
        ik = np.sort(rng.uniform(0, 1e6, n))
        return np.full(n, 42.0), ik, np.arange(n, dtype=np.int64)
    else:
        raise AssertionError(kind)
    return pk, None, rng.permutation(pk.shape[0]).astype(np.int64)


def _pair(cfg_kw=None):
    cfg_kw = cfg_kw or {}
    return (AFLI(AFLIConfig(**cfg_kw)), j_afli.AFLI(j_afli.AFLIConfig(**cfg_kw)))


CASES = [("lognormal", 20_000, {}), ("longlat", 20_000, {}),
         ("uniform", 20_000, {}), ("f32_collided", 6_000, {}),
         ("all_equal", 500, {}), ("longlat", 20_000, {"ordered_buckets": True}),
         ("lognormal", 20_000, {"ordered_buckets": True}),
         # LIPP's configuration: deep trees, recursion well past depth 2
         ("lognormal", 20_000, {"max_bucket": 2, "min_bucket": 2}),
         ("longlat", 20_000, {"max_bucket": 2, "min_bucket": 2})]


@pytest.mark.parametrize("kind,n,cfg_kw", CASES,
                         ids=[f"{k}-{n}-" + ("lipp" if "max_bucket" in c else
                                              "ordered" if c else "linear")
                              for k, n, c in CASES])
def test_bulkload_tree_bit_equal(kind, n, cfg_kw):
    pk, ik, pv = _records(kind, n)
    port, ref = _pair(cfg_kw)
    port.bulkload(pk, pv, ikeys=ik)
    ref.bulkload(pk, pv, ikeys=ik)
    assert_same_tree(port, ref)
    ik = pk if ik is None else ik
    for i in range(0, pk.shape[0], 7):
        got = port.lookup(float(pk[i]), float(ik[i]))
        assert got == ref.lookup(float(pk[i]), float(ik[i])) == int(pv[i])


@pytest.mark.parametrize("n", [0, 1, 2])
def test_tiny_trees_bit_equal(n):
    pk = np.array([5.0, 9.0][:n])
    pv = np.arange(n, dtype=np.int64)
    port, ref = _pair()
    port.bulkload(pk, pv)
    ref.bulkload(pk, pv)
    assert_same_tree(port, ref)
    for k in (1.0, 5.0, 9.0, 11.0):
        assert port.lookup(k) == ref.lookup(k)
        port.insert(k + 0.5, 100 + n)
        ref.insert(k + 0.5, 100 + n)
    assert_same_tree(port, ref)


def test_empty_tree_insert_bit_equal():
    port, ref = _pair()
    for k in (3.0, 1.0, 2.0):
        port.insert(k, int(k))
        ref.insert(k, int(k))
        assert_same_tree(port, ref)
    assert port.lookup(2.0) == 2


TRACES = [("longlat", {}), ("lognormal", {}), ("f32_collided", {}),
          ("uniform", {"ordered_buckets": True})]


@pytest.mark.parametrize("kind,cfg_kw", TRACES,
                         ids=[f"{k}-{'ordered' if c else 'linear'}"
                              for k, c in TRACES])
def test_random_trace_bit_equal(kind, cfg_kw):
    """2,000 random inserts (of absent keys), updates, deletes
    and lookups, present and absent: every answer equal across the two
    packages and to a dict; the trees equal after the trace."""
    pk, ik, pv = _records(kind, 4_000, seed=11)
    ik = pk.copy() if ik is None else ik
    rng = np.random.default_rng(5)
    load = rng.random(pk.shape[0]) < 0.5
    port, ref = _pair(cfg_kw)
    port.bulkload(pk[load], pv[load], ikeys=ik[load])
    ref.bulkload(pk[load], pv[load], ikeys=ik[load])
    live = {float(i): int(v) for i, v in zip(ik[load], pv[load])}
    kinds = rng.choice(["insert", "update", "delete", "lookup"], 2_000,
                       p=[0.4, 0.15, 0.15, 0.3])
    for step, op in enumerate(kinds):
        j = int(rng.integers(pk.shape[0]))
        p, i = float(pk[j]), float(ik[j])
        if op == "insert" and i in live:
            # the tree keeps unique identities: a present key is updated
            op = "update"
        if op == "insert":
            v = 1_000_000 + step
            port.insert(p, v, i)
            ref.insert(p, v, i)
            live[i] = v
        elif op == "update":
            v = 2_000_000 + step
            ok = port.update(p, v, i)
            assert ok == ref.update(p, v, i) == (i in live)
            if ok:
                live[i] = v
        elif op == "delete":
            ok = port.delete(p, i)
            assert ok == ref.delete(p, i) == (i in live)
            live.pop(i, None)
        else:
            assert port.lookup(p, i) == ref.lookup(p, i) == live.get(i)
        assert port.n_keys == ref.n_keys
    assert_same_tree(port, ref)
    for j in range(pk.shape[0]):
        got = port.lookup(float(pk[j]), float(ik[j]))
        assert got == live.get(float(ik[j]))


def _shared_dense_tree(mod):
    """A model root whose slots 2-4 share one dense child (a run of
    over-conflicted slots), built by hand in package ``mod``."""
    idx = mod.AFLI()
    idx.d_tail = 2
    root = mod._ModelNode(1.0, 0.0, 8)
    child = mod._DenseNode(np.array([2.1, 2.2, 3.5]), np.array([2.1, 2.2, 3.5]),
                           np.array([21, 22, 35], dtype=np.int64), gaps=2)
    for slot in (2, 3, 4):
        root.etype[slot] = mod.CHILD
        root.ptrs[slot] = child
    root.etype[6] = mod.DATA
    root.pkeys[6] = root.ikeys[6] = 6.0
    root.payloads[6] = 60
    idx.root, idx.n_keys = root, 4
    return idx


def test_shared_child_replacement_bit_equal():
    """A full dense child shared by several slots is remodelled on
    insert; the new child must replace it in every slot that shared it,
    in both packages alike, and keys reached through any of those slots
    read right."""
    port, ref = _shared_dense_tree(t_afli), _shared_dense_tree(j_afli)
    assert_same_tree(port, ref)
    for k in (3.2, 4.4, 2.3, 2.4, 4.1, 3.3):
        port.insert(k, int(k * 10))
        ref.insert(k, int(k * 10))
        assert_same_tree(port, ref)
    shared = {id(port.root.ptrs[s]) for s in (2, 3, 4)}
    assert len(shared) == 1
    assert type(port.root.ptrs[2]).__name__ == "_ModelNode"
    for k in (2.1, 2.2, 3.5, 3.2, 4.4, 2.3, 2.4, 4.1, 3.3, 6.0):
        want = {2.1: 21, 2.2: 22, 3.5: 35, 6.0: 60}.get(k, int(k * 10))
        assert port.lookup(k) == ref.lookup(k) == want
