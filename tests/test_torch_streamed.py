"""repro_torch streamed rung and index probe against the JAX package, on
the CPU (plain versions of the kernels).

``streamed_lookup_plain`` (the streamed kernel's plain version, which a
port index on CPU tensors serves with when ``pool_budget`` selects the
streamed rung) is held to the JAX ``streamed_lookup_pallas`` in
interpret mode, at every JAX stream tile, on the same scan pool, run and
delta (data and tombstones); flow on, to the port's fused rung and to
ground truth.  The rung selection runs the write-path harness's op trace
with the streamed rung on.  ``index_probe_plain`` is held to the JAX
oracle ``index_probe_ref`` and to ``index_probe_pallas``.  Inputs are
made with numpy and passed between the packages as numpy."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_lookup import TierPools as JTierPools
from repro.kernels.index_probe import index_probe_pallas
from repro.kernels.range_scan import ScanPool as JScanPool
from repro.kernels.ref import index_probe_ref
from repro.kernels import streamed_lookup as jsl

from repro_torch.core import flat_afli as tfa
from repro_torch.core.nfl import NFL, NFLConfig
from repro_torch.core.train_flow import FlowTrainConfig
from repro_torch.kernels import ops
from repro_torch.kernels.fused_lookup import fused_lookup_plain
from repro_torch.kernels.index_probe import index_probe_plain
from repro_torch.kernels.streamed_lookup import (STREAM_ALIGN, StreamPack,
                                                 build_router, ord_f32,
                                                 streamed_lookup_plain)
from test_torch_write_path import _TIGHT, _Side, _drive

torch.set_num_threads(1)

_LANE = 128
# z bound against the JAX kernel, as tests/test_torch_flow.py states it:
# XLA's tanh and FMA contraction against torch's rounding, a few ulp of
# max|z|
Z_ULPS = 8


def _lane(n) -> jnp.ndarray:
    a = np.zeros(_LANE, np.int32)
    a[0] = int(n.reshape(-1)[0])
    return jnp.asarray(a)


def _u32(t: torch.Tensor) -> jnp.ndarray:
    return jnp.asarray(t.numpy().view(np.uint32))


def _i32(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


def _collided_keys(rng, n=6000):
    """Uniform keys with 24-key runs of one f32 value straddling the
    1024-row tile boundaries of the sorted pool, plus a run at 1e15."""
    keys = np.sort(rng.uniform(1e8, 1e9, n))
    for r in (1010, 2040, 3060, 4090):
        c = float(np.float32(keys[r]))
        ulp = float(np.spacing(np.float32(c)))
        keys[r:r + 24] = c + np.arange(24) * (ulp / 64)
    keys = np.unique(np.concatenate([keys, 1e15 + np.arange(24.0)]))
    assert np.unique(keys.astype(np.float32)).shape[0] < keys.shape[0] - 100
    return keys


def _written_flat(rng):
    """A port FlatAFLI (no fold) with data, updates and tombstones in the
    run and the delta, its ground truth, and probe keys."""
    keys = _collided_keys(rng)
    pv = np.arange(keys.shape[0], dtype=np.int64)
    idx = tfa.FlatAFLI(tfa.FlatAFLIConfig(delta_cap=16, rebuild_frac=10.0),
                       device="cpu")
    idx.build(keys, pv)
    truth = dict(zip(keys, pv))
    dup = np.flatnonzero(np.diff(keys.astype(np.float32)) == 0)
    for r in range(3):
        fresh = rng.choice(keys, 30, replace=False) + 0.5
        again = np.concatenate([rng.choice(keys, 10, replace=False),
                                keys[rng.choice(dup, 6)]])
        gone = np.concatenate([rng.choice(keys, 10, replace=False),
                               keys[rng.choice(dup, 4)]])
        for k, v in ((fresh, np.arange(30) + 10_000 * (r + 1)),
                     (again, np.arange(16) + 50_000 * (r + 1))):
            idx.insert_batch(k, v)
            truth.update(zip(k, v))
        ok = idx.delete_batch(gone)
        for k in gone[ok]:
            truth.pop(k)
    # a tail small enough to stay in the delta: data and tombstones
    tail = rng.choice(np.array(list(truth)), 9, replace=False)
    idx.insert_batch(tail[:5], np.arange(5) + 90_000)
    truth.update(zip(tail[:5], np.arange(5) + 90_000))
    assert idx.delete_batch(tail[5:]).all()
    for k in tail[5:]:
        truth.pop(k)
    st = idx.stats()
    assert st["run_len"] and st["delta_len"] and not st["fold_active"]
    live = np.array(list(truth))
    q = np.concatenate([keys[np.clip(dup[:, None] + np.arange(-2, 3), 0,
                                     keys.shape[0] - 1)].ravel(),
                        rng.choice(live, 300), rng.choice(keys, 200),
                        rng.choice(keys, 100) + 0.25, [0.0, 2e15, -5.0]])
    return idx, truth, q[:1024]


def _jax_pools(idx):
    sp = idx._serving.stream_pack()
    s = sp.pool
    pool = JScanPool(pk=jnp.asarray(s.pk.numpy()), hi=_u32(s.hi),
                     lo=_u32(s.lo), pv=jnp.asarray(s.pv.numpy()),
                     plen=_lane(s.plen))
    tp = idx._tier_pack()
    t = tp.pools
    tiers = JTierPools(
        run_pk=jnp.asarray(t.run_pk.numpy()), run_hi=_u32(t.run_hi),
        run_lo=_u32(t.run_lo), run_pv=jnp.asarray(t.run_pv.numpy()),
        run_len=_lane(t.run_len), dl_pk=jnp.asarray(t.dl_pk.numpy()),
        dl_hi=_u32(t.dl_hi), dl_lo=_u32(t.dl_lo),
        dl_pv=jnp.asarray(t.dl_pv.numpy()), dl_len=_lane(t.dl_len))
    kw = dict(probe_tiers=True, run_iters=tp.run_iters,
              run_window=tp.run_window, delta_iters=tp.delta_iters,
              delta_window=tp.delta_window)
    return sp, tp, pool, tiers, kw


@pytest.mark.parametrize("stream_tile", [128, 1024, 4096])
def test_streamed_plain_matches_pallas_flow_off(stream_tile):
    """Bit parity with the Pallas kernel at every JAX stream tile: the
    port's one 1024-row tile gives the same payloads and z, with runs of
    equal keys across tile boundaries and both tiers populated."""
    idx, truth, q = _written_flat(np.random.default_rng(5))
    sp, tp, pool, tiers, kw = _jax_pools(idx)
    cap = int(sp.pool.pk.shape[0])
    assert cap % 4096 == 0 and sp.window >= 24
    hi, lo = tfa.split_key_bits(q)
    feats = q.astype(np.float32).reshape(-1, 1)
    pay, z = streamed_lookup_plain(torch.from_numpy(feats), _i32(hi),
                                   _i32(lo), None, sp, tp, dim=1,
                                   use_flow=False)
    jpay, jz = jsl.streamed_lookup_pallas(
        jnp.asarray(feats), jnp.asarray(hi), jnp.asarray(lo),
        jnp.zeros((1, _LANE), jnp.float32), pool,
        jsl.build_router(pool.pk), tiers, dim=1, window=sp.window,
        use_flow=False, stream_tile=stream_tile, interpret=True, **kw)
    assert np.array_equal(pay.numpy(), np.asarray(jpay))
    assert np.array_equal(z.numpy().view(np.int32),
                          np.asarray(jz).view(np.int32))
    want = np.array([truth.get(k, -1) for k in q])
    assert np.array_equal(pay.numpy(), want)
    fpay, fz = fused_lookup_plain(
        torch.from_numpy(feats), _i32(hi), _i32(lo), None,
        idx._kernel_pools(), tp, dim=1, max_depth=idx.max_depth,
        dense_iters=idx.cfg.dense_search_iters,
        bucket_cap=idx.cfg.max_bucket, dense_window=idx.dense_window,
        use_flow=False)
    assert torch.equal(fpay, pay) and torch.equal(fz, z)


def test_router_and_order_match_jax():
    """``build_router`` and ``ord_f32`` equal the JAX package's, at the
    extremes (+-inf padding, -0.0, denormals, NaN) included."""
    for cap, n in ((128, 0), (128, 100), (1024, 1000), (8192, 5000)):
        pk = np.full(cap, np.inf, np.float32)
        pk[:n] = np.sort(np.random.default_rng(cap).normal(0, 1e3, n))
        got = build_router(torch.from_numpy(pk)).numpy()
        want = np.asarray(jsl.build_router(jnp.asarray(pk)))
        assert got.shape == want.shape
        assert np.array_equal(got.view(np.int32), want.view(np.int32))
    x = np.array([-np.inf, -3e38, -1.0, -1e-45, -0.0, 0.0, 1e-45, 1.0,
                  3e38, np.inf, np.nan, -np.nan], np.float32)
    want = np.asarray(jsl._ord_f32(jnp.asarray(x))).astype(np.int64)
    assert np.array_equal(ord_f32(torch.from_numpy(x)).numpy(), want)
    assert want[4] == want[5] == 0
    assert (np.diff(want[:10]) >= 0).all()


def _flow_nfl(n_keys=6000):
    keys = np.unique(np.floor(
        np.random.default_rng(21).lognormal(0, 2, 2 * n_keys) * 1e9))
    pv = np.arange(keys.shape[0], dtype=np.int64)
    nfl = NFL(NFLConfig(backend="flat", force_flow=True,
                        flow_train=FlowTrainConfig(epochs=1),
                        flat_index=tfa.FlatAFLIConfig(delta_cap=64,
                                                      rebuild_frac=10.0)),
              device="cpu")
    nfl.bulkload(keys[::2], pv[::2])
    return nfl, keys, pv


def _rung(idx, budget):
    idx.cfg = dataclasses.replace(idx.cfg, pool_budget=budget)


def test_streamed_flow_on_matches_fused_and_truth():
    """Flow on: the streamed rung's payloads and z equal the fused rung's
    bit for bit, fresh and with data and tombstones in both tiers; every
    built key is found and every absent key missed; z agrees with the
    JAX kernel's within Z_ULPS of max|z| (payloads are not held to the
    JAX leg: its flow-on parity does not hold on this tree, ROADMAP C)."""
    nfl, keys, pv = _flow_nfl()
    idx = nfl.index
    truth = dict(zip(keys[::2], pv[::2]))
    q = np.concatenate([keys[::3], keys[1::7]])
    feats = nfl._feats(q)
    hi, lo = tfa.split_key_bits(q)

    def both():
        out = {}
        for budget, rung in ((None, "fused"), (0, "streamed")):
            _rung(idx, budget)
            out[rung] = idx._flow_device_lookup(feats, hi, lo, nfl._packed_w,
                                                nfl._shapes)
            assert idx.last_dispatch["path"] == rung
        (fp, fz), (sp_, sz) = out["fused"], out["streamed"]
        assert np.array_equal(fp, sp_)
        assert np.array_equal(fz.view(np.int32), sz.view(np.int32))
        assert np.array_equal(sp_, [truth.get(k, -1) for k in q])
        return sz

    sz = both()
    sp = idx._serving.stream_pack()
    s = sp.pool
    pool = JScanPool(pk=jnp.asarray(s.pk.numpy()), hi=_u32(s.hi),
                     lo=_u32(s.lo), pv=jnp.asarray(s.pv.numpy()),
                     plen=_lane(s.plen))
    cap = int(s.pk.shape[0])
    _jp, jz = jsl.streamed_lookup_pallas(
        jnp.asarray(feats), jnp.asarray(hi), jnp.asarray(lo),
        jnp.asarray(nfl._packed_w.numpy()), pool, jsl.build_router(pool.pk),
        None, dim=nfl.cfg.flow.dim, shapes=nfl._shapes, window=sp.window,
        use_flow=True, stream_tile=cap, tile=1024, interpret=True)
    scale = float(np.abs(sz).max())
    eps = float(np.finfo(np.float32).eps)
    assert np.abs(np.asarray(jz, np.float64) - sz).max() <= \
        Z_ULPS * eps * scale

    rng = np.random.default_rng(4)
    ins = keys[1::2][:300]
    nfl.insert_batch(ins, pv[1::2][:300] + 7)
    truth.update(zip(ins, pv[1::2][:300] + 7))
    upd = rng.choice(keys[::2], 80, replace=False)
    nfl.update_batch(upd, np.arange(80) + 900_000)
    truth.update(zip(upd, np.arange(80) + 900_000))
    gone = rng.choice(keys[::2], 150, replace=False)
    nfl.delete_batch(gone[:120])
    nfl.insert_batch(keys[1::2][300:330], pv[1::2][300:330] + 7)
    truth.update(zip(keys[1::2][300:330], pv[1::2][300:330] + 7))
    nfl.delete_batch(gone[120:])          # the tail stays in the delta
    for k in gone:
        truth.pop(k, None)
    st = nfl.stats()
    assert st["run_len"] and st["delta_len"]
    both()


@pytest.mark.parametrize("budget,seed", [(0, 0), (0, 1), (None, 0),
                                         (None, 2)])
def test_rung_selection_on_op_trace(budget, seed, monkeypatch):
    """The write-path harness's op trace (tight tiers, folds in-stream
    and explicit) with ``pool_budget=budget``: every read equals the dict
    oracle, those served mid-fold included.  With budget 0 every live
    read streams and no placement verify does (build, fold chunks); with
    None nothing streams.  The
    router is built once per scan-pool upload a streamed read sees,
    never per read."""
    rng = np.random.default_rng(seed)
    pool = np.unique(rng.uniform(0, 1e9, 400))
    pool = np.concatenate([pool, 1e15 + np.arange(24.0)])
    port = tfa.FlatAFLI(tfa.FlatAFLIConfig(
        pool_budget=budget, **_TIGHT), device="cpu")
    calls = _record(port, monkeypatch)
    _drive([_Side(port)], rng, pool, n_ops=16, payload_base=10_000)
    _check_calls(port, calls, budget)


def test_rung_selection_nfl_flow_on(monkeypatch):
    """As above through ``NFL`` with the flow on: its serve verify stays
    on the fused rung, its reads stream."""
    rng = np.random.default_rng(98)
    pool = np.unique(np.floor(rng.lognormal(0, 2, 600) * 1e9))
    nfl = NFL(NFLConfig(backend="flat", force_flow=True,
                        flow_train=FlowTrainConfig(epochs=1),
                        flat_index=tfa.FlatAFLIConfig(pool_budget=0,
                                                      **_TIGHT)),
              device="cpu")
    calls = _record(nfl.index, monkeypatch)
    _drive([_Side(nfl)], rng, pool, n_ops=14, payload_base=100_000)
    assert nfl.use_flow
    _check_calls(nfl.index, calls, 0)
    assert nfl.dispatch_stats()["streamed_lookup_launches"] == 0  # CPU


def _record(idx, monkeypatch):
    """Record each point dispatch: (verify?, rung, fold in flight?), and
    check the router count against the scan-pool uploads seen."""
    calls = []
    state = {"verify": 0, "keys": set()}
    real = ops.fused_lookup

    def rec(*a, **k):
        scan = idx._serving.scan
        key = (scan.uploads, scan.capacity)
        out = real(*a, **k)
        calls.append((state["verify"] > 0, out[2], idx._fold is not None))
        if out[2] == "streamed":
            state["keys"].add(key)
            assert idx._serving.router_builds == len(state["keys"])
        return out

    def verify(fn):
        def wrapped(*a, **k):
            state["verify"] += 1
            try:
                return fn(*a, **k)
            finally:
                state["verify"] -= 1
        return wrapped

    monkeypatch.setattr(ops, "fused_lookup", rec)
    for owner, name in ((tfa.FlatAFLI, "_self_verify"),
                        (tfa.FlatAFLI, "verify_serve_flow"),
                        (tfa._Fold, "_verify_chunk")):
        monkeypatch.setattr(owner, name, verify(getattr(owner, name)))
    return calls


def _check_calls(idx, calls, budget):
    assert idx.n_rebuilds > 0
    verifies = [c for c in calls if c[0]]
    live = [c for c in calls if not c[0]]
    assert verifies and live
    assert all(rung == "fused" for _v, rung, _f in verifies)
    if budget is None:
        assert all(rung == "fused" for _v, rung, _f in live)
        assert idx._serving.router_builds == 0
    else:
        assert all(rung == "streamed" for _v, rung, _f in live)
        assert any(fold for _v, _r, fold in live)        # served mid-fold
        st = idx._serving.stats()
        assert 1 <= st["router_builds"] <= 1 + idx.n_rebuilds
        assert st["stream_reuses"] == len(live) - st["router_builds"]


def test_empty_pool_serves_from_the_tiers():
    """An index never built, with buffered writes, on the streamed rung:
    the scan pool is empty and every read resolves from the tiers."""
    keys = np.arange(1.0, 300.0) * 3.5
    idx = tfa.FlatAFLI(tfa.FlatAFLIConfig(delta_cap=16, pool_budget=0),
                       device="cpu")
    idx.insert_batch(keys, np.arange(keys.shape[0]))
    assert idx.delete_batch(keys[:7]).all()
    got = idx.lookup_batch(np.concatenate([keys, keys + 0.5]))
    assert idx.last_dispatch == {"path": "streamed", "n_dispatch": 1,
                                 "tier_path": "kernel"}
    assert (got[:7] == -1).all() and (got[keys.shape[0]:] == -1).all()
    assert np.array_equal(got[7:keys.shape[0]], np.arange(7, keys.shape[0]))
    sp = idx._serving.stream_pack()
    assert int(sp.pool.plen) == 0 and sp.router.shape[0] == _LANE
    hi, lo = tfa.split_key_bits(keys)
    pay, z = streamed_lookup_plain(
        torch.from_numpy(keys.astype(np.float32).reshape(-1, 1)), _i32(hi),
        _i32(lo), None, sp, None, dim=1, use_flow=False)
    assert (pay == -1).all()
    assert torch.equal(z, torch.from_numpy(keys.astype(np.float32)))


def test_stream_tile_is_the_router_slice():
    assert STREAM_ALIGN == jsl.STREAM_ALIGN
    pk = torch.full((4096,), float("inf"))
    pk[:3000] = torch.arange(3000.0)
    sp = StreamPack(pool=None, router=build_router(pk), window=1)
    assert sp.router[:3].tolist() == [0.0, 1024.0, 2048.0]
    assert sp.router[3:].isinf().all()


# ------------------------------------------------------------ index_probe
def _probe_both(q32, qhi, qlo, slope, intercept, etype, ehi, elo, epay,
                echild, via_ops=False):
    """Port plain (or ``ops.index_probe`` on CPU tensors), JAX oracle and
    JAX Pallas kernel on one node; returns the three output triples as
    numpy."""
    fn = ops.index_probe if via_ops else index_probe_plain
    port = fn(torch.from_numpy(q32), _i32(qhi), _i32(qlo),
              np.float32(slope), np.float32(intercept),
              torch.from_numpy(etype.astype(np.int32)), _i32(ehi),
              _i32(elo), torch.from_numpy(epay.astype(np.int32)),
              torch.from_numpy(echild.astype(np.int32)))
    args = (jnp.asarray(q32), jnp.asarray(qhi), jnp.asarray(qlo),
            jnp.float32(slope), jnp.float32(intercept), jnp.asarray(etype),
            jnp.asarray(ehi), jnp.asarray(elo), jnp.asarray(epay),
            jnp.asarray(echild))
    ref = index_probe_ref(*args)
    pallas = index_probe_pallas(*args, interpret=True)
    return ([x.numpy() for x in port], [np.asarray(x) for x in ref],
            [np.asarray(x) for x in pallas])


def _check_probe(q32, slope, intercept, etype, echild, port, ref, pallas):
    """The port takes the unfused f32 slot (the numpy builder's), on
    every query, and is bit-equal to ``index_probe_ref`` on every query;
    it is bit-equal to the Pallas kernel wherever that slot equals the
    FMA slot (XLA's on the CPU); the rest are few and sit within two
    ulps of a rint half-way point."""
    size = etype.shape[0]
    sl, ic = np.float32(slope), np.float32(intercept)
    unfused = np.clip(np.rint(sl * q32 + ic), 0, size - 1).astype(np.int64)
    assert np.array_equal(port[1], etype[unfused])
    assert np.array_equal(port[2], echild[unfused])
    for a, b in zip(port, ref):
        assert a.dtype == np.int32
        assert np.array_equal(a, np.asarray(b))
    exact = np.float64(sl) * q32.astype(np.float64) + np.float64(ic)
    fma = np.clip(np.rint(exact.astype(np.float32)), 0, size - 1)
    same = unfused == fma
    for a, b in zip(port, pallas):
        assert np.array_equal(a[same], np.asarray(b)[same])
    off = np.flatnonzero(~same)
    assert off.shape[0] <= 1 + q32.shape[0] // 100
    half = np.floor(exact[off]) + 0.5
    ulp = np.spacing(np.abs(exact[off]).astype(np.float32)).astype(np.float64)
    assert (np.abs(exact[off] - half) <= 2 * ulp).all()
    return off.shape[0]


@pytest.mark.parametrize("n_entries", [64, 1000, 4096])
@pytest.mark.parametrize("batch", [1, 300, 512])
def test_index_probe_plain_sweep(n_entries, batch):
    """The sweep of tests/test_kernels.py's index-probe test."""
    rng = np.random.default_rng(n_entries + batch)
    ekey = np.sort(rng.uniform(0, 1e6, n_entries)).astype(np.float32)
    etype = rng.integers(0, 4, n_entries).astype(np.int32)
    ehi, elo = tfa.split_key_bits(ekey.astype(np.float64))
    epay = rng.integers(0, 1 << 30, n_entries).astype(np.int32)
    echild = rng.integers(-1, 50, n_entries).astype(np.int32)
    slope, intercept = np.float32(n_entries / 1e6), np.float32(0.0)
    q64 = rng.choice(ekey, batch).astype(np.float64)
    qhi, qlo = tfa.split_key_bits(q64)
    q32 = q64.astype(np.float32)
    port, ref, pallas = _probe_both(q32, qhi, qlo, slope, intercept, etype,
                                    ehi, elo, epay, echild)
    _check_probe(q32, slope, intercept, etype, echild, port, ref, pallas)


def test_index_probe_plain_on_real_root_node():
    """The root node of a port build (bit-equal to the JAX builder's),
    probed through ``ops.index_probe`` on CPU tensors with every built
    key: a few land on rint half-way points, where the Pallas kernel's
    contracted FMA takes the other slot."""
    rng = np.random.default_rng(7)
    keys = np.unique(rng.uniform(0, 1e9, 20_000))
    idx = tfa.FlatAFLI(device="cpu")
    idx.build(keys, np.arange(len(keys)))
    a = idx.arrays
    size = int(a.node_size[0])
    q64 = keys
    qhi, qlo = tfa.split_key_bits(q64)
    q32 = q64.astype(np.float32)
    node = (a.node_slope[0], a.node_intercept[0], a.etype[:size],
            a.ehi[:size], a.elo[:size], a.epayload[:size], a.echild[:size])
    port, ref, pallas = _probe_both(q32, qhi, qlo, *node, via_ops=True)
    assert _check_probe(q32, node[0], node[1], node[2], node[6], port, ref,
                        pallas) > 0
    assert int((port[0] >= 0).sum()) > 0
    # a DATA hit is the payload the whole lookup serves
    hit = port[0] >= 0
    assert np.array_equal(port[0][hit], idx.lookup_batch(q64[hit]))
