"""repro_torch sharded serving on the CPU (plain kernels), after
``tests/test_sharded.py``, and held to the JAX package.

``NFL(backend="flat", shards=P)`` of the port must serve like the single
flat index on every route: mixed insert / delete / point / range
interleavings against a last-write-wins dict oracle (flow on and off),
single-index parity on untruncated ranges, straddling range splits,
skewed traffic, an empty shard, and an in-stream fold on a busy shard
while the other shards keep serving.  Against the JAX package, on the
same seeded numpy inputs: the router helpers' outputs, each shard's
pools bit for bit given the same positioning keys (flow off, or the same
precomputed z), and point and scan results.  Shadow sets are reported,
not compared (ROADMAP's parity rules); flow-on legs hold both packages
to the oracle first (ROADMAP C).
"""

import jax
import numpy as np
import pytest
import torch

import repro.core.nfl as j_nfl
from repro.core import flat_afli as jfa
from repro.core.sharded_nfl import ShardedFlatAFLI as JSharded
from repro.kernels import shard_dispatch as jsd

import repro_torch.core.nfl as t_nfl
from repro_torch.core.flat_afli import FlatAFLIConfig
from repro_torch.core.nfl import NFL, NFLConfig
from repro_torch.core.sharded_nfl import ShardedFlatAFLI
from repro_torch.core.train_flow import FlowTrainConfig
from repro_torch.dist.sharding import shard_mesh
from repro_torch.kernels.shard_dispatch import (bin_by_shard,
                                                choose_boundaries,
                                                fanout_plan,
                                                refresh_boundaries, route,
                                                route_flow, split_ranges)
from repro_torch.kernels.nf_forward import nf_forward_plain
from repro_torch.weights import params_from_numpy

torch.set_num_threads(1)

# squeezed tier bounds: a few hundred routed inserts cross every
# write-path boundary (delta merge, fold trigger, fold completion)
_TIGHT = dict(rebuild_frac=0.1, delta_cap=24, fold_step_keys=48,
              fold_work_factor=4.0)


def _mk(shards, keys, pv, *, flow=False, cfg=None):
    nfl = NFL(NFLConfig(backend="flat", shards=shards, force_flow=flow,
                        flat_index=cfg or FlatAFLIConfig(),
                        flow_train=FlowTrainConfig(epochs=1)), device="cpu")
    nfl.bulkload(keys, pv)
    return nfl


def _keyset(seed, n=4000):
    rng = np.random.default_rng(seed)
    keys = np.unique(np.concatenate([
        rng.normal(0.0, 1e6, n // 2),
        rng.lognormal(10.0, 2.0, n - n // 2),
    ]))
    return keys, np.arange(len(keys), dtype=np.int64)


# --------------------------------------------------------------- router unit
def test_route_and_boundaries_partition_domain():
    keys = np.sort(np.random.default_rng(0).normal(0, 1, 999)
                   .astype(np.float32))
    b = choose_boundaries(keys, 4)
    assert b.shape == (3,) and np.all(np.diff(b) >= 0)
    sids = route(keys, b)
    assert sids.min() == 0 and sids.max() == 3
    assert np.all(np.diff(sids) >= 0)
    assert np.array_equal(sids, np.searchsorted(b, keys, side="right"))
    order, counts, inv = bin_by_shard(sids, 4)
    assert counts.sum() == len(keys)
    assert np.array_equal(np.sort(keys[order])[inv], keys)


def test_split_ranges_tiles_interval():
    b = np.array([0.0, 10.0, 20.0], np.float32)
    zlo = np.array([-5.0, 5.0, 12.0, 25.0, 7.0, 10.0], np.float32)
    zhi = np.array([25.0, 5.0, 9.0, 30.0, 10.0, 20.0], np.float32)
    qid, sid, sub_lo, sub_hi = split_ranges(zlo, zhi, b)
    assert np.array_equal(qid, [0, 0, 0, 0, 3, 4, 5])
    assert np.array_equal(sid, [0, 1, 2, 3, 3, 1, 2])
    for q in (0, 3, 4, 5):
        m = qid == q
        assert sub_lo[m][0] == zlo[q] and sub_hi[m][-1] == zhi[q]
        assert np.all(sub_lo[m][1:] == sub_hi[m][:-1])


@pytest.mark.parametrize("n_shards", [1, 2, 4, 7, 300])
def test_shard_helpers_match_jax(n_shards):
    """choose_boundaries, route, bin_by_shard, fanout_plan, split_ranges
    and refresh_boundaries equal the JAX package's on seeded inputs,
    duplicates and boundary hits included."""
    rng = np.random.default_rng(n_shards)
    pk = np.sort(np.concatenate([rng.normal(0, 1e3, 5000),
                                 np.full(700, 12.5)]).astype(np.float32))
    b = choose_boundaries(pk, n_shards)
    assert np.array_equal(b, jsd.choose_boundaries(pk, n_shards))
    q = np.concatenate([rng.permutation(pk), b, [-np.inf, np.inf]]
                       ).astype(np.float32)
    sids = route(q, b)
    assert np.array_equal(sids, jsd.route(q, b))
    for got, want in zip(bin_by_shard(sids, n_shards),
                         jsd.bin_by_shard(sids, n_shards)):
        assert np.array_equal(got, want)
    segs, inv = fanout_plan(sids, n_shards)
    jsegs, jinv = jsd.fanout_plan(sids, n_shards)
    assert np.array_equal(inv, jinv)
    assert all(np.array_equal(x, y) for x, y in zip(segs, jsegs))
    lo = rng.choice(q[np.isfinite(q)], 3000)
    hi = lo + rng.uniform(-50, 4000, 3000).astype(np.float32)
    for got, want in zip(split_ranges(lo, hi, b),
                         jsd.split_ranges(lo, hi, b)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    if b.shape[0] >= 3:
        interior = np.sort(rng.uniform(b[0], b[2], 1)).astype(np.float32)
        assert np.array_equal(refresh_boundaries(b, interior, 1),
                              jsd.refresh_boundaries(b, interior, 1))
        with pytest.raises(ValueError):
            refresh_boundaries(b, np.array([b[-1] + 1], np.float32), 0)


def test_route_flow_bins_the_nf_z():
    """``route_flow`` gives the plain NF's z bit for bit and bins it as
    the host ``route`` does."""
    keys, pv = _keyset(20)
    nfl = _mk(4, keys, pv, flow=True)
    feats = nfl._feats(keys)
    z, sid = route_flow(feats, nfl._packed_w, nfl._shapes,
                        nfl.index._boundaries_dev, torch.device("cpu"))
    want = nf_forward_plain(torch.from_numpy(feats), nfl._packed_w,
                            nfl._shapes, 2).numpy()
    assert np.array_equal(z.view(np.int32), want.view(np.int32))
    assert np.array_equal(sid, route(z, nfl.index.boundaries))
    z1, sid1 = route_flow(feats[:5], nfl._packed_w, nfl._shapes, None,
                          torch.device("cpu"))
    assert np.array_equal(z1, z[:5]) and not sid1.any()


def test_shard_mesh_devices(monkeypatch):
    assert shard_mesh(3, "cpu") == [torch.device("cpu")] * 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        shard_mesh(4)
    with pytest.raises(RuntimeError):
        shard_mesh(4, "cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NFL(NFLConfig(backend="flat", shards=4))


# ----------------------------------------------------- oracle interleavings
def _interleave(nfl, keys, pv, seed, n_ops=100, scan_cap=512):
    """Random mixed op batches vs a dict oracle; checks every step.  A
    range spans at most 40 live keys, so ``scan_cap`` 512 leaves room for
    the superseded copies and tombstones among its candidates (the JAX
    test's 4,096 costs the plain CPU scan eight times as much); a
    truncated range fails the exact check."""
    rng = np.random.default_rng(seed)
    oracle = dict(zip(keys.tolist(), pv.tolist()))
    fresh = 10_000_000
    for step in range(n_ops):
        op = rng.choice(["insert", "reinsert", "lookup", "delete", "range"],
                        p=[0.3, 0.15, 0.25, 0.15, 0.15])
        size = int(rng.integers(8, 48))
        if op == "insert":
            k = np.unique(rng.normal(0, 1e6, size))
            k = k[~np.isin(k, keys)]
            if not k.shape[0]:
                continue
            v = np.arange(fresh, fresh + k.shape[0])
            fresh += k.shape[0]
            nfl.insert_batch(k, v)
            oracle.update(zip(k.tolist(), v.tolist()))
        elif op == "reinsert":
            live = np.array(sorted(oracle))
            k = rng.choice(live, min(size, len(live)), replace=False)
            v = np.arange(fresh, fresh + k.shape[0])
            fresh += k.shape[0]
            nfl.insert_batch(k, v)
            oracle.update(zip(k.tolist(), v.tolist()))
        elif op == "delete":
            live = np.array(sorted(oracle))
            k = rng.choice(live, min(size, len(live)), replace=False)
            assert nfl.delete_batch(k).all(), f"step {step}: delete refused"
            for kk in k.tolist():
                del oracle[kk]
            assert not nfl.delete_batch(k).any()
        elif op == "lookup":
            live = np.array(sorted(oracle))
            k = rng.choice(live, min(size, len(live)), replace=False)
            res = nfl.lookup_batch(np.concatenate([k, k + 0.1234]))
            expect = np.array([oracle[kk] for kk in k.tolist()])
            wrong = int((res[:k.shape[0]] != expect).sum())
            assert wrong == 0, f"step {step}: {wrong} wrong lookups"
            assert (res[k.shape[0]:] == -1).all(), f"step {step}: ghost hit"
        else:
            live = np.array(sorted(oracle))
            i = int(rng.integers(0, max(len(live) - 40, 1)))
            span = int(rng.integers(1, 40))
            lo, hi = live[i], live[min(i + span, len(live) - 1)]
            pvs, cnt, _tot = nfl.scan_batch([lo], [hi], cap=scan_cap)
            if not nfl.use_flow:
                lo32, hi32 = np.float32(lo), np.float32(hi)
                exp = [oracle[kk] for kk in live
                       if lo32 <= np.float32(kk) < hi32]
                assert sorted(pvs[0, :cnt[0]].tolist()) == sorted(exp), \
                    f"step {step}: range mismatch"
    return oracle


def test_sharded_oracle_no_flow():
    keys, pv = _keyset(0)
    nfl = _mk(3, keys, pv, cfg=FlatAFLIConfig(**_TIGHT))
    _interleave(nfl, keys, pv, seed=1)
    assert nfl.stats()["n_rebuilds"] >= 1, "tight tiers never folded"
    r = nfl.index._router
    assert r["point_queries"] > 0 and r["write_keys"] > 0
    assert sum(r["per_shard_points"]) == r["point_queries"]


def test_sharded_oracle_flow():
    keys, pv = _keyset(1)
    nfl = _mk(4, keys, pv, flow=True, cfg=FlatAFLIConfig(**_TIGHT))
    assert nfl.use_flow
    _interleave(nfl, keys, pv, seed=2)
    assert nfl.stats()["n_rebuilds"] >= 1


# ----------------------------------------------------- single-index parity
def _apply_ops(nfl, keys, seed):
    rng = np.random.default_rng(seed)
    new = np.unique(rng.normal(0, 1e6, 600))
    new = new[~np.isin(new, keys)]
    nfl.insert_batch(new, np.arange(len(new)) + 10_000_000)
    dels = rng.choice(keys, 200, replace=False)
    assert nfl.delete_batch(dels).all()
    upds = rng.choice(np.setdiff1d(keys, dels), 100, replace=False)
    assert nfl.update_batch(upds, np.arange(100) + 20_000_000).all()


@pytest.mark.parametrize("flow", [False, True])
def test_sharded_matches_single_index(flow):
    keys, pv = _keyset(2, 2000)
    sharded = _mk(4, keys, pv, flow=flow)
    single = _mk(1, keys, pv, flow=flow)
    assert isinstance(sharded.index, ShardedFlatAFLI)
    assert not isinstance(single.index, ShardedFlatAFLI)
    _apply_ops(sharded, keys, seed=3)
    _apply_ops(single, keys, seed=3)
    probe = np.concatenate([keys[::5], keys[::7] + 0.5])
    assert np.array_equal(sharded.lookup_batch(probe),
                          single.lookup_batch(probe))
    cap = len(keys) + 1024
    mid = (keys[:-1] + keys[1:]) / 2
    sel = np.arange(0, len(mid) - 400, 97)
    p1, c1, t1 = sharded.scan_batch(mid[sel], mid[sel + 399], cap=cap)
    p2, c2, t2 = single.scan_batch(mid[sel], mid[sel + 399], cap=cap)
    assert (t1 <= cap).all() and (t2 <= cap).all()
    assert np.array_equal(c1, c2)
    assert (t1 >= c1).all() and (t2 >= c2).all()
    for i in range(len(sel)):
        assert np.array_equal(p1[i, :c1[i]], p2[i, :c2[i]])


# ------------------------------------------------- boundary-straddling ranges
def test_boundary_straddling_ranges():
    keys, pv = _keyset(3)
    nfl = _mk(4, keys, pv)
    idx = nfl.index
    B = idx.boundaries
    assert B.shape == (3,)
    oracle = dict(zip(keys.tolist(), pv.tolist()))
    live = np.array(sorted(oracle))
    los = np.array([B[0] - 1e3, B[0] - 1e5, live[0], B[1], B[0] - 1.0],
                   np.float64)
    his = np.array([B[0] + 1e3, B[2] + 1e5, live[-1], B[2], B[0]],
                   np.float64)
    pvs, cnt, _tot = nfl.scan_batch(los, his, cap=len(keys) + 1)
    for i in range(len(los)):
        lo32, hi32 = np.float32(los[i]), np.float32(his[i])
        exp = [oracle[k] for k in live if lo32 <= np.float32(k) < hi32]
        assert pvs[i, :cnt[i]].tolist() == exp, f"range {i} mismatch"
    assert idx._router["straddling_ranges"] >= 3
    single = _mk(1, keys, pv)
    p2, c2, _ = single.scan_batch(los, his, cap=len(keys) + 1)
    assert np.array_equal(cnt, c2)
    for i in range(len(los)):
        assert np.array_equal(pvs[i, :cnt[i]], p2[i, :c2[i]])


def test_truncated_straddling_range_stays_gapless():
    """A cap-truncated straddling range emits a prefix of the global
    order with no gap (later shards drop once an earlier sub-range
    truncates), and totals still count every candidate."""
    keys, pv = _keyset(4)
    nfl = _mk(4, keys, pv)
    cap = 100
    pvs, cnt, tot = nfl.scan_batch([keys[10]], [keys[-10]], cap=cap)
    assert tot[0] > cap and cnt[0] <= cap
    assert np.array_equal(pvs[0, :cnt[0]], pv[10:10 + cnt[0]])


# ------------------------------------------------------- busy-shard folds
def test_fold_on_busy_shard_while_others_serve():
    keys, pv = _keyset(5)
    nfl = _mk(3, keys, pv, cfg=FlatAFLIConfig(**_TIGHT))
    idx = nfl.index
    B = idx.boundaries
    oracle = dict(zip(keys.tolist(), pv.tolist()))
    rng = np.random.default_rng(9)
    lo1, hi1 = float(B[0]), float(B[1])
    fresh = 30_000_000
    rebuilds0 = [s["n_rebuilds"] for s in idx.stats()["shards"]]
    for step in range(30):
        k = np.unique(rng.uniform(lo1 + 1e-3 * (hi1 - lo1),
                                  hi1 - 1e-3 * (hi1 - lo1), 40))
        k = k[~np.isin(k, sorted(oracle))]
        v = np.arange(fresh, fresh + k.shape[0])
        fresh += k.shape[0]
        nfl.insert_batch(k, v)
        oracle.update(zip(k.tolist(), v.tolist()))
        q = rng.choice(np.array(sorted(oracle)), 64, replace=False)
        expect = np.array([oracle[kk] for kk in q.tolist()])
        assert (nfl.lookup_batch(q) == expect).all(), \
            f"step {step}: wrong mid-fold read"
    rebuilds1 = [s["n_rebuilds"] for s in idx.stats()["shards"]]
    assert rebuilds1[1] > rebuilds0[1], "busy shard never folded"
    assert rebuilds1[0] == rebuilds0[0] and rebuilds1[2] == rebuilds0[2]
    writes = idx._router["per_shard_writes"]
    assert writes[1] > 0 and writes[0] == 0 and writes[2] == 0


def test_skewed_traffic_single_shard():
    keys, pv = _keyset(6)
    nfl = _mk(4, keys, pv)
    idx = nfl.index
    in0 = keys[keys.astype(np.float32) < idx.boundaries[0]][:512]
    kmap = dict(zip(keys.tolist(), pv.tolist()))
    assert (nfl.lookup_batch(in0)
            == np.array([kmap[k] for k in in0.tolist()])).all()
    pts = idx._router["per_shard_points"]
    assert pts[0] == len(in0) and sum(pts[1:]) == 0


# -------------------------------------------------------- odds and ends
def test_empty_shard_serves():
    """Equal quantile boundaries leave a shard unbuilt: it answers
    misses through the pre-build path and buffers writes in its tiers."""
    dup = 1e6 + np.arange(200) * 1e-5       # one f32 key
    spread = np.linspace(2e6, 3e6, 100)
    keys = np.concatenate([dup, spread])
    pv = np.arange(len(keys), dtype=np.int64)
    nfl = _mk(6, keys, pv)
    idx = nfl.index
    empty = [s for s in idx.shards if s.arrays is None]
    assert empty, "keyset failed to produce an empty shard"
    assert (nfl.lookup_batch(keys) == pv).all()
    assert (nfl.lookup_batch(spread + 0.5) == -1).all()
    nfl.insert_batch(spread + 0.25, np.arange(100) + 1000)
    assert (nfl.lookup_batch(spread + 0.25) == np.arange(100) + 1000).all()
    # the unbuilt shards serve misses and scans through the empty tree
    for s in empty:
        assert (s.lookup_batch(keys[:8]) == -1).all()
        assert not s.scan_batch(keys[:4], keys[4:8])[1].any()


def test_per_shard_autoswitch_divergence():
    """Each shard records the AutoSwitch verdict for its own key range:
    an arithmetic grid (tail 1) and micro-clusters (the transform wins),
    positioned by the exact empirical CDF, split across two shards."""
    rng = np.random.default_rng(11)
    grid = np.arange(2000, dtype=np.float64) * 500.0
    centers = 1e9 * (1.0 + np.arange(16) / 8.0)
    clusters = np.unique(np.concatenate(
        [c * (1 + rng.uniform(0, 1e-4, 125)) for c in centers]))
    keys = np.unique(np.concatenate([grid, clusters]))
    pv = np.arange(keys.shape[0], dtype=np.int64)
    z = np.arange(keys.shape[0], dtype=np.float64) / keys.shape[0]
    idx = ShardedFlatAFLI(FlatAFLIConfig(), n_shards=2, device="cpu")
    idx.build(z, pv, ikeys=keys)
    sw = [s["autoswitch"] for s in idx.stats()["shards"]]
    for s in sw:
        assert set(s) == {"use_flow", "tail_original", "tail_transformed"}
    assert [s["use_flow"] for s in sw] == [False, True]
    assert sw[0]["tail_original"] == 1
    assert sw[1]["tail_transformed"] < sw[1]["tail_original"]
    jx = JSharded(jfa.FlatAFLIConfig(), n_shards=2)
    jx.build(z, pv, ikeys=keys)
    assert sw == [t["autoswitch"] for t in jx.serving_telemetry()["shards"]]
    assert (idx.lookup_batch(z[::3], ikeys=keys[::3]) == pv[::3]).all()


def test_stats_aggregation_and_unported_parts():
    """stats() and the telemetry aggregate the shards' blocks; the parts
    that were not ported until A11b (the load gauges, the re-key's and
    the migration's fields) read as ported."""
    keys, pv = _keyset(7)
    nfl = _mk(2, keys, pv)
    nfl.lookup_batch(keys[:256])
    nfl.scan_batch([keys[0]], [keys[100]])
    st = nfl.stats()
    assert len(st["shards"]) == 2 and st["n_keys"] == keys.shape[0]
    per = [t["serving"] for t in st["shards"]]
    gauges = {"run_capacity", "delta_capacity", "scan_capacity",
              "run_window", "delta_window", "scan_window"}
    for k, v in st["serving"].items():
        assert v == (max if k in gauges else sum)(t[k] for t in per), k
    assert st["router"]["point_batches"] == 1
    assert st["router"]["range_batches"] == 1
    ds = nfl.dispatch_stats()
    assert ds["rebuilds"] == 0 and ds["shadowed"] == st["n_shadowed"] == 0
    # the telemetry aggregates as stats() does (gauges the largest shard's)
    tel = nfl.index.serving_telemetry()
    assert tel["router"] == st["router"] and len(tel["shards"]) == 2
    for k in gauges:
        assert tel["serving"][k] == st["serving"][k], k
    sig = ds["drift"]["signals"]
    assert len(sig["shards"]) == 2 and not sig["reflow_active"]
    assert sig["n_reflows"] == sig["n_reshards"] == 0
    assert sig["run_len"] == st["run_len"]
    # the load gauges: the bulk load's verify and the 256 reads are read
    # load, the scan's sub-ranges too; no writes yet
    load = nfl.index.load_snapshot()
    assert st["load"] == load and load["writes"] == [0.0, 0.0]
    assert sum(load["reads"]) > 0
    assert [t["load"] for t in tel["shards"]] == [
        {"reads": r, "writes": w} for r, w in zip(load["reads"],
                                                  load["writes"])]
    assert not (st["reflow_active"] or st["reshard_active"])
    assert st["n_reflows"] == st["n_reshards"] == st["n_reshard_aborts"] == 0
    nfl.index.reset_telemetry()
    assert nfl.index.stats()["router"]["point_batches"] == 0
    # the gauges are state: the reset leaves them
    assert nfl.index.load_snapshot() == load
    # a migration in flight shows in stats() and the drift signals
    assert nfl.index.start_reshard(0, 1, lambda: None)
    sig = nfl.dispatch_stats()["drift"]["signals"]
    assert nfl.index.stats()["reshard_active"] and sig["reshard_active"]
    nfl.index.rebuild()
    sig = nfl.dispatch_stats()["drift"]["signals"]
    assert not sig["reshard_active"] and sig["n_reshards"] == 1


# ----------------------------------------------------------- async reads
@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("flow", [False, True])
def test_async_batches_read_their_dispatch_state(shards, flow):
    """Two batches in flight with writes issued between their dispatch
    and their finish: each reads the state it was dispatched into."""
    keys, pv = _keyset(8)
    nfl = _mk(shards, keys, pv, flow=flow)
    rng = np.random.default_rng(12)
    q = rng.choice(keys, 600, replace=False)
    new = np.unique(rng.normal(0, 1e6, 200))
    new = new[~np.isin(new, keys)]
    q = np.concatenate([q, new])
    before = np.concatenate([pv[np.searchsorted(keys, q[:600])],
                             np.full(new.shape[0], -1)])
    f1 = nfl.lookup_batch_async(q)
    assert nfl.update_batch(q[:200], np.arange(200) + 5_000_000).all()
    assert nfl.delete_batch(q[200:400]).all()
    nfl.insert_batch(new, np.arange(new.shape[0]) + 6_000_000)
    f2 = nfl.lookup_batch_async(q)
    after = before.copy()
    after[:200] = np.arange(200) + 5_000_000
    after[200:400] = -1
    after[600:] = np.arange(new.shape[0]) + 6_000_000
    assert np.array_equal(f2(), after)
    assert np.array_equal(f1(), before)
    assert np.array_equal(nfl.lookup_batch(q), after)


# ------------------------------------------------------ against the JAX side
@pytest.mark.parametrize("positioning", ["keys", "z"])
def test_shard_pools_match_jax(positioning):
    """Given the same positioning keys (the keys themselves, or one
    precomputed z with the keys as identities), every shard's pools are
    the JAX shard's bit for bit; points and untruncated scans agree, and
    both hold to the oracle after the same writes."""
    keys, pv = _keyset(13, 3000)
    ik = None
    pk = keys
    if positioning == "z":
        # a monotone stand-in for a flow's z (the packages' NFs may round
        # apart, ROADMAP C): both build from these exact values
        ik = keys
        pk = np.tanh(keys / 3e6) * 2.0 + 1e-3 * np.log1p(np.abs(keys))
    port = ShardedFlatAFLI(FlatAFLIConfig(), n_shards=4, device="cpu")
    port.build(pk, pv, ikeys=ik)
    jx = JSharded(jfa.FlatAFLIConfig(), n_shards=4)
    jx.build(pk, pv, ikeys=ik)
    assert np.array_equal(port.boundaries, jx.boundaries)
    shadows = []
    for t, j in zip(port.shards, jx.shards):
        assert t.d_tail == j.d_tail and t.max_depth == j.max_depth
        for field, x, y in zip(j.arrays._fields, j.arrays, t.arrays):
            assert np.array_equal(np.asarray(x), y), field
        # the JAX package keeps no count: its shadows are the built run
        shadows.append((t.n_shadowed, int(j._run_pk.shape[0])))
    print("shadowed (port, jax) per shard:", shadows)
    assert all(p == 0 for p, _j in shadows)
    ikk = keys if ik is not None else None
    # hits, and misses by identity (present positioning keys, absent ids)
    q_id = np.concatenate([keys[::3], keys[1::3] + 0.5])
    q_pk = q_id if ik is None else np.concatenate([pk[::3], pk[1::3]])
    q_ik = None if ik is None else q_id
    got = port.lookup_batch(q_pk, q_ik)
    assert np.array_equal(got, jx.lookup_batch(q_pk, q_ik))
    n_hit = keys[::3].shape[0]
    assert np.array_equal(got[:n_hit], pv[::3]) and (got[n_hit:] == -1).all()
    # the same writes on both, then both against the oracle
    rng = np.random.default_rng(14)
    dels = rng.choice(np.arange(len(keys)), 100, replace=False)
    for side in (port, jx):
        side.delete_batch(pk[dels], ikeys=None if ikk is None
                          else ikk[dels])
        side.insert_batch(pk[dels[:50]], pv[dels[:50]] + 10 ** 6,
                          ikeys=None if ikk is None else ikk[dels[:50]])
    want = pv.copy()
    want[dels] = -1
    want[dels[:50]] = pv[dels[:50]] + 10 ** 6
    for side in (port, jx):
        assert np.array_equal(side.lookup_batch(pk, ikk), want)
    order = np.argsort(pk.astype(np.float32), kind="stable")
    spk = pk[order]
    lo = spk[rng.integers(0, len(spk) - 60, 300)]
    hi = spk[np.minimum(np.searchsorted(spk, lo) + 50, len(spk) - 1)]
    p1, c1, t1 = port.scan_batch(lo, hi, cap=256)
    p2, c2, t2 = jx.scan_batch(lo, hi, cap=256)
    assert (t1 <= 256).all() and np.array_equal(c1, c2)
    for i in range(lo.shape[0]):
        assert np.array_equal(p1[i, :c1[i]], p2[i, :c2[i]])
    assert port._router["straddling_ranges"] \
        == jx._router["straddling_ranges"] > 0


def test_sharded_nfl_flow_on_matches_jax_and_oracle(monkeypatch):
    """One flow for both packages (trained by the JAX package): sharded
    NFLs, flow forced on, the same writes; each package against the
    oracle first, then the two against each other."""
    keys, pv = _keyset(15, 3000)
    params, norm, metrics = j_nfl.train_flow(
        keys, j_nfl.FlowConfig(), j_nfl.FlowTrainConfig(epochs=1))
    t_params = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    monkeypatch.setattr(j_nfl, "train_flow",
                        lambda *a, **k: (params, norm, metrics))
    monkeypatch.setattr(t_nfl, "train_flow",
                        lambda *a, **k: (t_params, norm, dict(metrics)))
    jx = j_nfl.NFL(j_nfl.NFLConfig(backend="flat", shards=4,
                                   force_flow=True))
    jx.bulkload(keys, pv)
    pt = _mk(4, keys, pv, flow=True)
    rng = np.random.default_rng(16)
    new = np.unique(rng.normal(0, 1e6, 300))
    new = new[~np.isin(new, keys)]
    dels = rng.choice(keys, 150, replace=False)
    oracle = dict(zip(keys.tolist(), pv.tolist()))
    for side in (jx, pt):
        side.insert_batch(new, np.arange(new.shape[0]) + 10 ** 7)
        assert side.delete_batch(dels).all()
    oracle.update(zip(new.tolist(), (np.arange(new.shape[0])
                                     + 10 ** 7).tolist()))
    for k in dels.tolist():
        del oracle[k]
    probe = np.concatenate([keys, new, keys[:100] + 0.37])
    want = np.array([oracle.get(k, -1) for k in probe.tolist()])
    got = {name: side.lookup_batch(probe) for name, side in
           (("jax", jx), ("port", pt))}
    assert np.array_equal(got["port"], want)
    assert np.array_equal(got["jax"], want)
    assert np.array_equal(got["port"], got["jax"])
    assert pt.metrics["serve_verify_shadowed"] == 0
