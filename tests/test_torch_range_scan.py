"""repro_torch range scans against the JAX package, on the CPU.

``fused_range_scan_plain`` (the range kernel's plain version, which the
port's ``scan_batch`` runs on CPU tensors) is held to the JAX
``fused_range_scan_pallas`` in interpret mode on the same pools and
endpoints, and the port's ``scan_batch`` to the JAX host oracle
``FlatAFLI._range_scan_host`` after the same writes: ``pv``, ``cnt``,
``tot`` (and the kernel's ``zlo``/``zhi``) exactly equal.  Flow-on scans
are checked against a z-space ground truth.  Inputs are made with numpy
and passed between the packages as numpy."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import flat_afli as jfa
from repro.kernels.fused_lookup import TierPools as JTierPools
from repro.kernels.range_scan import ScanPool as JScanPool
from repro.kernels.range_scan import fused_range_scan_pallas

from repro_torch.core import flat_afli as tfa
from repro_torch.core.nfl import NFL, NFLConfig
from repro_torch.core.train_flow import FlowTrainConfig
from repro_torch.kernels import ops
from repro_torch.kernels.nf_forward import nf_forward_plain
from repro_torch.kernels.range_scan import fused_range_scan_plain

torch.set_num_threads(1)

# no fold unless asked, so both packages' tiers stay identical
_CFG = dict(rebuild_frac=10.0, delta_cap=16)


def _z32(keys):
    return np.asarray(keys, np.float64).astype(np.float32)


def _pair(keys=None, **cfg):
    cfg = {**_CFG, **cfg}
    jx = jfa.FlatAFLI(jfa.FlatAFLIConfig(**cfg))
    pt = tfa.FlatAFLI(tfa.FlatAFLIConfig(**cfg), device="cpu")
    if keys is not None:
        pv = np.arange(keys.shape[0], dtype=np.int64)
        jx.build(keys, pv)
        pt.build(keys, pv)
    return jx, pt


def _writes(rng, pair, keys, n_rounds=4):
    """The same inserts (new keys and re-inserts), updates and deletes
    on both indexes, leaving data and tombstones in the run and the
    delta."""
    for r in range(n_rounds):
        fresh = rng.choice(keys, 40, replace=False) + 0.25 + r
        again = rng.choice(keys, 20, replace=False)
        gone = rng.choice(keys, 15, replace=False)
        for idx in pair:
            idx.insert_batch(fresh, np.arange(40) + 10_000 * (r + 1))
            idx.insert_batch(again, np.arange(20) + 50_000 * (r + 1))
            idx.delete_batch(gone)


def _lane(n) -> jnp.ndarray:
    a = np.zeros(128, np.int32)
    a[0] = int(n.reshape(-1)[0])
    return jnp.asarray(a)


def _u32(t: torch.Tensor) -> jnp.ndarray:
    return jnp.asarray(t.numpy().view(np.uint32))


def _pallas_on_port_pools(pt, flo, fhi, cap):
    """The JAX kernel (interpret mode) on the port's scan pool and tiers,
    converted to JAX arrays."""
    sp = pt._serving.scan_pack()
    s = sp.pool
    pool = JScanPool(pk=jnp.asarray(s.pk.numpy()), hi=_u32(s.hi),
                     lo=_u32(s.lo), pv=jnp.asarray(s.pv.numpy()),
                     plen=_lane(s.plen))
    tp = pt._tier_pack()
    kw = {}
    tiers = None
    if tp is not None:
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
    out = fused_range_scan_pallas(
        jnp.asarray(flo), jnp.asarray(fhi), jnp.zeros((1, 1), jnp.float32),
        pool, tiers, dim=1, scan_cap=cap, scan_iters=sp.iters,
        use_flow=False, interpret=True, **kw)
    return [np.asarray(x) for x in out]


def _check_equal(jx, pt, lo, hi, cap):
    """Port scan_batch == JAX host oracle, and the port's plain kernel
    == the JAX kernel on the port's pools, all bit for bit."""
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    got = pt.scan_batch(lo, hi, cap=cap)
    want = jx._range_scan_host(_z32(lo), _z32(hi), cap)
    for name, g, w in zip(("pv", "cnt", "tot"), got, want):
        assert g.dtype == np.int32 and np.array_equal(g, w), name
    flo, fhi = _z32(lo).reshape(-1, 1), _z32(hi).reshape(-1, 1)
    plain = fused_range_scan_plain(
        torch.from_numpy(flo), torch.from_numpy(fhi), None,
        pt._serving.scan_pack(), pt._tier_pack(), dim=1, scan_cap=cap,
        use_flow=False)
    plain = [x.numpy() for x in plain]
    pallas = _pallas_on_port_pools(pt, flo, fhi, cap)
    for name, p, q in zip(("pv", "cnt", "tot", "zlo", "zhi"), plain,
                          pallas):
        assert p.dtype == q.dtype and np.array_equal(p, q), name
    for g, p in zip(got, plain):
        assert np.array_equal(g, p)
    return got


def _cases(keys, rng, n=24):
    lo = rng.choice(keys, n)
    return lo, lo + rng.uniform(1e3, 1e7, n)


def test_ranges_with_tiers_and_tombstones():
    rng = np.random.default_rng(0)
    keys = np.unique(rng.uniform(0, 1e9, 1500))
    jx, pt = _pair(keys)
    _writes(rng, (jx, pt), keys)
    st = pt.stats()
    assert st["run_len"] and st["delta_len"]
    lo, hi = _cases(keys, rng)
    pv, cnt, tot = _check_equal(jx, pt, lo, hi, cap=96)
    assert (tot > cnt).any()          # superseded copies and tombstones


def test_empty_and_inverted_ranges():
    rng = np.random.default_rng(1)
    keys = np.unique(rng.uniform(0, 1e9, 800))
    jx, pt = _pair(keys)
    _writes(rng, (jx, pt), keys, n_rounds=2)
    gap = (keys[10] + keys[11]) / 2
    lo = np.array([keys[5], keys[99], gap, keys[300], -1e12])
    hi = np.array([keys[5], keys[50], np.nextafter(keys[11], 0), keys[2],
                   -1e11])
    pv, cnt, tot = _check_equal(jx, pt, lo, hi, cap=32)
    assert (cnt == 0).all() and (tot == 0).all() and (pv == -1).all()


def test_ranges_across_node_boundaries():
    rng = np.random.default_rng(2)
    keys = np.unique(np.floor(rng.lognormal(0, 2, 3000) * 1e9))
    jx, pt = _pair(keys)
    assert pt.stats()["n_nodes"] > 1
    _writes(rng, (jx, pt), keys, n_rounds=2)
    lo = keys[rng.integers(0, keys.shape[0] - 300, 16)]
    hi = keys[np.searchsorted(keys, lo) + 250]
    _check_equal(jx, pt, lo, hi, cap=512)


def test_duplicate_f32_keys():
    """Distinct identities on one f32 key (1e15 + arange): a range
    straddling the collision run returns all of them, in the JAX order."""
    rng = np.random.default_rng(3)
    keys = np.unique(np.concatenate([rng.uniform(0, 1e9, 500),
                                     1e15 + np.arange(64.0)]))
    jx, pt = _pair(keys)
    for idx in (jx, pt):
        idx.insert_batch(1e15 + np.arange(64.0, 80.0), np.arange(16) + 900)
        idx.delete_batch(1e15 + np.arange(0.0, 64.0, 5.0))
        # colliding keys in the delta too: run and delta tie on one key
        idx.insert_batch(1e15 + np.arange(80.0, 84.0), np.arange(4) + 950)
    st = pt.stats()
    assert st["run_len"] and st["delta_len"] == 4
    pv, cnt, tot = _check_equal(jx, pt, [1e15 - 1e8, 1e15 - 1e8, 0.0],
                                [1e15 + 1e8, 1e15, 1e16], cap=128)
    assert cnt[0] == 84 - 13 and tot[0] == 84 + 13


def test_scan_cap_truncation_is_counted():
    rng = np.random.default_rng(4)
    keys = np.unique(rng.uniform(0, 1e9, 2000))
    jx, pt = _pair(keys)
    ops.reset_launch_counts()
    pv, cnt, tot = _check_equal(jx, pt, [keys[100], keys[10]],
                                [keys[400], keys[12]], cap=16)
    assert tot[0] == 300 and cnt[0] == 16
    assert np.array_equal(pv[0], np.arange(100, 116))
    assert tot[1] == 2 and cnt[1] == 2
    assert pt.last_scan_dispatch["truncated"] == 1
    # the wrapper counts truncations on every device; launches only on
    # the card
    assert ops.fused_range_scan.truncated == 1
    assert ops.launch_counts()["fused_range_scan"] == 0


def test_tombstones_before_and_after_a_fold():
    rng = np.random.default_rng(5)
    keys = np.unique(rng.uniform(0, 1e9, 1200))
    jx, pt = _pair(keys)
    _writes(rng, (jx, pt), keys)
    lo, hi = _cases(keys, rng)
    _check_equal(jx, pt, lo, hi, cap=128)
    for idx in (jx, pt):
        idx.rebuild()
    assert pt.n_rebuilds == 1 and pt.stats()["run_len"] == 0
    _check_equal(jx, pt, lo, hi, cap=128)
    _writes(rng, (jx, pt), keys, n_rounds=1)
    _check_equal(jx, pt, lo, hi, cap=128)


def test_scans_before_any_build_come_from_the_tiers():
    jx, pt = _pair()
    keys = np.array([10.0, 20.0, 30.0, 40.0, 50.0])
    for _ in range(5):
        keys = np.concatenate([keys, keys[-5:] + 50.0])
    for idx in (jx, pt):
        idx.insert_batch(keys, np.arange(keys.shape[0]))
        idx.delete_batch(np.array([30.0, 120.0]))
    assert pt.arrays is None and pt.stats()["run_len"]
    pv, cnt, tot = _check_equal(jx, pt, [15.0, 0.0], [45.0, 1e6], cap=64)
    assert np.array_equal(np.sort(pv[0, :cnt[0]]), [1, 3])
    want = jx.scan_batch(np.array([15.0, 0.0]), np.array([45.0, 1e6]),
                         cap=64)
    for g, w in zip((pv, cnt, tot), want):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("force_flow", [False, True])
def test_nfl_scans_match_z_space_ground_truth(force_flow):
    """NFL.scan_batch with the flow off and on: every untruncated range
    returns exactly the live payloads whose positioning key lies in
    [z(lo), z(hi)), as a multiset; lookup_range is the same call; the
    endpoint z the plain kernel computes is nf_forward's z bit for
    bit."""
    rng = np.random.default_rng(53 + int(force_flow))
    pool = np.unique(np.floor(rng.lognormal(0, 2, 1200) * 1e9))
    load, extra = pool[::2], pool[1::2]
    nfl = NFL(NFLConfig(backend="flat", force_flow=force_flow,
                        flow_train=FlowTrainConfig(epochs=1),
                        flat_index=tfa.FlatAFLIConfig(**_CFG)),
              device="cpu")
    nfl.bulkload(load, np.arange(load.shape[0]))
    nfl.insert_batch(extra[:200], np.arange(200) + 10_000)
    gone = load[::7]
    assert nfl.delete_batch(gone).all()
    nfl.insert_batch(extra[200:210], np.arange(10) + 20_000)
    st = nfl.stats()
    assert st["run_len"] and st["delta_len"]
    live = np.setdiff1d(np.concatenate([load, extra[:210]]), gone)
    pay = {**dict(zip(load, range(load.shape[0]))),
           **dict(zip(extra[:200], np.arange(200) + 10_000)),
           **dict(zip(extra[200:210], np.arange(10) + 20_000))}
    z = _z32(nfl._pkeys(live))
    order = np.argsort(z, kind="stable")
    zs, ps = z[order], np.array([pay[k] for k in live[order]])
    r = rng.integers(0, live.shape[0] - 101, 40)
    lo_k = live[order][r]
    hi_k = live[order][r + rng.integers(1, 100, 40)]
    pv, cnt, tot = nfl.scan_batch(lo_k, hi_k, cap=256)
    zlo, zhi = _z32(nfl._pkeys(lo_k)), _z32(nfl._pkeys(hi_k))
    assert (tot > cnt).any()          # superseded copies and tombstones
    for i in range(40):
        assert tot[i] <= 256
        want = np.sort(ps[np.searchsorted(zs, zlo[i]):
                          np.searchsorted(zs, zhi[i])])
        assert np.array_equal(np.sort(pv[i, :cnt[i]]), want), i
    again = nfl.lookup_range(lo_k, hi_k, cap=256)
    for x, y in zip((pv, cnt, tot), again):
        assert np.array_equal(x, y)
    if force_flow:
        f = torch.from_numpy(nfl._feats(lo_k))
        out = fused_range_scan_plain(
            f, torch.from_numpy(nfl._feats(hi_k)), nfl._packed_w,
            nfl.index._serving.scan_pack(), nfl.index._tier_pack(),
            dim=nfl.cfg.flow.dim, shapes=nfl._shapes, scan_cap=256)
        zf = nf_forward_plain(f, nfl._packed_w, nfl._shapes,
                              nfl.cfg.flow.dim)
        assert torch.equal(out[3].view(torch.int32), zf.view(torch.int32))
        assert np.array_equal(out[0].numpy(), pv)
