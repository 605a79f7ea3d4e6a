"""repro_torch FlatAFLI against the JAX package: the builder's pools bit
for bit, the fused lookup's plain version against the JAX oracle and the
Pallas kernel (interpret mode) on the same pools and write tiers, and
whole builds against ground truth.  Data is made with numpy and passed
between the packages as numpy."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import flat_afli as jfa
from repro.data.datasets import make_dataset as j_make_dataset
from repro.kernels.fused_lookup import TierPools as JTierPools
from repro.kernels.fused_lookup import fused_lookup_pallas

from repro_torch.core import flat_afli as tfa
from repro_torch.core.serving_state import DeviceTier
from repro_torch.data.datasets import make_dataset
from repro_torch.kernels.fused_lookup import (TOMBSTONE, TierPack, TierPools,
                                              fused_lookup_plain)

torch.set_num_threads(1)


def _sorted_build_input(keys):
    order = np.argsort(keys.astype(np.float32), kind="stable")
    hi, lo = jfa.split_key_bits(keys[order])
    return keys[order].astype(np.float32), hi, lo, order.astype(np.int64)


def _colliding_keys(n):
    """lognormal keys plus a run of f32-colliding identities (dense
    nodes, buckets and duplicate windows)."""
    keys = make_dataset("lognormal", n)
    return np.unique(np.concatenate([keys, 1e15 + np.arange(40.0),
                                     2e15 + 2.0 * np.arange(5.0)]))


@pytest.mark.parametrize("name,n", [("lognormal", 60000), ("longlat", 30000),
                                    ("longitudes", 20000)])
@pytest.mark.parametrize("d_tail", [2, 4, 6])
def test_builder_pools_bitwise(name, n, d_tail):
    keys = make_dataset(name, n)
    assert np.array_equal(keys, j_make_dataset(name, n))
    pk, hi, lo, pv = _sorted_build_input(keys)
    jb = jfa._Builder(jfa.FlatAFLIConfig(), d_tail)
    jb.build(pk, hi, lo, pv)
    ja = jb.finalize()
    tb = tfa._Builder(tfa.FlatAFLIConfig(), d_tail)
    tb.build(pk, hi, lo, pv)
    ta = tb.finalize()
    assert tb.max_depth == jb.max_depth
    for field, x, y in zip(ja._fields, ja, ta):
        x = np.asarray(x)
        assert x.dtype == y.dtype, field
        assert np.array_equal(x, y), field
    # the JAX pools are zero-padded to power-of-two buckets; the port's
    # are the exact prefix
    jp = ja.to_kernel_args(bucketed=True)
    tp = ta.to_kernel_args("cpu")
    for field, x, y, a in zip(jp._fields, jp, tp, ta):
        x = np.asarray(x)
        y = y.numpy()
        if x.dtype == np.uint32:
            y = y.view(np.uint32)
        n = np.asarray(a).shape[0]
        assert y.shape[0] == n, field
        assert x.dtype == y.dtype and np.array_equal(x[:n], y), field
        assert not x[n:].any(), field


def test_builder_pools_bitwise_with_collisions():
    keys = _colliding_keys(5000)
    pk, hi, lo, pv = _sorted_build_input(keys)
    for max_depth in (16, 2):
        jb = jfa._Builder(jfa.FlatAFLIConfig(max_depth=max_depth), 3)
        jb.build(pk, hi, lo, pv)
        tb = tfa._Builder(tfa.FlatAFLIConfig(max_depth=max_depth), 3)
        tb.build(pk, hi, lo, pv)
        assert tb.max_depth == jb.max_depth
        for x, y in zip(jb.finalize(), tb.finalize()):
            assert np.array_equal(np.asarray(x), y)


def _tiers(keys, pk32):
    """Hand-made run and delta tiers over a built key set: overrides,
    TOMBSTONEs, re-inserts, identities sharing one positioning key, an
    entry stored 1 ulp below its query's positioning key, fresh keys."""
    f32 = np.float32
    shared = f32(keys[70])
    run = [  # (positioning key, identity key, payload), oldest first
        (pk32[10], keys[10], 9000),
        (pk32[20], keys[20], 9001),
        (pk32[30], keys[30], TOMBSTONE),
        (f32(keys[40] * (1 + 1e-12)), keys[40] * (1 + 1e-12), 9002),
        (np.nextafter(f32(keys[60]), f32(-np.inf)), keys[60], 9003),
        (shared, keys[70] * (1 + 2e-12), 9004),
        (shared, keys[70] * (1 + 3e-12), 9005),
        (shared, keys[70] * (1 + 4e-12), 9006),
        (f32(keys[-1] * 3), keys[-1] * 3, 9007),
    ]
    delta = [
        (pk32[10], keys[10], 9100),
        (pk32[20], keys[20], TOMBSTONE),
        (pk32[30], keys[30], 9200),
        (shared, keys[70] * (1 + 3e-12), 9201),
        (f32(keys[-1] * 5), keys[-1] * 5, 9202),
    ]

    def sort(entries):
        pk = np.array([e[0] for e in entries], np.float32)
        hi, lo = jfa.split_key_bits(np.array([e[1] for e in entries]))
        pv = np.array([e[2] for e in entries], np.int32)
        return jfa._dedup_newest(pk, hi, lo, pv)

    return sort(run), sort(delta)


def test_fused_lookup_plain_matches_oracle_and_pallas():
    keys = _colliding_keys(3000)
    pk, hi, lo, pv = _sorted_build_input(keys)
    jb = jfa._Builder(jfa.FlatAFLIConfig(), 4)
    jb.build(pk, hi, lo, pv)
    arrays = jb.finalize()
    tb = tfa._Builder(tfa.FlatAFLIConfig(), 4)
    tb.build(pk, hi, lo, pv)
    t_pools = tb.finalize().to_kernel_args("cpu")
    max_depth = jfa._depth_round(jb.max_depth + 1)
    dense_window = jfa._window_round(jfa._max_equal_run(pk) + 2)
    skeys = keys[np.argsort(keys.astype(np.float32), kind="stable")]
    run, delta = _tiers(skeys, pk)
    (rj, r_iters, r_win) = jfa._pack_tier(*run)
    (dj, d_iters, d_win) = jfa._pack_tier(*delta)
    j_tiers = JTierPools(*rj, *dj)

    def port_tier(arrs):
        ppk, phi, plo, ppv, plen = (np.array(a) for a in arrs)
        return [torch.from_numpy(ppk), torch.from_numpy(phi.view(np.int32)),
                torch.from_numpy(plo.view(np.int32)), torch.from_numpy(ppv),
                torch.tensor([plen[0]], dtype=torch.int32)]

    t_tiers = TierPack(TierPools(*port_tier(rj), *port_tier(dj)),
                       r_iters, r_win, d_iters, d_win)

    # queries: every built key (positioning key = its f32), the tier
    # identities at their own positioning keys, and misses
    q_id = np.concatenate([skeys, [skeys[40] * (1 + 1e-12),
                                   skeys[70] * (1 + 2e-12),
                                   skeys[70] * (1 + 3e-12),
                                   skeys[70] * (1 + 4e-12),
                                   skeys[-1] * 3, skeys[-1] * 5,
                                   skeys[-1] * 7],
                           skeys[:200] * (1 + 1e-9) + 0.5])
    q_pk = q_id.astype(np.float32)
    qhi, qlo = jfa.split_key_bits(q_id)
    kw = dict(max_depth=max_depth, dense_iters=24, bucket_cap=6,
              dense_window=dense_window)

    pay_pallas, z_pallas = fused_lookup_pallas(
        jnp.asarray(q_pk.reshape(-1, 1)), jnp.asarray(qhi), jnp.asarray(qlo),
        jnp.zeros((1, 1), jnp.float32), arrays.to_kernel_args(bucketed=True),
        j_tiers, dim=1, use_flow=False, interpret=True, probe_tiers=True,
        run_iters=r_iters, run_window=r_win, delta_iters=d_iters,
        delta_window=d_win, **kw)
    res = np.asarray(jfa.flat_lookup(arrays, jnp.asarray(q_pk),
                                     jnp.asarray(qhi), jnp.asarray(qlo),
                                     **kw))
    run_pay = jfa._probe_sorted_pool(*run, q_pk, qhi, qlo)
    dl_pay = jfa._probe_sorted_pool(*delta, q_pk, qhi, qlo)
    oracle = np.where(dl_pay != -1, dl_pay,
                      np.where(run_pay != -1, run_pay, res))
    oracle = np.where(oracle == TOMBSTONE, -1, oracle)

    pay_port, z_port = fused_lookup_plain(
        torch.from_numpy(q_pk.reshape(-1, 1)),
        torch.from_numpy(qhi.view(np.int32)),
        torch.from_numpy(qlo.view(np.int32)), None, t_pools, t_tiers,
        dim=1, use_flow=False, **kw)
    pay_port = pay_port.numpy()
    assert np.array_equal(pay_port, oracle)
    assert np.array_equal(pay_port, np.asarray(pay_pallas))
    assert np.array_equal(z_port.numpy(), q_pk)

    # and against the ground truth the tiers describe
    truth = {float(k): int(p) for k, p in zip(skeys, pv)}
    truth[skeys[10]] = 9100
    truth[skeys[20]] = -1
    truth[skeys[30]] = 9200
    truth[skeys[60]] = 9003
    expect = np.array([truth.get(float(k), -1) for k in q_id])
    expect[len(skeys):len(skeys) + 6] = [9002, 9004, 9201, 9006, 9007, 9202]
    assert np.array_equal(pay_port, expect)


def test_build_matches_jax_and_ground_truth():
    """Whole builds on the same keys: tree pools bit-equal, every key
    found, misses -1.  The shadow sets are not compared: the JAX build
    verifies placement through XLA, which contracts the slot arithmetic
    into an FMA and shadows keys on rint boundaries, while the port's
    slot rounds like the builder's; both counts are reported."""
    keys = make_dataset("lognormal", 50000)
    pv = np.arange(keys.shape[0], dtype=np.int64)
    j = jfa.FlatAFLI()
    j.build(keys[::2], pv[::2])
    t = tfa.FlatAFLI(device="cpu")
    t.build(keys[::2], pv[::2])
    for field, x, y in zip(j.arrays._fields, j.arrays, t.arrays):
        assert np.array_equal(np.asarray(x), y), field
    assert t.max_depth == j.max_depth and t.d_tail == j.d_tail
    expect = np.where(pv % 2 == 0, pv, -1)
    assert np.array_equal(t.lookup_batch(keys), expect)
    assert np.array_equal(j.lookup_batch(keys), expect)
    print(f"shadowed: jax {j._run_pk.shape[0]}, port {t.n_shadowed}")
    assert t.n_shadowed == t.stats()["run_len"]


def test_flow_positioned_build_serves_ground_truth():
    from repro_torch.core.feature import expand_features
    from repro_torch.core.flow import FlowConfig
    from repro_torch.core.train_flow import FlowTrainConfig, train_flow
    from repro_torch.kernels import ops

    keys = make_dataset("longlat", 8000)
    pv = np.arange(keys.shape[0], dtype=np.int64)
    cfg = FlowConfig()
    params, norm, _ = train_flow(keys, cfg, FlowTrainConfig(epochs=1),
                                 device="cpu")
    z = ops.nf_transform_keys(params, norm, keys, cfg, device="cpu")
    packed, shapes = ops.pack_params(params, cfg)
    idx = tfa.FlatAFLI(device="cpu")
    idx.build(z[::2], pv[::2], ikeys=keys[::2])
    feats = expand_features(keys, norm, cfg.dim, cfg.theta, dtype=np.float32)
    assert idx.verify_serve_flow(feats[::2], keys[::2], packed, shapes,
                                 pv[::2]) == 0
    got = idx.lookup_batch_flow(feats, keys, packed, shapes)
    assert np.array_equal(got, np.where(pv % 2 == 0, pv, -1))
    assert idx.contains_batch(keys).tolist() == (pv % 2 == 0).tolist()


def test_shadowed_key_served_from_run_tier():
    """A key the tree cannot place is served from the run tier."""
    keys = make_dataset("lognormal", 4000)
    pv = np.arange(keys.shape[0], dtype=np.int64)
    idx = tfa.FlatAFLI(device="cpu")
    idx.build(keys, pv)
    extra = np.array([keys[-1] * 2.0])
    hi, lo = tfa.split_key_bits(extra)
    idx._append_run(extra.astype(np.float32), hi, lo, np.array([77]))
    assert idx.lookup_batch(extra).tolist() == [77]
    assert np.array_equal(idx.lookup_batch(keys), pv)
    assert idx.last_dispatch["tier_path"] == "kernel"


def test_device_tier_refresh_in_place_and_growth():
    t = DeviceTier(torch.device("cpu"))
    pk = np.sort(np.random.default_rng(0).uniform(0, 1, 100)).astype(np.float32)
    hi = np.arange(100, dtype=np.uint32) + np.uint32(2 ** 31)
    lo = np.arange(100, dtype=np.uint32)
    pv = np.arange(100, dtype=np.int32)
    t.refresh(pk, hi, lo, pv, 4)
    buf = t.pk
    assert t.capacity == 128 and t.repacks == 1 and int(t.plen[0]) == 100
    assert t.hi.numpy().view(np.uint32)[:100].tolist() == hi.tolist()
    t.refresh(pk[:10], hi[:10], lo[:10], pv[:10], 4)
    assert t.pk is buf and t.repacks == 1          # in place
    assert np.isinf(t.pk.numpy()[10:]).all() and (t.pv.numpy()[10:] == -1).all()
    big = np.sort(np.random.default_rng(1).uniform(0, 1, 300)).astype(np.float32)
    t.refresh(big, np.zeros(300, np.uint32), np.zeros(300, np.uint32),
              np.zeros(300, np.int32), 8)
    assert t.capacity == 512 and t.repacks == 2 and t.window == 8
    assert t.iters == 512 .bit_length()


@pytest.mark.parametrize("seed", range(3))
def test_split_key_bits_and_contains(seed):
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.uniform(-1e12, 1e12, 3000))
    hi, lo = tfa.split_key_bits(keys)
    jhi, jlo = jfa.split_key_bits(keys)
    assert np.array_equal(hi, jhi) and np.array_equal(lo, jlo)
    idx = tfa.FlatAFLI(device="cpu")
    idx.build(keys[::3], np.arange(keys[::3].shape[0]))
    inside = np.zeros(keys.shape[0], bool)
    inside[::3] = True
    assert np.array_equal(idx.contains_batch(keys), inside)
