"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda``; without a card every test skips from the
``cuda`` fixture.  On the H100:

    python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core.feature import KeyNormalizer, expand_features
from repro_torch.core.flat_afli import FlatAFLI, FlatAFLIConfig, split_key_bits
from repro_torch.core.flow import FlowConfig, init_flow
from repro_torch.core.nfl import NFL, NFLConfig
from repro_torch.core.train_flow import FlowTrainConfig, FlowTrainer, train_flow
from repro_torch.data.datasets import make_dataset
from repro_torch.kernels import ops
from repro_torch.kernels.flash_decode import (DecodePlan, device_plan,
                                              flash_decode, flash_decode_plain)
from repro_torch.kernels.fused_lookup import fused_lookup, fused_lookup_plain
from repro_torch.kernels.index_probe import index_probe, index_probe_plain
from repro_torch.kernels.mamba_scan import mamba_scan, mamba_scan_plain
from repro_torch.kernels.nf_forward import nf_forward, nf_forward_plain
from repro_torch.kernels.range_scan import (fused_range_scan,
                                            fused_range_scan_plain)
from repro_torch.kernels.streamed_lookup import (StreamPack, streamed_lookup,
                                                 streamed_lookup_plain)

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    return torch.device("cuda")


def _flow(dim, hidden, layers, seed, dev):
    cfg = FlowConfig(dim=dim, hidden=hidden, layers=layers)
    params = init_flow(torch.Generator().manual_seed(seed), cfg, dev)
    g = torch.Generator().manual_seed(seed + 1)
    params["out_log_scale"] = torch.randn(dim, generator=g).to(dev)
    params["feat_mu"] = torch.randn(dim, generator=g).to(dev)
    params["feat_sd"] = (torch.rand(dim, generator=g) + 0.5).to(dev)
    return cfg, params


@pytest.mark.parametrize("dim,hidden,layers", [(2, 2, 2), (3, 2, 2),
                                               (4, 3, 3), (8, 4, 2)])
def test_nf_forward_kernel_matches_plain(cuda, dim, hidden, layers):
    cfg, params = _flow(dim, hidden, layers, dim + 10 * layers, cuda)
    packed, shapes = ops.pack_params(params, cfg)
    feats = torch.randn(100_003, dim, generator=torch.Generator()
                        .manual_seed(1)).mul_(4).to(cuda)
    before = nf_forward.launches
    zk = nf_forward(feats, packed, shapes, dim)
    zp = nf_forward_plain(feats, packed, shapes, dim)
    torch.cuda.synchronize()
    assert nf_forward.launches == before + 1
    # same operation order and rounding; both call the card's tanhf
    assert torch.equal(zk.view(torch.int32), zp.view(torch.int32))


def _index(dev, flow: bool):
    keys = make_dataset("longlat" if flow else "lognormal", 40_000)
    pv = np.arange(keys.shape[0], dtype=np.int64)
    nfl = NFL(NFLConfig(backend="flat", force_flow=flow,
                        flow_train=FlowTrainConfig(epochs=1)), device=dev)
    nfl.bulkload(keys[::2], pv[::2])
    # a quarter of the keys ride in the run tier, under their serving
    # positioning keys
    extra = keys[1::4]
    pk = (ops.nf_transform_keys(nfl.flow_params, nfl.normalizer, extra,
                                nfl.cfg.flow, dev) if flow else extra)
    hi, lo = split_key_bits(extra)
    nfl.index._append_run(pk.astype(np.float32), hi, lo,
                          pv[1::4].astype(np.int32))
    return nfl, keys, pv


@pytest.mark.parametrize("flow", [True, False])
def test_fused_lookup_kernel_matches_plain(cuda, flow):
    nfl, keys, pv = _index(cuda, flow)
    idx = nfl.index
    if flow:
        feats = expand_features(keys, nfl.normalizer, 2, 1e3, dtype=np.float32)
    else:
        feats = keys.astype(np.float32).reshape(-1, 1)
    hi, lo = split_key_bits(keys)
    args = (torch.from_numpy(feats).to(cuda),
            torch.from_numpy(hi.view(np.int32)).to(cuda),
            torch.from_numpy(lo.view(np.int32)).to(cuda), nfl._packed_w,
            idx._kernel_pools(), idx._tier_pack())
    kw = dict(dim=feats.shape[1] if flow else 2, shapes=nfl._shapes,
              max_depth=idx.max_depth, dense_iters=24, bucket_cap=6,
              dense_window=idx.dense_window, use_flow=flow)
    pk, zk = fused_lookup(*args, **kw)
    pp, zp = fused_lookup_plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(pk, pp)
    assert torch.equal(zk.view(torch.int32), zp.view(torch.int32))
    expect = np.where((pv % 2 == 0) | (pv % 4 == 1), pv, -1)
    assert np.array_equal(pk.cpu().numpy(), expect)
    if flow:
        z_nf = nf_forward(args[0], nfl._packed_w, nfl._shapes, 2)
        assert torch.equal(zk.view(torch.int32), z_nf.view(torch.int32))


def _written(dev, flow: bool):
    """An NFL on ``dev`` after writes that leave data, updates and
    tombstones in both the run and the delta (no fold), with its ground
    truth: (nfl, keys, expected payload per key)."""
    keys = make_dataset("longlat" if flow else "lognormal", 40_000)
    pv = np.arange(keys.shape[0], dtype=np.int64)
    nfl = NFL(NFLConfig(backend="flat", force_flow=flow,
                        flow_train=FlowTrainConfig(epochs=1),
                        flat_index=FlatAFLIConfig(delta_cap=4096,
                                                  rebuild_frac=10.0)),
              device=dev)
    nfl.bulkload(keys[::2], pv[::2])
    expect = np.where(pv % 2 == 0, pv, -1)
    nfl.insert_batch(keys[1::4], pv[1::4])          # -> the run
    expect[1::4] = pv[1::4]
    gone = np.arange(0, keys.shape[0], 10)
    assert nfl.delete_batch(keys[gone[:1500]]).all()  # tombstones, run
    upd = np.arange(2, keys.shape[0], 16)
    ok = nfl.update_batch(keys[upd], pv[upd] + 1_000_000)
    expect[upd[ok]] = pv[upd[ok]] + 1_000_000
    nfl.insert_batch(keys[3::40], pv[3::40] + 2_000_000)  # -> the delta
    expect[3::40] = pv[3::40] + 2_000_000
    assert nfl.delete_batch(keys[gone[1500:]]).all()  # tombstones, delta
    expect[gone] = -1
    st = nfl.stats()
    assert st["run_len"] and st["delta_len"] and not st["fold_active"]
    return nfl, keys, expect


def _feats(nfl, keys):
    if nfl.use_flow:
        return expand_features(keys, nfl.normalizer, nfl.cfg.flow.dim,
                               nfl.cfg.flow.theta, dtype=np.float32)
    return keys.astype(np.float32).reshape(-1, 1)


@pytest.mark.parametrize("flow", [True, False])
def test_fused_lookup_kernel_matches_plain_with_tiers(cuda, flow):
    nfl, keys, expect = _written(cuda, flow)
    idx = nfl.index
    hi, lo = split_key_bits(keys)
    args = (torch.from_numpy(_feats(nfl, keys)).to(cuda),
            torch.from_numpy(hi.view(np.int32)).to(cuda),
            torch.from_numpy(lo.view(np.int32)).to(cuda), nfl._packed_w,
            idx._kernel_pools(), idx._tier_pack())
    kw = dict(dim=nfl.cfg.flow.dim, shapes=nfl._shapes,
              max_depth=idx.max_depth, dense_iters=24, bucket_cap=6,
              dense_window=idx.dense_window, use_flow=flow)
    pk, zk = fused_lookup(*args, **kw)
    pp, zp = fused_lookup_plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(pk, pp)
    assert torch.equal(zk.view(torch.int32), zp.view(torch.int32))
    assert np.array_equal(pk.cpu().numpy(), expect)


@pytest.mark.parametrize("flow", [True, False])
def test_range_scan_kernel_matches_plain(cuda, flow):
    nfl, keys, expect = _written(cuda, flow)
    idx = nfl.index
    rng = np.random.default_rng(7)
    lo_k = rng.choice(keys, 4096)
    hi_k = lo_k + rng.uniform(0, 1e-3 if flow else 1e4, 4096) * np.where(
        rng.random(4096) < 0.1, -1, 1)                 # some inverted
    args = (torch.from_numpy(_feats(nfl, lo_k)).to(cuda),
            torch.from_numpy(_feats(nfl, hi_k)).to(cuda), nfl._packed_w,
            idx._serving.scan_pack(), idx._tier_pack())
    kw = dict(dim=nfl.cfg.flow.dim, shapes=nfl._shapes, scan_cap=128,
              use_flow=flow)
    before = fused_range_scan.launches
    got = fused_range_scan(*args, **kw)
    want = fused_range_scan_plain(*args, **kw)
    torch.cuda.synchronize()
    assert fused_range_scan.launches == before + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    cnt, tot = got[1].cpu().numpy(), got[2].cpu().numpy()
    assert cnt.sum() > 0 and (tot > cnt).any()
    if flow:
        z_nf = nf_forward(args[0], nfl._packed_w, nfl._shapes,
                          nfl.cfg.flow.dim)
        assert torch.equal(got[3].view(torch.int32), z_nf.view(torch.int32))


def _wide(dev, flow: bool, max_bucket: int = 6):
    """An index whose run holds more than 2^16 rows, with (flow off)
    colliding f32 keys (1e15 + arange) in the tree, the run and the
    delta, and tombstones: (nfl, keys, expected payload per key)."""
    base = make_dataset("longlat" if flow else "lognormal", 240_000)
    keys = base if flow else np.unique(
        np.concatenate([base, 1e15 + np.arange(400.0)]))
    pv = np.arange(keys.shape[0], dtype=np.int64)
    nfl = NFL(NFLConfig(backend="flat", force_flow=flow,
                        flow_train=FlowTrainConfig(epochs=1),
                        flat_index=FlatAFLIConfig(delta_cap=4096,
                                                  rebuild_frac=10.0,
                                                  max_bucket=max_bucket)),
              device=dev)
    nfl.bulkload(keys[::2], pv[::2])
    odd, odd_pv = keys[1::2], pv[1::2]
    run_k = odd[:-150]
    pk = (ops.nf_transform_keys(nfl.flow_params, nfl.normalizer, run_k,
                                nfl.cfg.flow, dev) if flow else run_k)
    hi, lo = split_key_bits(run_k)
    nfl.index._append_run(pk.astype(np.float32), hi, lo,
                          odd_pv[:-150].astype(np.int32))
    nfl.insert_batch(odd[-150:], odd_pv[-150:])        # -> the delta
    gone = np.arange(0, 6000, 10)                      # loaded keys
    assert nfl.delete_batch(keys[gone]).all()
    expect = pv.copy()
    expect[gone] = -1
    st = nfl.stats()
    assert st["run_len"] > 1 << 16 and st["delta_len"]
    return nfl, keys, expect


@pytest.mark.parametrize("flow", [True, False])
def test_fused_lookup_kernel_wide_run_and_edge_batches(cuda, flow):
    """A run past 2^16 rows (fences of stride > 1), colliding keys with
    windows above 1 (flow off), and batches of 1 and of 1,037 queries
    (not a multiple of a warp or a block): bit-equal to plain."""
    nfl, keys, expect = _wide(cuda, flow)
    idx = nfl.index
    if not flow:
        st = idx.stats()["serving"]
        assert st["run_window"] > 1 and st["delta_window"] > 1
    kw = dict(dim=nfl.cfg.flow.dim, shapes=nfl._shapes,
              max_depth=idx.max_depth, dense_iters=idx.cfg.dense_search_iters,
              bucket_cap=idx.cfg.max_bucket, dense_window=idx.dense_window,
              use_flow=flow)
    for sel in (slice(None), slice(0, 1), slice(-1037, None),
                slice(77, 78)):
        k = keys[sel]
        hi, lo = split_key_bits(k)
        args = (torch.from_numpy(_feats(nfl, k)).to(cuda),
                torch.from_numpy(hi.view(np.int32)).to(cuda),
                torch.from_numpy(lo.view(np.int32)).to(cuda), nfl._packed_w,
                idx._kernel_pools(), idx._tier_pack())
        pk, zk = fused_lookup(*args, **kw)
        pp, zp = fused_lookup_plain(*args, **kw)
        torch.cuda.synchronize()
        assert torch.equal(pk, pp), sel
        assert torch.equal(zk.view(torch.int32), zp.view(torch.int32))
        assert np.array_equal(pk.cpu().numpy(), expect[sel]), sel


def test_fused_lookup_kernel_generic_bucket_width(cuda):
    """``bucket_cap`` above the kernel's unrolled 8 columns takes the
    generic instantiation: bit-equal to plain, with and without tiers."""
    nfl, keys, expect = _wide(cuda, False, max_bucket=12)
    idx = nfl.index
    pools = idx._kernel_pools()
    assert pools.bhi.shape[1] == 12
    hi, lo = split_key_bits(keys)
    kw = dict(dim=nfl.cfg.flow.dim, shapes=nfl._shapes,
              max_depth=idx.max_depth, dense_iters=idx.cfg.dense_search_iters,
              bucket_cap=12, dense_window=idx.dense_window, use_flow=False)
    for tiers in (idx._tier_pack(), None):
        args = (torch.from_numpy(_feats(nfl, keys)).to(cuda),
                torch.from_numpy(hi.view(np.int32)).to(cuda),
                torch.from_numpy(lo.view(np.int32)).to(cuda), None, pools,
                tiers)
        pk, zk = fused_lookup(*args, **kw)
        pp, zp = fused_lookup_plain(*args, **kw)
        torch.cuda.synchronize()
        assert torch.equal(pk, pp)
        assert torch.equal(zk.view(torch.int32), zp.view(torch.int32))
        if tiers is not None:
            assert np.array_equal(pk.cpu().numpy(), expect)


@pytest.mark.parametrize("flow", [True, False])
def test_range_scan_kernel_wide_run_ties_and_truncation(cuda, flow):
    """Ranges over a run past 2^16 rows and (flow off) over the colliding
    keys, cut by ``scan_cap`` inside a run of equal keys; batches of 1 and
    of 1,037 ranges (not a multiple of the block's 8 warps)."""
    nfl, keys, _expect = _wide(cuda, flow)
    idx = nfl.index
    rng = np.random.default_rng(11)
    lo_k = np.concatenate([rng.choice(keys, 1024), keys[-420:-407]])
    span = 1e-4 if flow else 1e5
    hi_k = lo_k + rng.uniform(0, span, lo_k.shape[0])
    hi_k[-13:] = 1e15 + np.arange(13) * 37.0          # across the ties
    for cap in (33, 128):
        for sel in (slice(None), slice(-1, None), slice(5, 6)):
            args = (torch.from_numpy(_feats(nfl, lo_k[sel])).to(cuda),
                    torch.from_numpy(_feats(nfl, hi_k[sel])).to(cuda),
                    nfl._packed_w, idx._serving.scan_pack(),
                    idx._tier_pack())
            kw = dict(dim=nfl.cfg.flow.dim, shapes=nfl._shapes,
                      scan_cap=cap, use_flow=flow)
            got = fused_range_scan(*args, **kw)
            want = fused_range_scan_plain(*args, **kw)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    full = fused_range_scan(
        torch.from_numpy(_feats(nfl, lo_k)).to(cuda),
        torch.from_numpy(_feats(nfl, hi_k)).to(cuda), nfl._packed_w,
        idx._serving.scan_pack(), idx._tier_pack(), dim=nfl.cfg.flow.dim,
        shapes=nfl._shapes, scan_cap=33, use_flow=flow)
    assert (full[2] > 33).any() and (full[1] > 0).any()


@pytest.mark.parametrize("flow", [True, False])
def test_streamed_lookup_kernel_matches_plain_with_tiers(cuda, flow):
    """The streamed kernel against its plain version, with data, updates
    and tombstones in both tiers: bit-equal, right against ground truth,
    and equal to the fused kernel (payloads and z)."""
    nfl, keys, expect = _written(cuda, flow)
    idx = nfl.index
    hi, lo = split_key_bits(keys)
    feats = torch.from_numpy(_feats(nfl, keys)).to(cuda)
    qhi = torch.from_numpy(hi.view(np.int32)).to(cuda)
    qlo = torch.from_numpy(lo.view(np.int32)).to(cuda)
    sp, tp = idx._serving.stream_pack(), idx._tier_pack()
    kw = dict(dim=nfl.cfg.flow.dim, shapes=nfl._shapes, use_flow=flow)
    before = streamed_lookup.launches
    pk, zk = streamed_lookup(feats, qhi, qlo, nfl._packed_w, sp, tp, **kw)
    pp, zp = streamed_lookup_plain(feats, qhi, qlo, nfl._packed_w, sp, tp,
                                   **kw)
    pf, zf = fused_lookup(feats, qhi, qlo, nfl._packed_w,
                          idx._kernel_pools(), tp, max_depth=idx.max_depth,
                          dense_iters=24, bucket_cap=6,
                          dense_window=idx.dense_window, **kw)
    torch.cuda.synchronize()
    assert streamed_lookup.launches == before + 1
    assert torch.equal(pk, pp) and torch.equal(pk, pf)
    assert torch.equal(zk.view(torch.int32), zp.view(torch.int32))
    assert torch.equal(zk.view(torch.int32), zf.view(torch.int32))
    assert np.array_equal(pk.cpu().numpy(), expect)


def test_index_probe_kernel_matches_plain(cuda):
    """The node probe against its plain version on a built root node:
    bit-equal, and its DATA hits are the payloads the lookup serves."""
    nfl, keys, pv = _index(cuda, False)
    idx = nfl.index
    a = idx.arrays
    pools = idx._kernel_pools()
    size = int(a.node_size[0])
    hi, lo = split_key_bits(keys)
    args = (torch.from_numpy(keys.astype(np.float32)).to(cuda),
            torch.from_numpy(hi.view(np.int32)).to(cuda),
            torch.from_numpy(lo.view(np.int32)).to(cuda),
            a.node_slope[0], a.node_intercept[0],
            *(getattr(pools, f)[:size] for f in ("etype", "ehi", "elo",
                                                 "epayload", "echild")))
    before = index_probe.launches
    got = index_probe(*args)
    want = index_probe_plain(*args)
    torch.cuda.synchronize()
    assert index_probe.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    hit = (got[0] >= 0).cpu().numpy()
    assert hit.sum() > 0
    assert np.array_equal(got[0].cpu().numpy()[hit],
                          idx.lookup_batch(keys[hit]))


def _probe_node(n_entries, seed):
    """A random model node (codes, identities, payloads, children) and
    its slope/intercept mapping [0, 1e6) onto it."""
    rng = np.random.default_rng(seed)
    etype = rng.integers(0, 4, n_entries).astype(np.int32)
    ids = rng.integers(-2**31, 2**31, (4, n_entries)).astype(np.int32)
    slope = np.float32((n_entries - 1) / 1e6)
    return etype, ids, slope, np.float32(0.25)


def _probe_args(dev, qkey, n_entries, seed, match=0.5):
    """``index_probe`` arguments: queries whose identities equal the
    entry's at their slot for a ``match`` share of them."""
    etype, (ehi, elo, epay, echild), slope, icpt = _probe_node(n_entries,
                                                               seed)
    epay = np.abs(epay)
    q = torch.from_numpy(np.asarray(qkey, np.float32))
    slot = torch.clamp(torch.round(torch.nan_to_num(
        torch.tensor(slope) * q + torch.tensor(icpt))), 0,
        n_entries - 1).to(torch.int64).numpy()
    rng = np.random.default_rng(seed + 1)
    hit = rng.random(q.shape[0]) < match
    qhi = np.where(hit, ehi[slot], rng.integers(-2**31, 2**31, q.shape[0])
                   ).astype(np.int32)
    qlo = np.where(hit, elo[slot], elo[slot] ^ 1).astype(np.int32)
    t = [torch.from_numpy(x).to(dev) for x in (q.numpy(), qhi, qlo)]
    e = [torch.from_numpy(x).to(dev) for x in (etype, ehi, elo, epay,
                                                echild)]
    return (*t, slope, icpt, *e)


def _probe_equal(args):
    before = index_probe.launches
    got = index_probe(*args)
    want = index_probe_plain(*args)
    torch.cuda.synchronize()
    assert index_probe.launches == before + 1
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and torch.equal(g, w)
    return got


@pytest.mark.parametrize("b", [1, 3, 4, 5, 65_537])
def test_index_probe_batch_sizes(cuda, b):
    """Bit-equal to plain at B around a multiple of 4 and past a block,
    and DATA hits where the identities match."""
    rng = np.random.default_rng(b)
    got = _probe_equal(_probe_args(cuda, rng.uniform(-1e4, 1.01e6, b),
                                   20_000, b))
    if b > 1000:
        assert (got[0] >= 0).any() and (got[0] == -1).any()


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_index_probe_unaligned_views(cuda, offset):
    """Query and entry views that start off a 16-byte boundary:
    bit-equal to plain."""
    b = 10_001
    rng = np.random.default_rng(offset)
    args = _probe_args(cuda, rng.uniform(0, 1e6, b + offset), 9_000 + offset,
                       offset)
    q, qhi, qlo, slope, icpt, *e = args
    views = [t[offset:] for t in (q, qhi, qlo)]
    assert views[0].data_ptr() % 16 and views[0].is_contiguous()
    _probe_equal((*views, slope, icpt, *(x[offset:] for x in e)))


@pytest.mark.parametrize("n_entries", [1, 2, 4097])
def test_index_probe_edge_keys(cuda, n_entries):
    """+-inf, +-0.0, NaN, huge and tiny keys exercise the slot clamp and
    the saturating conversion; S = 1 maps every key to the one entry."""
    edge = np.array([np.inf, -np.inf, 0.0, -0.0, np.nan, 3e38, -3e38,
                     1e-45, -1e-45, 1e6, 999_999.5, 2.1e9, -2.1e9],
                    np.float32)
    q = np.tile(edge, 317)[:4001]
    _probe_equal(_probe_args(cuda, q, n_entries, 7, match=0.7))
    # a negative slope sends +inf to slot 0 and -inf to the last slot
    q_t, qhi, qlo, _slope, icpt, *e = _probe_args(cuda, q, n_entries, 8)
    _probe_equal((q_t, qhi, qlo, np.float32(-0.001), icpt, *e))


def _shards_cpu_and_card(cuda, flow):
    keys = make_dataset("longlat" if flow else "lognormal", 60_000)
    pv = np.arange(keys.shape[0], dtype=np.int64)
    out = []
    for dev in ("cpu", cuda):
        nfl = NFL(NFLConfig(backend="flat", shards=4, force_flow=flow,
                            flow_train=FlowTrainConfig(epochs=1)), device=dev)
        nfl.bulkload(keys[::2], pv[::2])
        out.append(nfl)
    return out, keys, pv


@pytest.mark.parametrize("flow", [False, True])
def test_sharded_nfl_on_card_matches_cpu(cuda, flow):
    """``NFL(shards=4)`` on the card against the CPU port on the same
    keys: flow off the shards' pools are equal and every read is; flow
    on (each side trains its own flow) both hold to the ground truth.
    A read batch launches one router ``nf_forward`` (flow on) and one
    ``fused_lookup`` per non-empty shard segment."""
    (cpu, card), keys, pv = _shards_cpu_and_card(cuda, flow)
    assert [str(d) for d in card.index.devices] == ["cuda:0"] * 4
    assert all(st is not None for st in card.index.streams)
    if not flow:
        assert np.array_equal(cpu.index.boundaries, card.index.boundaries)
        for a, b in zip(cpu.index.shards, card.index.shards):
            for f, x, y in zip(a.arrays._fields, a.arrays, b.arrays):
                assert np.array_equal(x, y), f
    expect = np.where(pv % 2 == 0, pv, -1)
    q = keys[np.random.default_rng(0).permutation(keys.shape[0])[:50_000]]
    want = expect[np.searchsorted(keys, q)]
    ops.reset_launch_counts()
    got = card.lookup_batch(q)
    s = card.dispatch_stats()
    assert np.array_equal(got, want)
    assert np.array_equal(cpu.lookup_batch(q), want)
    segs = np.bincount(card.index._route_points(
        ops.nf_transform_keys(card.flow_params, card.normalizer, q,
                              card.cfg.flow, cuda).astype(np.float32)
        if flow else q.astype(np.float32)), minlength=4)
    assert s["nf_forward_launches"] == int(flow)
    assert s["fused_lookup_launches"] == int((segs > 0).sum())
    # writes, then a scan batch that straddles every boundary
    new = keys[1::2][:3000]
    for nfl in (cpu, card):
        nfl.insert_batch(new, pv[1::2][:3000])
        assert nfl.delete_batch(keys[::2][:2000]).all()
    expect[1::2][:3000] = pv[1::2][:3000]
    expect[::2][:2000] = -1
    assert np.array_equal(card.lookup_batch(keys), expect)
    lo, hi = keys[:-200:50], keys[200::50]
    c1 = cpu.scan_batch(lo, hi, cap=512)
    c2 = card.scan_batch(lo, hi, cap=512)
    if not flow:
        for x, y in zip(c1, c2):
            assert np.array_equal(x, y)
        assert card.index._router["straddling_ranges"] >= 3


def test_sharded_async_reads_on_card(cuda):
    """Two sharded batches in flight on the shards' streams with writes
    issued between dispatch and finish: each reads the state it was
    dispatched into (the writes wait on the shards' streams)."""
    (_cpu, card), keys, pv = _shards_cpu_and_card(cuda, True)
    expect = np.where(pv % 2 == 0, pv, -1)
    q = keys
    f1 = card.lookup_batch_async(q)
    loaded = keys[::2]
    assert card.update_batch(loaded[:5000], np.arange(5000) + 10**7).all()
    assert card.delete_batch(loaded[5000:10000]).all()
    card.insert_batch(keys[1::2], pv[1::2])
    f2 = card.lookup_batch_async(q)
    after = pv.copy()
    after[::2][:5000] = np.arange(5000) + 10**7
    after[::2][5000:10000] = -1
    assert np.array_equal(f2(), after)
    assert np.array_equal(f1(), expect)


def test_nfl_serves_streamed_on_card(cuda):
    """``pool_budget=0``: the reads of an NFL on the card launch the
    streamed kernel and are right; the build's verifies stay fused."""
    keys = make_dataset("longlat", 60_000)
    pv = np.arange(keys.shape[0], dtype=np.int64)
    ops.reset_launch_counts()
    nfl = NFL(NFLConfig(backend="flat", force_flow=True,
                        flow_train=FlowTrainConfig(epochs=1),
                        flat_index=FlatAFLIConfig(pool_budget=0)))
    nfl.bulkload(keys[::2], pv[::2])
    s = nfl.dispatch_stats()
    assert s["fused_lookup_launches"] == 2 and s["streamed_lookup_launches"] == 0
    got = nfl.lookup_batch(keys)
    assert nfl.index.last_dispatch["path"] == "streamed"
    assert np.array_equal(got, np.where(pv % 2 == 0, pv, -1))
    assert nfl.dispatch_stats()["streamed_lookup_launches"] == 1


def test_nfl_writes_scans_and_rebuild_on_card(cuda):
    """insert, update, delete, scan and rebuild through NFL on the card,
    against ground truth: point reads, and scans as z-space multisets."""
    ops.reset_launch_counts()
    nfl, keys, expect = _written(cuda, True)

    def check():
        assert np.array_equal(nfl.lookup_batch(keys), expect)
        live = keys[expect >= 0]
        z = ops.nf_transform_keys(nfl.flow_params, nfl.normalizer, live,
                                  nfl.cfg.flow, cuda).astype(np.float32)
        order = np.argsort(z, kind="stable")
        zs, ps = z[order], expect[expect >= 0][order]
        r = np.random.default_rng(3).integers(0, live.shape[0] - 101, 512)
        lo_k, hi_k = live[order][r], live[order][r + 60]
        pv, cnt, tot = nfl.scan_batch(lo_k, hi_k)
        for i in np.flatnonzero(tot <= 128):
            want = np.sort(ps[np.searchsorted(zs, zs[r[i]]):
                              np.searchsorted(zs, zs[r[i] + 60])])
            assert np.array_equal(np.sort(pv[i, :cnt[i]]), want), i

    check()
    nfl.index.rebuild()
    assert nfl.index.n_rebuilds == 1
    assert nfl.stats()["run_len"] == nfl.index.n_shadowed == 0
    check()
    s = nfl.dispatch_stats()
    assert s["fused_range_scan_launches"] == 2 and s["rebuilds"] == 1
    assert s["nf_forward_launches"] > 0 and s["fused_lookup_launches"] > 0


def test_kernel_rejects_bad_inputs(cuda):
    nfl, keys, _ = _index(cuda, False)
    idx = nfl.index
    q = torch.from_numpy(keys[:64].astype(np.float32).reshape(-1, 1)).to(cuda)
    h = torch.zeros(64, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        fused_lookup(q, h, h, None, idx._kernel_pools(), None, dim=1,
                     max_depth=4, dense_iters=24, bucket_cap=6,
                     use_flow=False)
    with pytest.raises(ValueError):
        nf_forward(q.double(), nfl._packed_w, nfl._shapes, 2)
    hi = torch.zeros(64, dtype=torch.int32, device=cuda)
    sp = idx._serving.stream_pack()
    kw = dict(dim=1, use_flow=False)
    with pytest.raises(ValueError):            # wrong dtype
        streamed_lookup(q, h, h, None, sp, None, **kw)
    with pytest.raises(ValueError):            # wrong device
        streamed_lookup(q, hi.cpu(), hi, None, sp, None, **kw)
    with pytest.raises(ValueError):            # not contiguous
        streamed_lookup(torch.cat([q, q], 1)[:, :1], hi, hi, None, sp, None,
                        **kw)
    pools = idx._kernel_pools()
    entries = [getattr(pools, f)[:8] for f in ("etype", "ehi", "elo",
                                              "epayload", "echild")]
    with pytest.raises(ValueError):            # wrong dtype
        index_probe(q[:, 0], h, h, 1.0, 0.0, *entries)
    with pytest.raises(ValueError):            # wrong device
        index_probe(q[:, 0], hi, hi, 1.0, 0.0, entries[0].cpu(),
                    *entries[1:])
    with pytest.raises(ValueError):            # not contiguous
        index_probe(q[:, 0], hi, hi, 1.0, 0.0, pools.etype[:16:2],
                    *entries[1:])
    # tier hi arrays are read four rows a 16-byte load: a view that
    # starts one row in is refused by both tier-probing kernels
    tp = idx._tier_pack()
    t = tp.pools
    shifted = tp._replace(pools=t._replace(
        run_pk=t.run_pk[1:-3], run_hi=t.run_hi[1:-3], run_lo=t.run_lo[1:-3],
        run_pv=t.run_pv[1:-3]))
    with pytest.raises(ValueError):
        fused_lookup(q, hi, hi, None, pools, shifted, dim=1, max_depth=4,
                     dense_iters=24, bucket_cap=6, use_flow=False)
    with pytest.raises(ValueError):
        fused_range_scan(q, q, None, idx._serving.scan_pack(), shifted,
                         dim=1, scan_cap=8, use_flow=False)


def test_nfl_serves_through_kernels(cuda):
    keys = make_dataset("longlat", 60_000)
    pv = np.arange(keys.shape[0], dtype=np.int64)
    ops.reset_launch_counts()
    nfl = NFL(NFLConfig(backend="flat", force_flow=True,
                        flow_train=FlowTrainConfig(epochs=1)))
    nfl.bulkload(keys[::2], pv[::2])
    got = nfl.lookup_batch(keys)
    assert np.array_equal(got, np.where(pv % 2 == 0, pv, -1))
    s = nfl.dispatch_stats()
    assert s["nf_forward_launches"] == 1
    assert s["fused_lookup_launches"] == 3  # self-verify, serve verify, read
    assert s["shadowed"] == 0


def test_dispatch_stats_reset_loses_no_launch_on_card(cuda):
    """``NFL.dispatch_stats(reset=True)`` from a reader thread racing
    live reads on the card without pause: the per-window
    ``fused_lookup_launches`` plus the residue equal the reads issued
    (one launch each)."""
    import threading

    keys = make_dataset("lognormal", 20_000)
    nfl = NFL(NFLConfig(backend="flat", force_flow=False,
                        flow_train=FlowTrainConfig(epochs=1)))
    nfl.bulkload(keys, np.arange(keys.shape[0], dtype=np.int64))
    q = keys[:256]
    nfl.lookup_batch(q)
    nfl.dispatch_stats(reset=True)
    n_calls, snaps = 4000, []
    stop = threading.Event()

    def reader():
        while not stop.is_set():
            snaps.append(nfl.dispatch_stats(reset=True)
                         ["fused_lookup_launches"])

    t = threading.Thread(target=reader)
    t.start()
    try:
        for _ in range(n_calls):
            nfl.lookup_batch(q)
    finally:
        stop.set()
        t.join()
    residue = nfl.dispatch_stats()["fused_lookup_launches"]
    assert len(snaps) > 10
    assert sum(snaps) + residue == n_calls, \
        f"counted {sum(snaps) + residue} of {n_calls} launches"


def _params_on(params, dev):
    return {k: ([{n: t.to(dev) for n, t in layer.items()} for layer in v]
                if k == "layers" else v.to(dev)) for k, v in params.items()}


@pytest.mark.parametrize("candidate", ["flow", "identity"])
def test_reflow_on_card_matches_cpu(cuda, candidate):
    """``FlatAFLI.start_reflow`` under a second flow (or the identity) on
    the card and on the CPU, with the same flows and the same writes:
    every read before, during and after the re-keying fold, and every
    live key after it, as the oracle answers on both devices (one async
    batch in flight across the write call that swaps); after the swap the
    card's served z equals the re-key's z (``ops.nf_transform_keys``, the
    NF kernel) bit for bit, and the fold verified through
    ``fused_lookup`` under the candidate's weights."""
    keys = make_dataset("lognormal", 60_000)
    base, fresh = keys[::2], keys[1::2]
    cfg = FlowConfig()
    p1, n1, _ = train_flow(base, cfg, FlowTrainConfig(epochs=1),
                           device="cpu")
    p2, n2, _ = train_flow(base[::3], cfg,
                           FlowTrainConfig(epochs=1, seed=5), device="cpu")
    sides = {}
    for dev in ("cpu", cuda):
        a, b = _params_on(p1, dev), _params_on(p2, dev)
        w1, shapes = ops.pack_params(a, cfg)
        w2, _ = ops.pack_params(b, cfg)
        idx = FlatAFLI(FlatAFLIConfig(fold_step_keys=4096), device=dev)
        idx.build(ops.nf_transform_keys(a, n1, base, cfg, dev),
                  np.arange(base.shape[0]), ikeys=base)
        idx.set_serve_flow(n1, cfg, w1, shapes)
        if candidate == "flow":
            def fn(k, b=b, dev=dev):
                return ops.nf_transform_keys(b, n2, k, cfg, dev)
            new_ctx = (n2, cfg, w2, shapes)
        else:
            def fn(k):
                return np.asarray(k, np.float64)
            new_ctx = None
        sides[str(dev)] = dict(idx=idx, old=(a, n1, w1), fn=fn,
                               ctx=new_ctx, swaps=[])
    oracle = dict(zip(base.tolist(), range(base.shape[0])))

    def read(side, q):
        idx = side["idx"]
        if idx._serve_flow is None:
            return idx.lookup_batch_async(q.astype(np.float32), ikeys=q)
        norm, fcfg, w, shp = idx._serve_flow
        feats = expand_features(q, norm, fcfg.dim, fcfg.theta,
                                dtype=np.float32)
        return idx.lookup_batch_flow_async(feats, q, w, shp)

    def pkeys(side, k):
        if side["swaps"]:
            return side["fn"](k)
        a, norm, _w = side["old"]
        return ops.nf_transform_keys(a, norm, k, cfg, side["idx"].device)

    ops.reset_launch_counts()
    for side in sides.values():
        assert side["idx"].start_reflow(side["fn"], side["ctx"],
                                        lambda s=side: s["swaps"].append(1))
        assert not side["idx"].start_reflow(side["fn"], side["ctx"],
                                            lambda: None)
    rng = np.random.default_rng(3)
    step, batch = 0, 2048
    while not all(s["swaps"] for s in sides.values()):
        assert step < 64, "the re-flow did not swap"
        k = fresh[step * batch:(step + 1) * batch]
        v = np.arange(k.shape[0]) + 100_000 * (step + 1)
        q = rng.choice(np.array(sorted(oracle)), 4096, replace=False)
        want = np.array([oracle[x] for x in q.tolist()])
        for side in sides.values():
            inflight = read(side, q)
            side["idx"].insert_batch(pkeys(side, k), v, ikeys=k)
            assert np.array_equal(inflight(), want), f"write {step}"
        oracle.update(zip(k.tolist(), v.tolist()))
        step += 1
    counts = ops.launch_counts()
    assert counts["fused_lookup"] > 0 and counts["streamed_lookup"] == 0
    assert counts["nf_forward"] > int(candidate == "flow")
    live = np.array(sorted(oracle))
    want = np.array([oracle[x] for x in live.tolist()])
    got = {d: read(s, live)() for d, s in sides.items()}
    for d, g in got.items():
        assert np.array_equal(g, want), d
    card = sides[str(cuda)]["idx"]
    assert card.n_reflows == 1 and card.last_fold["reflow"]
    hi, lo = split_key_bits(live)
    if candidate == "flow":
        norm, fcfg, w, shp = card._serve_flow
        feats = expand_features(live, norm, fcfg.dim, fcfg.theta,
                                dtype=np.float32)
        _pay, z = card._flow_device_lookup(feats, hi, lo, w, shp)
        zk = sides[str(cuda)]["fn"](live).astype(np.float32)
        assert np.array_equal(z.view(np.int32), zk.view(np.int32))
    else:
        assert card._serve_flow is None
        for d, s in sides.items():
            _pay, z = s["idx"]._dispatch(live.astype(np.float32)
                                         .reshape(-1, 1), hi, lo, None, True)
            assert np.array_equal(z, live.astype(np.float32)), d


def _device_spans(obj, out, seen):
    """The (address, bytes) of every CUDA tensor reachable from ``obj``
    (a shard's tree pools and write tiers: what a point read reads)."""
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda and id(obj) not in seen:
            seen.add(id(obj))
            out.append((obj.data_ptr(), obj.numel() * obj.element_size()))
        return
    if isinstance(obj, (list, tuple)):
        for x in obj:
            _device_spans(x, out, seen)
    elif hasattr(obj, "__dict__"):
        for x in vars(obj).values():
            _device_spans(x, out, seen)


def test_migration_swap_waits_for_reads_in_flight_on_card(cuda):
    """A migration swap drops its window's shards, and a freeze rewrites
    their tiers, while a read batch is still in flight on their streams;
    the batch must read the state it was dispatched into
    (``swap_under_reads``).  It runs in a child
    process with ``CUDA_DEVICE_MAX_CONNECTIONS=32``: with the default 8
    hardware queues the caller's stream can share a queue with a shard
    stream, and its work then waits for the shard's reads anyway, which
    hides the hazard (seen on the H100)."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    here = Path(__file__).resolve().parent
    path = [str(here), str(here.parent / "src"), os.environ.get("PYTHONPATH", "")]
    env = dict(os.environ, CUDA_DEVICE_MAX_CONNECTIONS="32",
               PYTHONPATH=os.pathsep.join(p for p in path if p))
    out = subprocess.run(
        [sys.executable, "-c", "import test_torch_kernels_cuda as t; "
         "t.swap_under_reads()"], env=env, capture_output=True, text=True,
        timeout=900)
    print(out.stdout)
    assert out.returncode == 0, out.stdout + out.stderr[-4000:]


def _fill_caller_pools(cuda) -> None:
    """Fill the current stream's allocator pools, large and small, so
    that what follows allocates from cache (a ``cudaMalloc`` waits for
    the whole device)."""
    big = torch.empty(3 << 30, dtype=torch.uint8, device=cuda)
    small_blocks = [torch.empty((1 << 20) - 512, dtype=torch.uint8,
                                device=cuda) for _ in range(256)]
    del big, small_blocks
    torch.cuda.synchronize()


def _dispatch_spun(nfl, q, caller):
    """``nfl.lookup_batch_async(q)`` with each shard's ``fused_lookup``
    queued behind a ~0.5 s spin on its stream; returns the finisher."""
    real = ops.fused_lookup

    def spun(*a, **k):
        if torch.cuda.current_stream() != caller:
            torch.cuda._sleep(1_000_000_000)
        return real(*a, **k)

    ops.fused_lookup = spun
    try:
        return nfl.lookup_batch_async(q)
    finally:
        ops.fused_lookup = real


def _overwrite_free(cuda, caller, spans):
    """Take back every free block of the caller's stream, largest first
    (best fit then hands out each block whole), and fill it with junk.
    Returns the junk tensors and how many of ``spans`` they cover."""
    free = sorted((b["size"] for seg in torch.cuda.memory_snapshot()
                   if seg["stream"] == caller.cuda_stream
                   for b in seg["blocks"] if b["state"] == "inactive"),
                  reverse=True)
    junk = [torch.empty(n, dtype=torch.uint8, device=cuda).fill_(0xF9)
            for n in free]
    covered = sum(any(j.data_ptr() <= a and a + n <= j.data_ptr()
                      + j.numel() for j in junk) for a, n in spans)
    return junk, covered


def swap_under_reads(n_keys: int = 200_000) -> None:
    """A sharded episode's two stream hazards on the card, each with a
    read batch held in flight on the old shards' streams: the migration
    swap (``_swap_leg``) and the freeze (``_freeze_leg``), each inside
    the ``lookup_batch_async`` call that fans the batch out.  The caller
    serves from a stream of its own, as a server thread would, with its
    allocator pools filled first: work on the legacy default stream and
    a ``cudaMalloc`` (a cache miss in the episode's own work) both wait
    for the whole device, and either would let the reads finish first.
    Raises AssertionError on a wrong read or an unmet precondition;
    prints one line a leg."""
    cuda = torch.device("cuda")
    caller = torch.cuda.Stream(cuda)
    with torch.cuda.stream(caller):
        keys = make_dataset("lognormal", n_keys)
        pv = np.arange(keys.shape[0], dtype=np.int64)
        _swap_leg(cuda, caller, keys, pv)
        _freeze_leg(cuda, caller, keys, pv)


def _swap_leg(cuda, caller, keys, pv) -> None:
    """``[0, 1]`` swaps inside the call that fans the read batch out.
    Right after the swap every free block of the caller's stream is taken
    back and overwritten; the old window's pools and tiers must be among
    them, and the shard streams must still be busy.  The batch must
    still read the state it was dispatched into: the swap makes the
    caller's stream wait on the dropped shards' streams first."""
    from repro_torch.kernels.shard_dispatch import fanout_plan, route
    nfl = NFL(NFLConfig(backend="flat", shards=4, force_flow=False,
                        flow_train=FlowTrainConfig(epochs=1)), device=cuda)
    nfl.bulkload(keys[::2], pv[::2])
    idx = nfl.index
    # writes held in the window's deltas across the episode
    n_held = 2048
    nfl.insert_batch(keys[1::2][:n_held], pv[1::2][:n_held])
    expect = np.where(pv % 2 == 0, pv, -1)
    expect[1::2][:n_held] = pv[1::2][:n_held]
    swaps = []
    assert idx.start_reshard(0, 1, lambda: swaps.append(1))
    nfl.insert_batch(keys[1::2][n_held:2 * n_held],
                     pv[1::2][n_held:2 * n_held])
    expect[1::2][n_held:2 * n_held] = pv[1::2][n_held:2 * n_held]
    small = keys[::2][:64]

    def nearly_done():
        folds = [f for f in idx._reshard.folds if f is not None]
        return folds and all(f.phase == "verify" and len(f.chunks) <= 1
                             for f in folds)

    while not nearly_done():
        assert np.array_equal(nfl.lookup_batch(small), pv[::2][:64])
        assert idx._reshard is not None, "the episode swapped early"
    q = keys
    # the batch's per-shard reads once, straight on the shards (no
    # tick): their result buffers and uploads are cached from here on
    segs, _inv = fanout_plan(route(q.astype(np.float32),
                                   idx.boundaries), idx.n_shards)
    for s, seg in enumerate(segs):
        if seg.shape[0]:
            idx.shards[s].lookup_batch_async(q[seg],
                                             stream=idx.streams[s])()
    spans, seen = [], set()
    for s in (0, 1):
        sv = idx.shards[s]._serving
        _device_spans([sv.tree_pools, sv.run, sv.delta], spans, seen)
    del sv
    old = [id(s) for s in idx.shards]
    _fill_caller_pools(cuda)
    finish = _dispatch_spun(nfl, q, caller)
    assert swaps == [1] and idx._reshard is None
    assert [id(s) for s in idx.shards][2:] == old[2:]
    junk, covered = _overwrite_free(cuda, caller, spans)
    busy = [not st.query() for st in idx.streams[:2]]
    got = finish()
    del junk
    wrong = int((got != expect).sum())
    print(f"swap under reads: old window's read spans overwritten "
          f"{covered} of {len(spans)}; shard streams busy after the "
          f"overwrite {busy}; wrong reads {wrong} of {q.shape[0]}",
          flush=True)
    assert any(busy), "the reads were not held behind the spin"
    assert covered, "no block of the old window was handed out again"
    assert wrong == 0, f"{wrong} reads saw the swap's freed memory"
    assert np.array_equal(nfl.lookup_batch(q), expect)


def _freeze_leg(cuda, caller, keys, pv) -> None:
    """``[0, 1]`` freezes inside the call that fans the read batch out,
    as the reshard manager starts a migration from a read call.  Shard
    0 has a fold of its own in flight and a delta past its run tier's
    spare room, so the freeze's merge reallocates the run tier, frees
    the old one to the caller's stream and empties the delta in place.
    Those blocks are then overwritten at once.  The batch must still
    read the state it was dispatched into: the freeze makes the caller's
    stream wait on the frozen shards' streams first."""
    # a slow fold: it stays in flight across the writes below
    cfg = FlatAFLIConfig(delta_cap=256, fold_step_keys=256,
                         fold_work_factor=0.01)
    nfl = NFL(NFLConfig(backend="flat", shards=4, force_flow=False,
                        flat_index=cfg, flow_train=FlowTrainConfig(epochs=1)),
              device=cuda)
    nfl.bulkload(keys[::2], pv[::2])
    idx = nfl.index
    expect = np.where(pv % 2 == 0, pv, -1)
    odd = np.flatnonzero((pv % 2 == 1)
                         & (keys.astype(np.float32) < idx.boundaries[0]))
    sh = idx.shards[0]
    i = 0
    while sh._fold is None:
        nfl.insert_batch(keys[odd[i:i + 512]], pv[odd[i:i + 512]])
        i += 512
        assert i < odd.shape[0], "shard 0 never started a fold"
    rest = odd[i:]
    nfl.insert_batch(keys[rest], pv[rest])
    expect[odd] = pv[odd]
    run = sh._serving.run
    room = run.capacity - sh._run_pk.shape[0]
    assert sh._fold is not None and sh._delta_pk.shape[0] > room, (
        "the freeze's merge would not reallocate shard 0's run tier")
    q = keys
    assert np.array_equal(nfl.lookup_batch(q), expect)
    spans, seen = [], set()
    _device_spans([run.pk, run.hi, run.lo, run.pv], spans, seen)
    old_run = run.pk.data_ptr()
    del run
    _fill_caller_pools(cuda)
    busy_at_freeze = []
    note = nfl._reshard_note

    def freeze(n_keys):
        busy_at_freeze.extend(not st.query() for st in idx.streams[:2])
        assert idx.start_reshard(0, 1, lambda: None)
        note(n_keys)

    nfl._reshard_note = freeze
    try:
        finish = _dispatch_spun(nfl, q, caller)
    finally:
        nfl._reshard_note = note
    assert idx._reshard is not None and sh._tier_hold
    moved = sh._serving.run.pk.data_ptr() != old_run
    junk, covered = _overwrite_free(cuda, caller, spans)
    got = finish()
    del junk
    wrong = int((got != expect).sum())
    print(f"freeze under reads: shard 0's run tier reallocated {moved}, "
          f"its old spans overwritten {covered} of {len(spans)}; shard "
          f"streams busy at the freeze {busy_at_freeze}; wrong reads "
          f"{wrong} of {q.shape[0]}", flush=True)
    assert any(busy_at_freeze), "the reads were not held behind the spin"
    assert moved, "the freeze did not reallocate shard 0's run tier"
    assert covered, "no block of the old run tier was handed out again"
    assert wrong == 0, f"{wrong} reads saw the freeze's rewrite"
    idx.rebuild()
    assert np.array_equal(nfl.lookup_batch(q), expect)


def test_trainer_on_card_matches_cpu(cuda):
    keys = make_dataset("lognormal", 20_000)
    a = FlowTrainer(keys, FlowConfig(), FlowTrainConfig(epochs=3),
                    device="cpu")
    b = FlowTrainer(keys, FlowConfig(), FlowTrainConfig(epochs=3),
                    device=cuda)
    for _ in range(20):
        a.step()
        b.step()
    np.testing.assert_allclose(b.losses, a.losses, rtol=1e-5)
    np.testing.assert_allclose(b.params["layers"][0]["w"].cpu().numpy(),
                               a.params["layers"][0]["w"].numpy(), atol=1e-5)


def test_normalizer_features_are_host_side(cuda):
    keys = make_dataset("lognormal", 1000)
    norm = KeyNormalizer.fit(keys)
    f = expand_features(keys, norm, 2, 1e3, dtype=np.float32)
    idx = FlatAFLI(device=cuda)
    idx.build(keys, np.arange(keys.shape[0]))
    assert idx._kernel_pools().ekey.device.type == "cuda"
    assert f.dtype == np.float32


# ------------------------------------- NF and streamed kernels: edges
@pytest.mark.parametrize("dim,hidden,layers", [(2, 2, 2), (3, 2, 2),
                                               (4, 3, 3), (8, 4, 2)])
def test_nf_forward_kernel_batch_sizes_and_unaligned_feats(cuda, dim, hidden,
                                                          layers):
    """Every flow shape at batches of 1, 2, 3, 5, 100,003 and 2^20 + 1
    keys (the default flow's four-keys-a-thread path and its tail), and
    a contiguous feats view that starts off a 16-byte boundary: bit-equal
    to plain."""
    cfg, params = _flow(dim, hidden, layers, 7 * dim + layers, cuda)
    packed, shapes = ops.pack_params(params, cfg)
    base = torch.randn((1 << 20) + 2, dim, generator=torch.Generator()
                       .manual_seed(2)).mul_(4).to(cuda)
    for b in (1, 2, 3, 5, 100_003, (1 << 20) + 1):
        zk = nf_forward(base[:b], packed, shapes, dim)
        zp = nf_forward_plain(base[:b], packed, shapes, dim)
        assert torch.equal(zk.view(torch.int32), zp.view(torch.int32)), b
    view = base.reshape(-1)[1:1 + 1001 * dim].view(1001, dim)
    assert view.is_contiguous() and view.data_ptr() % 16
    zk = nf_forward(view, packed, shapes, dim)
    zp = nf_forward_plain(view, packed, shapes, dim)
    torch.cuda.synchronize()
    assert torch.equal(zk.view(torch.int32), zp.view(torch.int32))


def _streamed_on_card(cuda, sp, q, qh, ql, tiers=None):
    """The streamed kernel on the card against its plain version on the
    card, for a hand-made CPU stream pack (and tiers)."""
    from repro_torch.kernels.range_scan import ScanPool
    from repro_torch.kernels.streamed_lookup import StreamPack

    dsp = StreamPack(ScanPool(*(t.to(cuda) for t in sp.pool)),
                     sp.router.to(cuda), sp.window)
    dt = None if tiers is None else tiers._replace(pools=type(tiers.pools)(
        *(t.to(cuda) for t in tiers.pools)))
    args = (torch.from_numpy(np.asarray(q, np.float32).reshape(-1, 1))
            .to(cuda), torch.from_numpy(np.asarray(qh, np.int32)).to(cuda),
            torch.from_numpy(np.asarray(ql, np.int32)).to(cuda), None, dsp,
            dt)
    pk, zk = streamed_lookup(*args, dim=1, use_flow=False)
    pp, zp = streamed_lookup_plain(*args, dim=1, use_flow=False)
    torch.cuda.synchronize()
    assert torch.equal(pk, pp)
    assert torch.equal(zk.view(torch.int32), zp.view(torch.int32))
    return pk.cpu().numpy()


def test_streamed_lookup_kernel_edge_pools(cuda):
    """Empty pools (with and without tiers), pools of less than one tile,
    runs of equal keys across tile edges with windows of 24 and 40 (read
    row by row), signed zeros, and tiers holding tombstones: bit-equal to
    plain."""
    from test_torch_streamed_order import _pool, _tiers

    rng = np.random.default_rng(12)
    grid = np.arange(-40, 40, dtype=np.float32)
    grid[grid == 0] = -0.0
    ident = rng.integers(0, 16, (2, 300)).astype(np.int32)
    j = rng.integers(0, 300, 500)
    q = rng.choice(grid, 500)
    empty = np.empty(0, np.int32)
    for cap in (128, 4096):
        pool, router = _pool(np.empty(0, np.float32), empty, empty, empty,
                             cap)
        sp = StreamPack(pool, router, window=1)
        assert (_streamed_on_card(cuda, sp, q, *ident[:, j]) == -1).all()
        _streamed_on_card(cuda, sp, q, *ident[:, j],
                          tiers=_tiers(rng, grid, ident))
    for n in (1, 17, 1000):
        keys = np.sort(rng.choice(grid, n)).astype(np.float32)
        k = rng.integers(0, 300, n)
        pool, router = _pool(keys, ident[0, k], ident[1, k],
                             np.arange(n, dtype=np.int32), 4096)
        for w in (1, 3, 9):
            _streamed_on_card(cuda, StreamPack(pool, router, window=w), q,
                              *ident[:, j], tiers=_tiers(rng, grid, ident))
    keys = np.sort(rng.uniform(0, 1e6, 5000)).astype(np.float32)
    for edge, length in ((1024, 24), (2048, 40), (3072, 17)):
        keys[edge - length // 2:edge + length - length // 2] = keys[edge]
    keys = np.sort(keys)
    hi = rng.integers(0, 50, keys.shape[0]).astype(np.int32)
    lo = rng.integers(0, 3, keys.shape[0]).astype(np.int32)
    pool, router = _pool(keys, hi, lo, np.arange(keys.shape[0],
                                                 dtype=np.int32), 8192)
    pick = np.concatenate([np.arange(1000, 1060), np.arange(2000, 2100),
                           rng.integers(0, keys.shape[0], 400)])
    for w in (24, 40):
        got = _streamed_on_card(cuda, StreamPack(pool, router, window=w),
                                keys[pick], hi[pick], lo[pick])
        assert (got >= 0).all()
    # the bracket's slack and the full tile's last round, as
    # test_torch_streamed_order.py places them
    keys = np.unique(rng.uniform(1.0, 2.0, 3000).astype(np.float32))[:2500]
    ident = np.arange(2500, dtype=np.int32)
    pool, router = _pool(keys, ident, ident * 3, ident + 7, 4096)
    q, row = [], []
    for t in (1, 2):
        x = np.float32(router[t].item())
        for steps in (1, 2, 3):
            x = np.nextafter(x, np.float32(-np.inf))
            q.append(x)
            row.append(1024 * t)
        up = np.nextafter(np.float32(router[t].item()), np.float32(np.inf))
        q += [up, up]
        row += [1024 * t - 1, 1024 * t - 2]
    row = np.array(row)
    got = _streamed_on_card(cuda, StreamPack(pool, router, window=2), q,
                            ident[row], ident[row] * 3)
    assert got.tolist() == [1031, 1031, -1, 1030, -1,
                            2055, 2055, -1, 2054, -1]


def test_streamed_lookup_kernel_2_25_row_capacity(cuda):
    """A pool of 2^25-row capacity, nearly full: its 128 KB router is
    staged in shared memory; every key finds its own row."""
    cap = 1 << 25
    plen = cap - 1000
    pv = np.full(cap, -1, np.int32)
    pv[:plen] = np.arange(plen, dtype=np.int32)
    pk = pv.astype(np.float32)
    pk[plen:] = np.inf
    hi = (pv.view(np.uint32) * np.uint32(2654435761)).view(np.int32)
    from repro_torch.kernels.range_scan import ScanPool
    from repro_torch.kernels.streamed_lookup import build_router

    pool = ScanPool(torch.from_numpy(pk), torch.from_numpy(hi),
                    torch.from_numpy(pv), torch.from_numpy(pv),
                    torch.tensor([plen], dtype=torch.int32))
    sp = StreamPack(pool, build_router(pool.pk), window=2)
    pick = np.concatenate([np.random.default_rng(3).integers(0, plen,
                                                             100_000),
                           [0, 1, plen - 2, plen - 1, 1 << 24]])
    got = _streamed_on_card(cuda, sp, pk[pick], hi[pick], pv[pick])
    assert np.array_equal(got, pick)


@pytest.mark.parametrize("flow", [True, False])
def test_nf_using_kernels_share_z(cuda, flow):
    """The z of ``nf_forward``, ``fused_lookup``, ``streamed_lookup`` and
    ``fused_range_scan`` (its lower endpoints) are equal bit for bit on
    the same keys, with data and tombstones in both tiers."""
    nfl, keys, _expect = _written(cuda, flow)
    idx = nfl.index
    hi, lo = split_key_bits(keys)
    feats = torch.from_numpy(_feats(nfl, keys)).to(cuda)
    qhi = torch.from_numpy(hi.view(np.int32)).to(cuda)
    qlo = torch.from_numpy(lo.view(np.int32)).to(cuda)
    tp = idx._tier_pack()
    kw = dict(dim=nfl.cfg.flow.dim, shapes=nfl._shapes, use_flow=flow)
    _pf, zf = fused_lookup(feats, qhi, qlo, nfl._packed_w,
                           idx._kernel_pools(), tp, max_depth=idx.max_depth,
                           dense_iters=24, bucket_cap=6,
                           dense_window=idx.dense_window, **kw)
    _ps, zs = streamed_lookup(feats, qhi, qlo, nfl._packed_w,
                              idx._serving.stream_pack(), tp, **kw)
    zr = fused_range_scan(feats, feats, nfl._packed_w,
                          idx._serving.scan_pack(), tp, scan_cap=8, **kw)[3]
    torch.cuda.synchronize()
    for z in (zs, zr):
        assert torch.equal(zf.view(torch.int32), z.view(torch.int32))
    if flow:
        zn = nf_forward(feats, nfl._packed_w, nfl._shapes, nfl.cfg.flow.dim)
        assert torch.equal(zf.view(torch.int32), zn.view(torch.int32))


# ------------------------------------------------------------ LM kernels
# mamba_scan: h follows the plain version's arithmetic (one rounding per
# multiply and add, the same expf); y's N-term sum runs in another order,
# far inside the JAX test's 1e-4.  flash_decode: the JAX tests' bounds
# (2e-5 with an f32 cache, 2e-2 with a 16-bit one); the softmax sums run
# in another order.
SCAN_TOL = 1e-4


def _scan_args(b, l, di, n, seed, dev):
    g = torch.Generator().manual_seed(seed)
    dt = torch.nn.functional.softplus(torch.randn(b, l, di, generator=g))
    xi = torch.randn(b, l, di, generator=g)
    b_in = torch.randn(b, l, n, generator=g)
    c_out = torch.randn(b, l, n, generator=g)
    a_log = torch.randn(di, n, generator=g) * 0.5
    return [t.to(dev) for t in (dt, xi, b_in, c_out, a_log)]


# L 1, L inside one chunk (``scan_plan``: 32 steps at N 16, 16 at N 128),
# one step past a chunk and past two, di not a multiple of the 32-channel
# tile (and not of 4: the unvectorised staging), N at its 128 maximum
@pytest.mark.parametrize("b,l,di,n", [(1, 2048, 8192, 16), (2, 1000, 256, 16),
                                      (3, 77, 200, 8), (1, 50, 64, 48),
                                      (2, 33, 40, 1), (1, 1, 8192, 16),
                                      (2, 20, 96, 16), (1, 33, 1001, 16),
                                      (2, 17, 72, 128), (1, 65, 100, 16)])
def test_mamba_scan_kernel_matches_plain(cuda, b, l, di, n):
    args = _scan_args(b, l, di, n, l + n, cuda)
    before = mamba_scan.launches
    yk = mamba_scan(*args)
    yp = mamba_scan_plain(*args)
    torch.cuda.synchronize()
    assert mamba_scan.launches == before + 1
    assert yk.shape == (b, l, di) and bool(torch.isfinite(yk).all())
    torch.testing.assert_close(yk, yp, rtol=SCAN_TOL, atol=SCAN_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("b,h,kh,d,s", [(4, 40, 8, 128, 4096),
                                        (3, 8, 2, 64, 300),
                                        (3, 4, 4, 256, 130),
                                        (3, 6, 3, 40, 77)])
def test_flash_decode_kernel_matches_plain(cuda, dtype, b, h, kh, d, s):
    g = torch.Generator().manual_seed(b * h + s)
    q = (torch.randn(b, h, d, generator=g) / d ** 0.5).to(cuda)
    k = torch.randn(b, s, kh, d, generator=g).to(dtype).to(cuda)
    v = torch.randn(b, s, kh, d, generator=g).to(dtype).to(cuda)
    kv_len = torch.tensor([0, 1, s, s // 2][:b], dtype=torch.int32,
                          device=cuda)
    before = flash_decode.launches
    ok = flash_decode(q, k, v, kv_len)
    op = flash_decode_plain(q, k, v, kv_len)
    torch.cuda.synchronize()
    assert flash_decode.launches == before + 1
    assert ok.dtype == torch.float32 and not ok[0].any()
    # both sides widen k and v to f32 exactly, whatever their dtype, and
    # compute in f32: only the order of the sums differs
    torch.testing.assert_close(ok, op, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("kernel", ["flash_decode", "mamba_scan"])
def test_cuda_tensors_launch_under_a_work_counter(cuda, kernel):
    """A card tensor never takes the meta branch: under the dry run's
    work counter each wrapper still launches its kernel (one launch
    counted) and hands the counter no kernel work."""
    from repro_torch.utils.roofline import WorkCounter

    if kernel == "flash_decode":
        g = torch.Generator().manual_seed(3)
        q = torch.randn(2, 8, 64, generator=g).to(cuda)
        k = torch.randn(2, 100, 2, 64, generator=g).to(torch.bfloat16)
        args = (q, k.to(cuda), k.to(cuda),
                torch.tensor([100, 7], dtype=torch.int32, device=cuda))
        fn, plain, tol = flash_decode, flash_decode_plain, 2e-5
    else:
        args = _scan_args(2, 33, 40, 16, 5, cuda)
        fn, plain, tol = mamba_scan, mamba_scan_plain, SCAN_TOL
    before = fn.launches
    with WorkCounter() as wc:
        got = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1 and not wc.kernels
    torch.testing.assert_close(got, plain(*args), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("b,h,kh,d,s,lens,plan", [
    (1, 40, 8, 128, 32768, [32768], None),            # B 1 at S 32k
    (2, 8, 8, 64, 1000, [1000, 333], None),           # group size 1
    (2, 40, 8, 128, 5000, [5000, 2500], None),        # group size 5
    (2, 40, 2, 64, 300, [300, 131], None),            # 20 heads: 3 groups
    (2, 8, 2, 64, 4096, [512, 1024], DecodePlan(8, 512, 16)),  # on a split
    (3, 8, 2, 64, 1000, [1000, 999, 65], DecodePlan(4, 256, 16)),  # S % 16
    (2, 4, 2, 33, 100, [100, 50], None),              # odd D: 2-byte rows
])
def test_flash_decode_kernel_split_edges(cuda, dtype, b, h, kh, d, s, lens,
                                         plan):
    g = torch.Generator().manual_seed(b * h + s + d)
    q = (torch.randn(b, h, d, generator=g) / d ** 0.5).to(cuda)
    k = torch.randn(b, s, kh, d, generator=g).to(dtype).to(cuda)
    v = torch.randn(b, s, kh, d, generator=g).to(dtype).to(cuda)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=cuda)
    plan = plan or device_plan(q, k)
    before = flash_decode.launches
    ok = flash_decode(q, k, v, kv_len, plan)
    op = flash_decode_plain(q, k, v, kv_len, plan)
    torch.cuda.synchronize()
    assert flash_decode.launches == before + 1
    torch.testing.assert_close(ok, op, rtol=2e-5, atol=2e-5)
    # the default plan's result is the same function
    torch.testing.assert_close(ok, flash_decode(q, k, v, kv_len), rtol=2e-5,
                               atol=2e-5)


def test_lm_kernels_reject_bad_inputs(cuda):
    dt, xi, b_in, c_out, a_log = _scan_args(1, 16, 32, 8, 0, cuda)
    with pytest.raises(ValueError):            # wrong device
        mamba_scan(dt, xi, b_in, c_out, a_log.cpu())
    with pytest.raises(ValueError):            # wrong dtype
        mamba_scan(dt.double(), xi, b_in, c_out, a_log)
    with pytest.raises(ValueError):            # not contiguous
        mamba_scan(dt, xi, torch.cat([b_in, b_in], -1)[..., ::2], c_out,
                   a_log)
    with pytest.raises(ValueError):            # state wider than 128
        big = torch.zeros(1, 16, 129, device=cuda)
        mamba_scan(dt, xi, big, big, torch.zeros(32, 129, device=cuda))
    q = torch.zeros(2, 8, 64, device=cuda)
    k = torch.zeros(2, 32, 2, 64, device=cuda, dtype=torch.bfloat16)
    kv_len = torch.full((2,), 32, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):            # wrong device
        flash_decode(q, k, k, kv_len.cpu())
    with pytest.raises(ValueError):            # wrong dtype
        flash_decode(q, k, k, kv_len.long())
    with pytest.raises(ValueError):            # k and v differ in dtype
        flash_decode(q, k, k.float(), kv_len)
    with pytest.raises(ValueError):            # not contiguous
        flash_decode(q, k.transpose(1, 2), k.transpose(1, 2), kv_len)
    with pytest.raises(ValueError):            # H % KH != 0
        flash_decode(q[:, :7].contiguous(), k, k, kv_len)


def test_lm_serves_on_card_through_the_scan(cuda):
    """The falcon-mamba-7b smoke model on the card: every prefill layer
    launches the scan, and the batcher's tokens equal the chunked path's
    on the card and the port's on the CPU (f32, TF32 off)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.serve.scheduler import (ContinuousBatcher, Request,
                                             ServeConfig)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = get_config("falcon-mamba-7b", smoke=True)
    prompts = [np.array([5, 6, 7], np.int32), np.arange(40, dtype=np.int32),
               np.array([11, 3, 1, 8], np.int32)]

    def serve(cfg, dev, params):
        model = build_model(cfg, device=dev)
        b = ContinuousBatcher(model, params, ServeConfig(batch_slots=2,
                                                         max_len=64))
        reqs = [Request(rid=i, prompt=p, max_new_tokens=6)
                for i, p in enumerate(prompts)]
        for r in reqs:
            b.submit(r)
        b.run_until_drained()
        return [r.output for r in reqs]

    kcfg = dataclasses.replace(base, ssm=dataclasses.replace(
        base.ssm, use_scan_kernel=True))
    params = build_model(kcfg, cuda).init(
        torch.Generator(device=cuda).manual_seed(0))
    ops.reset_launch_counts()
    got = serve(kcfg, cuda, params)
    assert ops.launch_counts()["mamba_scan"] == base.n_layers * len(prompts)
    assert got == serve(base, cuda, params)
    cpu_params = {k: (v.cpu() if torch.is_tensor(v) else
                      {a: (b.cpu() if torch.is_tensor(b) else
                           {c: d.cpu() for c, d in b.items()})
                       for a, b in v.items()})
                  for k, v in params.items()}
    assert got == serve(kcfg, "cpu", cpu_params)


@pytest.mark.parametrize("arch", ["qwen3-14b", "zamba2-2.7b",
                                  "whisper-medium"])
def test_lm_families_decode_through_flash_decode_on_card(cuda, arch):
    """A smoke model of the dense, hybrid and encdec families on the card
    (f32, TF32 off): each decode step launches ``flash_decode`` once for
    every attention on the kernel route, and prefill and 4 greedy decode
    steps give the CPU's tokens, and logits within 1e-4 of the CPU's
    (the kernel's sums and cuBLAS's run in another order)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch, smoke=True)
    params = build_model(cfg, cuda).init(
        torch.Generator(device=cuda).manual_seed(0))

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        return tree.to(dev)

    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 12)))
    extra = None
    if cfg.family == "encdec":
        extra = {"frames": torch.from_numpy(np.random.default_rng(2)
                                            .standard_normal(
            (2, cfg.enc_seq, cfg.d_model)).astype(np.float32))}
    per_step = {"dense": cfg.n_layers,
                "hybrid": cfg.n_layers // cfg.hybrid_attn_every,
                "encdec": 2 * cfg.n_layers}[cfg.family]
    out = {}
    for dev in (cuda, torch.device("cpu")):
        model = build_model(cfg, dev)
        p = to(params, dev)
        x = None if extra is None else to(extra, dev)
        state, logits = model.prefill(p, toks.to(dev), 24, extra=x)
        seq, lgs = [], []
        for _ in range(4):
            tok = torch.argmax(logits, -1)[:, None]
            ops.reset_launch_counts()
            logits, state = model.decode_step(p, state, tok, extra=x)
            if dev.type == "cuda":
                assert ops.launch_counts()["flash_decode"] == per_step
            seq.append(tok.cpu())
            lgs.append(logits.cpu())
        out[dev.type] = (torch.cat(seq, 1), torch.stack(lgs))
    assert torch.equal(out["cuda"][0], out["cpu"][0])
    assert torch.allclose(out["cuda"][1], out["cpu"][1], rtol=1e-4,
                          atol=1e-4)


# ------------------------------------------------------------------
# the contract checker's broken fixture kernels (analysis/csrc/fixtures.cu)
def test_fixture_kernels_match_plain_at_the_edges(cuda):
    from repro_torch.analysis import fixtures as fx

    rng = np.random.default_rng(21)
    idx = np.arange(-40, 171, dtype=np.int32)            # both clamp edges
    table = rng.standard_normal(128).astype(np.float32)
    got = fx.clip_gather(torch.from_numpy(idx).to(cuda),
                         torch.from_numpy(table).to(cuda)).cpu()
    want = fx.clip_gather_plain(torch.from_numpy(idx),
                                torch.from_numpy(table))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    lanes = np.concatenate([[0, 0xFFFFFFFF, 1, 1 << 24, (1 << 24) + 1,
                             0x80000000],
                            rng.integers(0, 1 << 32, 4096, dtype=np.uint64)
                            ]).astype(np.uint32).view(np.int32)
    hi, lo = torch.from_numpy(lanes), torch.from_numpy(lanes[::-1].copy())
    got = fx.lane_cast(hi.to(cuda), lo.to(cuda)).cpu()
    assert torch.equal(got.view(torch.int32),
                       fx.lane_cast_plain(hi, lo).view(torch.int32))
    for b in (1, 33, 4096):
        q = torch.from_numpy(rng.standard_normal(b).astype(np.float32))
        pool = torch.from_numpy(rng.standard_normal(256).astype(np.float32))
        q[0] = pool[0]                                   # a tie counts
        got = fx.batch_loop(q.to(cuda), pool.to(cuda)).cpu()
        assert torch.equal(got, fx.batch_loop_plain(q, pool))
    table = fx.f64_table(8).numpy()
    pk = torch.from_numpy(np.concatenate(
        [rng.uniform(-0.2, 1.2, 4096), table, np.nextafter(table, 2),
         np.nextafter(table, -2), [-np.inf, np.inf]]).astype(np.float32))
    for n in (2, 8, 13):
        got = fx.f64_upcast(pk.to(cuda), n).cpu()
        assert torch.equal(got, fx.f64_upcast_plain(pk, n))
    # a launch counts once; an empty batch launches nothing
    before = fx.launch_counts()
    fx.clip_gather(torch.zeros(3, dtype=torch.int32, device=cuda),
                   torch.ones(4, device=cuda))
    assert fx.clip_gather(torch.zeros(0, dtype=torch.int32, device=cuda),
                          torch.ones(4, device=cuda)).shape == (0,)
    assert fx.launch_counts() == {**before,
                                  "clip_gather": before["clip_gather"] + 1}


def test_contract_checker_self_test_on_card(cuda, capsys):
    from repro_torch.analysis.__main__ import run_fixture_selftest

    assert run_fixture_selftest(cuda) == 0
    out = capsys.readouterr().out
    for name in ("clip-gather", "lane-cast", "batch-loop", "f64-upcast"):
        assert f"caught  fixture:{name}  @ fixtures.cu:" in out
    for name in ("host-fetch", "rung-realloc"):
        assert f"caught  fixture:{name}  @ fixtures.py:" in out


def test_committed_fixture_ptx_is_what_nvcc_emits(cuda):
    from pathlib import Path

    from repro_torch.utils.ptx import compile_ptx, normalize_ptx

    committed = (Path(__file__).resolve().parent / "data"
                 / "fixtures.ptx").read_text()
    assert normalize_ptx(compile_ptx("fixtures").read_text()) == committed


def test_contract_checker_clean_on_card(cuda):
    """Every contract over the real entries on the card: no blocking
    finding past the allowlist, no model drift, and the recorder's sync
    counts never below the sync debug mode's."""
    from repro_torch.analysis.__main__ import DEFAULT_ALLOWLIST, run_all
    from repro_torch.analysis.findings import Report, load_allowlist

    rep = Report(allowlist=load_allowlist(DEFAULT_ALLOWLIST))
    facts = run_all(rep, cuda)
    assert rep.ok, rep.render()
    assert not [f for f in rep.findings if f.contract == "smem:model-drift"]
    for name, st in facts["syncs"].items():
        assert st["syncs"] >= st["debug_syncs"], name
    assert facts["launches"] and facts["smem_launches"]
    assert any(f["params"].get("capacity") == 1 << 25
               for f in facts["smem_launches"])


def test_default_nfl_flow_on_card_reads_right(cuda):
    """``NFL(NFLConfig())``, the paper's AFLI backend, with no device:
    its flow trains and positions on the card (params on cuda), the tree
    serves every loaded key, misses the rest and reads inserts back, and
    the path launches no kernel."""
    from repro_torch.core.afli import AFLI

    keys = make_dataset("longlat", 40_000)
    pv = np.arange(keys.shape[0], dtype=np.int64)
    nfl = NFL(NFLConfig(force_flow=True,
                        flow_train=FlowTrainConfig(epochs=1)))
    assert isinstance(nfl.index, AFLI) and nfl.device.type == "cuda"
    ops.reset_launch_counts()
    nfl.bulkload(keys[::2], pv[::2])
    assert nfl.flow_params["out_log_scale"].device.type == "cuda"
    assert all(layer["w"].device.type == "cuda"
               for layer in nfl.flow_params["layers"])
    assert nfl.use_flow
    assert np.array_equal(nfl.lookup_batch(keys[::2]), pv[::2])
    assert (nfl.lookup_batch(keys[1::2]) == -1).all()
    nfl.insert_batch(keys[1::2], pv[1::2])
    assert np.array_equal(nfl.lookup_batch(keys), pv)
    # positioning is per key: a batch of one lands where the bulk did
    for i in range(0, keys.shape[0], 4999):
        assert nfl.lookup_batch(keys[i:i + 1])[0] == pv[i]
    assert sum(ops.launch_counts().values()) == 0


def test_page_table_lookup_launches_fused_lookup_once(cuda):
    """``NFLPageTable()`` on the card: each ``lookup`` call is one
    ``fused_lookup`` launch and no ``nf_forward``, with the flow on or
    off, and reads every page right."""
    from repro_torch.serve import NFLPageTable, composite_key

    rng = np.random.default_rng(0)
    seqs = np.repeat(rng.integers(0, 1 << 30, 128), 32)
    keys = np.unique(composite_key(seqs, np.tile(np.arange(32), 128)))
    pages = rng.permutation(keys.shape[0]).astype(np.int64)
    pt = NFLPageTable()
    pt.bulkload(keys, pages)
    for q in (keys, keys[::7], keys[:1]):
        ops.reset_launch_counts()
        got = pt.lookup(q)
        counts = ops.launch_counts()
        assert counts["fused_lookup"] == 1 and counts["nf_forward"] == 0
        assert sum(counts.values()) == 1
        assert np.array_equal(got, pages[np.searchsorted(keys, q)])
    new = composite_key(np.full(64, (1 << 31) + 5), np.arange(64))
    pt.insert(new, np.arange(64) + 10_000)
    ops.reset_launch_counts()
    assert np.array_equal(pt.lookup(new), np.arange(64) + 10_000)
    assert ops.launch_counts()["fused_lookup"] == 1


def _train_setup(dev, tcfg):
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.train.train_step import init_train_state

    cfg = get_config("internlm2-1.8b", smoke=True)
    cpu = build_model(cfg, device="cpu")
    state = init_train_state(cpu, torch.Generator().manual_seed(0), tcfg)
    return cfg, cpu, build_model(cfg, device=dev), state


def _state_to(state, dev):
    from repro_torch.train.checkpoint import tree_flatten, tree_unflatten

    return tree_unflatten(state, [x.to(dev) for _, x in tree_flatten(state)])


def test_train_steps_on_card_match_cpu(cuda):
    """Two AdamW steps (2 microbatches) of internlm2-1.8b's smoke config
    on the card against the port on the CPU from one state: the metrics
    and every state leaf within 1e-4 of the leaf's scale (f32; the card
    sums in other orders)."""
    from repro_torch.train.checkpoint import tree_flatten
    from repro_torch.train.train_step import TrainConfig, make_train_step
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.schedule import ScheduleConfig

    tcfg = TrainConfig(optimizer=AdamWConfig(lr=5e-3),
                       schedule=ScheduleConfig(peak_lr=5e-3, warmup_steps=1,
                                               total_steps=10),
                       microbatches=2)
    cfg, cpu, card, state = _train_setup(cuda, tcfg)
    on_card = _state_to(state, cuda)
    rng = np.random.default_rng(1)
    batches = [{k: torch.from_numpy(rng.integers(0, cfg.vocab, (4, 64))
                                    .astype(np.int32))
                for k in ("tokens", "targets")} for _ in range(2)]
    step_cpu, step_card = make_train_step(cpu, tcfg), make_train_step(card,
                                                                      tcfg)
    ops.reset_launch_counts()
    for b in batches:
        state, mc = step_cpu(state, b)
        on_card, mg = step_card(on_card, {k: v.to(cuda)
                                          for k, v in b.items()})
        for k in mc:
            assert abs(float(mg[k]) - float(mc[k])) <= 1e-4 * max(
                abs(float(mc[k])), 1e-6), k
    assert sum(ops.launch_counts().values()) == 0   # no kernel trains
    for (path, a), (_, b) in zip(tree_flatten(state),
                                 tree_flatten(on_card)):
        a, b = a.float(), b.float().cpu()
        assert float((a - b).abs().max()) <= 1e-4 * max(
            float(a.abs().max()), 1e-30), path


def test_checkpoint_round_trip_on_card(cuda, tmp_path):
    """A card train state saved (sync and async) and restored bit for
    bit; a trainer on the card resumes from its checkpoint."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import SyntheticTokens
    from repro_torch.models.model import build_model
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.train_step import TrainConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_config("internlm2-1.8b", smoke=True)

    def trainer():
        return Trainer(build_model(cfg, device=cuda),
                       TrainerConfig(ckpt_dir=str(tmp_path / "ck"),
                                     ckpt_every=3),
                       SyntheticTokens(vocab=cfg.vocab, seq=32,
                                       local_batch=2))

    a = trainer()
    a.run(6)
    want = [x.clone() for _, x in ckpt.tree_flatten(a.state)]
    assert all(x.device.type == "cuda" for x in want)
    b = trainer()
    assert b.initialize() == 6
    got = [x for _, x in ckpt.tree_flatten(b.state)]
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    ckpt.save_async(str(tmp_path / "other"), 6, a.state)
    ckpt.wait_pending()
    _, tree, _ = ckpt.restore_latest(str(tmp_path / "other"), a.state)
    assert all(torch.equal(x.to(cuda), y) for (_, x), y in zip(
        ckpt.tree_flatten(tree), want))
    assert b.run(8)["final_step"] == 8
