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
from repro_torch.core.train_flow import FlowTrainConfig, FlowTrainer
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
