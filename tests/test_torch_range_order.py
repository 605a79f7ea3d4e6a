"""The merge and probe order of the port's CUDA read kernels, on the CPU.

``csrc/range_scan.cu`` runs one warp per range: its six endpoint lower
bounds are 6-ary searches of five lanes each, then the first ``scan_cap``
candidates are merged 32 at a time by a co-rank count over the next 32
heads of each pool, each candidate's lower bound in the newer tiers comes
from the merge cursors (carried across rounds for a key whose equal
copies span two of them), and its identity is matched in the window
around that bound.  Both that kernel and ``csrc/fused_lookup.cu`` read a
tier's identity window hi first, four rows a load, then lo and pv only
where hi matched, newest first (``window_pv``).  Neither order can run
here, so this file writes each as a small plain function, step for step
as the kernel takes it, and holds it bit for bit to the plain versions
the kernels are held to on the card (``fused_range_scan_plain``,
``_probe_tier_plain``), over the cases of ``test_torch_range_scan.py`` and
hand-made pools with heavy key ties.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import flat_afli as tfa
from repro_torch.kernels.fused_lookup import (TOMBSTONE, TierPack, TierPools,
                                              _lower_bound_plain,
                                              _probe_tier_plain)
from repro_torch.kernels.range_scan import (ScanPack, ScanPool, _endpoints,
                                            fused_range_scan_plain)

from test_torch_range_scan import _CFG, _cases, _writes

torch.set_num_threads(1)

LANES = 32


# ------------------------------------------------------ the kernels' order
WINDOW_VEC_MAX = 8        # tier_device.cuh


def six_ary_lower_bound(pk, n, q) -> int:
    """The range kernel's endpoint search: five lanes read the pivots
    l + (h - l) * (r + 1) // 6, r < 5, of the bracket [l, h); the count
    t of pivots below q picks the next bracket."""
    keys = pk.numpy() if isinstance(pk, torch.Tensor) else pk
    q = np.float32(q)
    l, h = 0, int(n)
    while l < h:
        d = h - l
        piv = [l + d * (r + 1) // 6 for r in range(5)]
        below = [bool(keys[p] < q) for p in piv]
        t = sum(below)
        assert below == [True] * t + [False] * (5 - t)
        lo_t, hi_t = l + d * t // 6, l + d * (t + 1) // 6
        if t > 0:
            l = lo_t + 1
        if t < 5:
            h = hi_t
    return l


def window_pv(hi, lo, pv, n, window, l, qhi, qlo) -> int:
    """``window_pv`` of tier_device.cuh: the window [l - W, l + 3W)
    clipped to [0, n); hi in aligned chunks of four rows (a bit per
    row), then lo and pv at the hi matches, newest first.  Wider windows
    go row by row."""
    l, n, window = int(l), int(n), int(window)
    j0, j1 = max(l - window, 0), min(l + 3 * window, n)
    if j0 >= j1:
        return -1
    if window > WINDOW_VEC_MAX:
        last = -1
        for j in range(j0, j1):
            if hi[j] == qhi and lo[j] == qlo:
                last = j
        return int(pv[last]) if last >= 0 else -1
    k0, k1 = j0 >> 2, (j1 - 1) >> 2
    assert k1 - k0 <= WINDOW_VEC_MAX
    base = 4 * k0
    m = 0
    for c in range(k1 - k0 + 1):
        for t in range(4):
            m |= int(hi[base + 4 * c + t] == qhi) << (4 * c + t)
    m &= ~((1 << (j0 - base)) - 1) & ((1 << (j1 - base)) - 1)
    while m:
        b = m.bit_length() - 1
        if lo[base + b] == qlo:
            return int(pv[base + b])
        m &= ~(1 << b)
    return -1


def warp_order_scan(feats_lo, feats_hi, packed_w, scan_pack, tiers, *, dim,
                    shapes=(), scan_cap, use_flow=True):
    """``range_scan.cu``'s order for every range: endpoint bounds, then
    rounds of up to 32 candidates ranked by co-rank counts over the pools'
    next heads, bounds in the newer tiers from the cursors, the windows,
    and compaction in rank order.  Returns what the kernel returns."""
    zlo, zhi = _endpoints(feats_lo, feats_hi, packed_w, shapes, dim,
                          use_flow)
    s = scan_pack.pool
    inf = np.float32(np.inf)
    pools = [None, None, (s.pk.numpy(), s.hi.numpy(), s.lo.numpy(),
                          s.pv.numpy())]
    lens = [0, 0, int(s.plen.item())]
    windows = [1, 1, 1]
    bounds = [[[0] * zlo.shape[0]] * 2] * 2
    if tiers is not None:
        t = tiers.pools
        pools[0] = (t.dl_pk.numpy(), t.dl_hi.numpy(), t.dl_lo.numpy(),
                    t.dl_pv.numpy())
        pools[1] = (t.run_pk.numpy(), t.run_hi.numpy(), t.run_lo.numpy(),
                    t.run_pv.numpy())
        lens[0], lens[1] = int(t.dl_len.item()), int(t.run_len.item())
        windows[0], windows[1] = tiers.delta_window, tiers.run_window
        bounds = [[[six_ary_lower_bound(t.dl_pk, lens[0], x) for x in z]
                   for z in (zlo, zhi)],
                  [[six_ary_lower_bound(t.run_pk, lens[1], x) for x in z]
                   for z in (zlo, zhi)]]
    bounds.append([[six_ary_lower_bound(s.pk, lens[2], x) for x in z]
                   for z in (zlo, zhi)])
    b = zlo.shape[0]
    out = np.full((b, scan_cap), -1, np.int32)
    cnt_out = np.zeros(b, np.int32)
    tot_out = np.zeros(b, np.int32)
    lanes = np.arange(LANES)
    for i in range(b):
        start = [int(bounds[p][0][i]) for p in range(3)]
        end = [max(int(bounds[p][1][i]), start[p]) for p in range(3)]
        total = sum(e - a for a, e in zip(start, end))
        considered = min(total, scan_cap)
        cur = list(start)
        cnt = done = 0
        prev = None                     # (key, ld, lr) of the last merged
        while done < considered:
            c = min(LANES, considered - done)
            heads, valid = [], []
            for p in range(3):
                v = cur[p] + lanes < end[p]
                k = np.full(LANES, inf, np.float32)
                if v.any():
                    k[v] = pools[p][0][cur[p] + lanes[v]]
                heads.append(k)
                valid.append(v)
            dk, rk, sk = heads

            def lt(pool_keys, x):
                return (pool_keys[None, :] < x[:, None]).sum(1)

            def le(pool_keys, x):
                return (pool_keys[None, :] <= x[:, None]).sum(1)

            rank = [lanes + lt(rk, dk) + lt(sk, dk),
                    lanes + le(dk, rk) + lt(sk, rk),
                    lanes + le(dk, sk) + le(rk, sk)]
            slots = {}
            for p in range(3):
                ltd, ltr = lt(dk, heads[p]), lt(rk, heads[p])
                for ln in np.flatnonzero(valid[p] & (rank[p] < c)):
                    key = heads[p][ln]
                    if prev is not None and key == prev[0]:
                        ld, lr = prev[1], prev[2]
                    else:
                        ld, lr = cur[0] + ltd[ln], cur[1] + ltr[ln]
                    slots[int(rank[p][ln])] = (p, cur[p] + ln, key, ld, lr)
            assert sorted(slots) == list(range(c))
            for p in range(3):
                cur[p] += int((valid[p] & (rank[p] < c)).sum())
            for r in range(c):
                p, j, _key, ld, lr = slots[r]
                chi, clo, cpv = (pools[p][1][j], pools[p][2][j],
                                 int(pools[p][3][j]))
                dw = (window_pv(*pools[0][1:], lens[0], windows[0], ld, chi,
                                clo) if p > 0 and tiers is not None else -1)
                rw = (window_pv(*pools[1][1:], lens[1], windows[1], lr, chi,
                                clo) if p == 2 and tiers is not None else -1)
                if dw == -1 and rw == -1 and cpv != TOMBSTONE:
                    out[i, cnt] = cpv
                    cnt += 1
            prev = slots[c - 1][2:]
            done += c
        cnt_out[i], tot_out[i] = cnt, total
    return (torch.from_numpy(out), torch.from_numpy(cnt_out),
            torch.from_numpy(tot_out), zlo, zhi)


# ------------------------------------------------------------ harness
def _port(keys, **cfg):
    pt = tfa.FlatAFLI(tfa.FlatAFLIConfig(**{**_CFG, **cfg}), device="cpu")
    if keys is not None:
        pt.build(keys, np.arange(keys.shape[0], dtype=np.int64))
    return pt


def _check(pt, lo, hi, cap):
    """The warp order against the plain version on the index's pools,
    bit for bit; returns the plain version's (pv, cnt, tot)."""
    flo = torch.from_numpy(np.asarray(lo, np.float64).astype(np.float32)
                           .reshape(-1, 1))
    fhi = torch.from_numpy(np.asarray(hi, np.float64).astype(np.float32)
                           .reshape(-1, 1))
    args = (flo, fhi, None, pt._serving.scan_pack(), pt._tier_pack())
    kw = dict(dim=1, scan_cap=cap, use_flow=False)
    return _same(args, kw)


def _same(args, kw):
    want = fused_range_scan_plain(*args, **kw)
    got = warp_order_scan(*args, **kw)
    for name, g, w in zip(("pv", "cnt", "tot", "zlo", "zhi"), got, want):
        assert g.dtype == w.dtype, name
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w), name
    return [x.numpy() for x in want[:3]]


# ------------------------------------------------ the cases of the range tests
def test_order_with_tiers_and_tombstones():
    rng = np.random.default_rng(0)
    keys = np.unique(rng.uniform(0, 1e9, 1500))
    pt = _port(keys)
    _writes(rng, (pt,), keys)
    st = pt.stats()
    assert st["run_len"] and st["delta_len"]
    lo, hi = _cases(keys, rng)
    wide = keys[rng.integers(0, keys.shape[0] - 120, 8)]
    lo = np.concatenate([lo, wide])
    hi = np.concatenate([hi, keys[np.searchsorted(keys, wide) + 100]])
    pv, cnt, tot = _check(pt, lo, hi, cap=96)
    assert (tot > cnt).any() and (cnt > LANES).any()


def test_order_empty_and_inverted_ranges():
    rng = np.random.default_rng(1)
    keys = np.unique(rng.uniform(0, 1e9, 800))
    pt = _port(keys)
    _writes(rng, (pt,), keys, n_rounds=2)
    gap = (keys[10] + keys[11]) / 2
    lo = np.array([keys[5], keys[99], gap, keys[300], -1e12])
    hi = np.array([keys[5], keys[50], np.nextafter(keys[11], 0), keys[2],
                   -1e11])
    pv, cnt, tot = _check(pt, lo, hi, cap=32)
    assert (cnt == 0).all() and (tot == 0).all() and (pv == -1).all()


def test_order_across_node_boundaries():
    rng = np.random.default_rng(2)
    keys = np.unique(np.floor(rng.lognormal(0, 2, 3000) * 1e9))
    pt = _port(keys)
    assert pt.stats()["n_nodes"] > 1
    _writes(rng, (pt,), keys, n_rounds=2)
    lo = keys[rng.integers(0, keys.shape[0] - 300, 16)]
    hi = keys[np.searchsorted(keys, lo) + 250]
    _check(pt, lo, hi, cap=512)


def test_order_duplicate_f32_keys_and_wide_windows():
    """Distinct identities on one f32 key: the windows are wider than 1,
    and the run, the delta and the scan pool tie on one key."""
    rng = np.random.default_rng(3)
    keys = np.unique(np.concatenate([rng.uniform(0, 1e9, 500),
                                     1e15 + np.arange(64.0)]))
    pt = _port(keys)
    pt.insert_batch(1e15 + np.arange(64.0, 80.0), np.arange(16) + 900)
    pt.delete_batch(1e15 + np.arange(0.0, 64.0, 5.0))
    pt.insert_batch(1e15 + np.arange(80.0, 84.0), np.arange(4) + 950)
    st = pt.stats()["serving"]
    assert st["run_window"] > 1 and st["scan_window"] > 1
    pv, cnt, tot = _check(pt, [1e15 - 1e8, 1e15 - 1e8, 0.0],
                          [1e15 + 1e8, 1e15, 1e16], cap=128)
    assert cnt[0] == 84 - 13 and tot[0] == 84 + 13


@pytest.mark.parametrize("cap", [16, 31, 32, 33, 64, 70])
def test_order_truncation_with_a_tie_on_the_cut(cap):
    """A run of 40 equal f32 keys in all three pools, cut by ``scan_cap``
    inside the run of ties (and across a 32-candidate round)."""
    base = np.unique(np.random.default_rng(4).uniform(0, 1e9, 400))
    tie = 1e15 + np.arange(0.0, 40.0)
    pt = _port(np.concatenate([base, tie]))
    pt.insert_batch(1e15 + np.arange(40.0, 60.0), np.arange(20) + 700)
    pt.insert_batch(tie[::3], np.arange(14) + 800)         # run copies
    pt.insert_batch(1e15 + np.arange(60.0, 64.0), np.arange(4) + 900)
    pt.insert_batch(tie[1::7], np.arange(6) + 950)         # delta copies
    st = pt.stats()
    assert st["run_len"] and st["delta_len"]
    pv, cnt, tot = _check(pt, [1e15 - 1e8, base[10]], [1e15 + 1e8, base[90]],
                          cap=cap)
    assert tot[0] > cap and cnt[0] <= cap


def test_order_after_a_fold_and_before_any_build():
    rng = np.random.default_rng(5)
    keys = np.unique(rng.uniform(0, 1e9, 1200))
    pt = _port(keys)
    _writes(rng, (pt,), keys)
    lo, hi = _cases(keys, rng)
    _check(pt, lo, hi, cap=128)
    pt.rebuild()
    _writes(rng, (pt,), keys, n_rounds=1)
    _check(pt, lo, hi, cap=128)
    empty = _port(None)
    empty.insert_batch(np.arange(10.0, 300.0, 10.0), np.arange(29))
    empty.delete_batch(np.array([30.0, 120.0]))
    _check(empty, [15.0, 0.0], [45.0, 1e6], cap=64)


def _tier(keys, hi, lo, pv, cap):
    n = keys.shape[0]
    pk = np.full(cap, np.inf, np.float32)
    pk[:n] = keys
    pad = np.zeros(cap - n, np.int32)
    return (torch.from_numpy(pk), torch.from_numpy(np.concatenate([hi, pad])),
            torch.from_numpy(np.concatenate([lo, pad])),
            torch.from_numpy(np.concatenate([pv, pad - 1])),
            torch.tensor([n], dtype=torch.int32))


@pytest.mark.parametrize("seed", range(6))
def test_order_on_hand_made_pools_with_heavy_ties(seed):
    """Three sorted pools over a few dozen distinct f32 keys (so most
    candidates tie across pools and across rounds), identities drawn
    from a small set (so windows match copies at and beside the key),
    tombstones, -0.0 beside +0.0, windows 1-4 and caps around the round
    size."""
    rng = np.random.default_rng(100 + seed)
    grid = np.unique(rng.integers(-30, 30, 40)).astype(np.float32)
    grid[grid == 0] = -0.0 if seed % 2 else 0.0
    ident = rng.integers(0, 12, (3, 400)).astype(np.int32)

    def pool(n, cap):
        keys = np.sort(rng.choice(grid, n)).astype(np.float32)
        if seed % 3 == 0:
            keys[keys == 0] = np.where(rng.random((keys == 0).sum()) < 0.5,
                                       np.float32(0.0), np.float32(-0.0))
        k = rng.integers(0, 400, n)
        pv = rng.integers(0, 1000, n).astype(np.int32)
        pv[rng.random(n) < 0.15] = TOMBSTONE
        return _tier(keys, ident[0, k], ident[1, k], pv, cap)

    s = pool(int(rng.integers(50, 300)), 512)
    r = pool(int(rng.integers(0, 200)), 256)
    d = pool(int(rng.integers(0, 80)), 128)
    scan = ScanPack(ScanPool(*s), iters=10)
    tiers = TierPack(TierPools(*r, *d), run_iters=9,
                     run_window=int(rng.choice([1, 2, 4])), delta_iters=8,
                     delta_window=int(rng.choice([1, 2, 4])))
    lo = rng.choice(grid, 40).astype(np.float32)
    hi = np.where(rng.random(40) < 0.8, lo + rng.integers(0, 30, 40),
                  lo - 3).astype(np.float32)
    cap = int(rng.choice([8, 32, 33, 64, 200]))
    args = (torch.from_numpy(lo.reshape(-1, 1)),
            torch.from_numpy(hi.reshape(-1, 1)), None, scan, tiers)
    _same(args, dict(dim=1, scan_cap=cap, use_flow=False))
    _same(args[:4] + (None,), dict(dim=1, scan_cap=cap, use_flow=False))


# ------------------------------------------------ the searches
@pytest.mark.parametrize("cap", [1, 7, 128, 4097, 1 << 17])
def test_six_ary_search_is_lower_bound(cap):
    """The endpoint search finds the index ``lower_bound``'s fixed rounds
    find, at every live length, for keys on, between, below and above
    the pool's, ties and signed zeros included."""
    rng = np.random.default_rng(cap)
    # the tiers and the scan pool keep a row of +inf padding: n < cap
    for n in sorted({0, min(1, cap - 1), cap // 3, cap - 1}):
        vals = np.sort(rng.integers(-50, 50, n).astype(np.float32))
        vals[vals == 0] = -0.0
        pk = torch.full((cap,), float("inf"))
        pk[:n] = torch.from_numpy(vals)
        q = np.concatenate([vals[:200], vals[-50:], [-np.inf, np.inf,
                            np.nan, 0.0, -0.0, -1e9, 1e9],
                            rng.uniform(-60, 60, 100)]).astype(np.float32)
        want = _lower_bound_plain(pk, torch.tensor([n], dtype=torch.int32),
                                  max(cap, 1).bit_length(),
                                  torch.from_numpy(q))
        got = [six_ary_lower_bound(pk, n, x) for x in q]
        assert got == want.tolist(), n


# ------------------------------------------------ the identity window
@pytest.mark.parametrize("window", [1, 2, 4, 8, 9])
def test_window_pv_is_probe_tier(window):
    """``window_pv`` (hi over the window, then lo and pv where hi matched,
    newest first) at ``lower_bound``'s index returns what ``probe_tier``
    returns, at windows read four rows a load and wider ones read row by
    row, with repeated identities around the key."""
    rng = np.random.default_rng(9 + window)
    n, cap = 300, 512
    keys = np.sort(rng.integers(0, 40, n)).astype(np.float32)
    hi = rng.integers(0, 5, n).astype(np.int32)
    lo = rng.integers(0, 5, n).astype(np.int32)
    pv = rng.integers(0, 100, n).astype(np.int32)
    pk, thi, tlo, tpv, tlen = _tier(keys, hi, lo, pv, cap)
    q = rng.integers(-2, 42, 200).astype(np.float32)
    qh = rng.integers(0, 5, 200).astype(np.int32)
    ql = rng.integers(0, 5, 200).astype(np.int32)
    qt = torch.from_numpy(q)
    want = _probe_tier_plain(pk, thi, tlo, tpv, tlen, 10, window, qt,
                             torch.from_numpy(qh), torch.from_numpy(ql))
    bound = _lower_bound_plain(pk, tlen, 10, qt).tolist()
    got = [window_pv(hi, lo, pv, n, window, b, a, c)
           for b, a, c in zip(bound, qh, ql)]
    assert got == want.tolist()
