"""The search order of the port's CUDA streamed-lookup kernel, on the CPU.

``csrc/streamed_lookup.cu`` finds a query's tiles with a binary search
over the router (held in shared memory) and a walk down the bracket,
then searches each tile in aligned 8-row blocks placed by
interpolation (``Isearch`` in ``tier_device.cuh``) and matches the
identity window hi first, then lo and pv where hi matched, newest first
(``window_newest``).  The delta and the run are searched the same way,
stepping together, and matched with ``window_pv``.  None of that can run here, so this file
writes the kernel's order as a small plain function, step for step, and
holds it bit for bit to ``streamed_lookup_plain`` (the kernel's plain
version on the card) and the search to searchsorted-left, over
the pools of ``test_torch_streamed.py`` and hand-made ones: a partly
live last tile, runs of equal keys across a tile edge, signed zeros and
``+inf`` padding, an empty pool, windows above ``WINDOW_VEC_MAX``, and a
2^25-row capacity, whose router is 128 KB.  ``_pool`` and ``_tiers``
serve the card tests too, so this module imports no JAX at its top.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.flat_afli import split_key_bits
from repro_torch.kernels.fused_lookup import (TOMBSTONE, TierPack, TierPools,
                                              _lower_bound_plain)
from repro_torch.kernels.nf_forward import nf_forward_plain
from repro_torch.kernels.range_scan import ScanPool
from repro_torch.kernels.streamed_lookup import (STREAM_ALIGN, StreamPack,
                                                 build_router,
                                                 streamed_lookup_plain)

torch.set_num_threads(1)

ISEARCH_ROWS = 8          # tier_device.cuh
ISEARCH_NARROW = 4096
ISEARCH_GUESSES = 4
WINDOW_VEC_MAX = 8
_I32 = 1 << 32


# ------------------------------------------------------ the kernel's order
def ord32(x) -> int:
    """``ord_f32``: the int32 total-order image of an f32."""
    i = int(np.float32(x).view(np.int32))
    return i if i >= 0 else -(1 << 31) - i


def add_wrap(x: int, d: int) -> int:
    """x + d in int32 with wrap-around."""
    return (x + d + (1 << 31)) % _I32 - (1 << 31)


def isearch(pk, n, q, kl, kh, reads=None) -> int:
    """``Isearch`` of tier_device.cuh: searchsorted-left of ``q`` over
    ``pk[:n]``, ``kl`` the key of row 0 and ``kh`` one at or above every
    live row.  Each round reads one aligned block of ISEARCH_ROWS rows:
    at the bracket's middle while it spans more than ISEARCH_NARROW rows,
    then at a guess interpolated between the bracket's bounding keys (at
    most ISEARCH_GUESSES times), four rows a load, none past the multiple
    of 4 above ``n``; the first row of each load goes to ``reads``."""
    q, kl, kh = np.float32(q), np.float32(kl), np.float32(kh)
    n = int(n)
    l, h = 0, n
    if q <= kl:
        h = 0
    elif q > kh:
        l = n
    guesses = 0
    while l < h:
        g = (l + h) >> 1
        span = np.float32(kh - kl)
        if (h - l <= ISEARCH_NARROW and guesses < ISEARCH_GUESSES
                and kl < q < kh and span < np.inf):
            g = l + int(np.float32(np.float32(q - kl) / span)
                        * np.float32(h - l))
            guesses += 1
        s = min(max(g - ISEARCH_ROWS // 2, l), max(h - ISEARCH_ROWS, l))
        b = s & ~7
        for c in range(ISEARCH_ROWS // 4):
            r = b + 4 * c
            if r < h and r + 3 >= l:
                assert r + 4 <= -(-n // 4) * 4
                if reads is not None:
                    reads.append(r)
        f, e = max(b, l), min(b + ISEARCH_ROWS, h)
        below = sum(1 for j in range(f, e) if pk[j] < q)
        if below == 0:
            h, kh = f, pk[f]
        elif below == e - f:
            l, kl = e, pk[e - 1]
        else:
            l = h = f + below
    return l


def window_newest(hi, lo, n, window, l, qhi, qlo) -> int:
    """``window_newest``: the index of the newest identity match in
    [l - W, l + 3W) clipped to [0, n), -1 if none; hi in aligned chunks
    of four rows (a bit per row), then lo at the hi matches, newest
    first.  Wider windows go row by row."""
    j0, j1 = max(l - window, 0), min(l + 3 * window, n)
    if j0 >= j1:
        return -1
    if window > WINDOW_VEC_MAX:
        last = -1
        for j in range(j0, j1):
            if hi[j] == qhi and lo[j] == qlo:
                last = j
        return last
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
            return base + b
        m &= ~(1 << b)
    return -1


def _np(t):
    return t.numpy()


def streamed_order(feats, qhi, qlo, packed_w, stream, tiers=None, *, dim,
                   shapes=(), use_flow=True):
    """``streamed_lookup.cu``'s order for every query: the router's
    binary search for t1 + 1, the walk down the bracket, each tile's
    block search and identity window, then both tiers' block searches
    and windows, delta > run > pool, TOMBSTONE a miss.  Returns what the
    kernel returns."""
    if use_flow:
        z = nf_forward_plain(feats, packed_w, shapes, dim)
    else:
        z = feats[:, 0].to(torch.float32)
    q = _np(z)
    pool = stream.pool
    pk, hi, lo, pv = (_np(x) for x in pool[:4])
    plen = int(pool.plen.reshape(-1)[0])
    router = _np(stream.router)
    cap = pk.shape[0]
    assert cap % 4 == 0 and router.shape[0] >= -(-cap // STREAM_ALIGN) + 1
    n_tiles = -(-plen // STREAM_ALIGN)
    tier = None
    if tiers is not None:
        t = tiers.pools
        tier = [(_np(t.dl_pk), _np(t.dl_hi), _np(t.dl_lo), _np(t.dl_pv),
                 int(t.dl_len[0]), tiers.delta_window),
                (_np(t.run_pk), _np(t.run_hi), _np(t.run_lo),
                 _np(t.run_pv), int(t.run_len[0]), tiers.run_window)]
    out = np.empty(q.shape[0], np.int32)
    for i, (x, h_, l_) in enumerate(zip(q, _np(qhi), _np(qlo))):
        oz = ord32(x)
        lt, ht = 0, n_tiles
        while lt < ht:
            mid = (lt + ht) >> 1
            if add_wrap(ord32(router[mid]), -2) <= oz:
                lt = mid + 1
            else:
                ht = mid
        res = -1
        for t in range(lt - 1, -1, -1):
            if add_wrap(ord32(router[t + 1]), 2) < oz:
                break
            base = t * STREAM_ALIGN
            live = min(plen - base, STREAM_ALIGN)
            lb = isearch(pk[base:], live, x, router[t], router[t + 1])
            # the 11-round tile search, reads clamped to the tile, steps
            # one past a tile whose rows are all live
            if lb == live == min(cap - base, STREAM_ALIGN):
                lb += 1
            j = window_newest(hi[base:], lo[base:], live, stream.window, lb,
                              h_, l_)
            if j >= 0:
                res = int(pv[base + j])
                break
        if tier is not None:
            got = []
            for tpk, thi, tlo, tpv, n, w in tier:
                lb = isearch(tpk, n, x, tpk[0], tpk[max(n - 1, 0)])
                j = window_newest(thi, tlo, n, w, lb, h_, l_)
                got.append(int(tpv[j]) if j >= 0 else -1)
            dv, rv = got
            res = dv if dv != -1 else (rv if rv != -1 else res)
        out[i] = -1 if res == TOMBSTONE else res
    return torch.from_numpy(out), z


def _same(args, kw):
    pay, z = streamed_order(*args, **kw)
    ppay, pz = streamed_lookup_plain(*args, **kw)
    assert torch.equal(pay, ppay)
    assert torch.equal(z.view(torch.int32), pz.view(torch.int32))
    return pay


def _i32(x):
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


def _pool(keys, hi, lo, pv, cap):
    """A scan pool of the sorted ``keys`` padded with ``+inf`` to ``cap``
    rows, and its router."""
    n = keys.shape[0]
    pk = np.full(cap, np.inf, np.float32)
    pk[:n] = keys
    pad = np.zeros(cap - n, np.int32)
    pool = ScanPool(torch.from_numpy(pk),
                    torch.from_numpy(np.concatenate([hi, pad])),
                    torch.from_numpy(np.concatenate([lo, pad])),
                    torch.from_numpy(np.concatenate([pv, pad - 1])),
                    torch.tensor([n], dtype=torch.int32))
    return pool, build_router(pool.pk)


def _tiers(rng, grid, ident, sizes=(300, 40), windows=(2, 1)):
    """A run and a delta over ``grid``'s keys with identities from
    ``ident``, tombstones among their payloads."""
    parts = []
    for n, cap in zip(sizes, (512, 64)):
        keys = np.sort(rng.choice(grid, n)).astype(np.float32)
        k = rng.integers(0, ident.shape[1], n)
        pv = rng.integers(0, 1000, n).astype(np.int32)
        pv[rng.random(n) < 0.2] = TOMBSTONE
        p, _r = _pool(keys, ident[0, k], ident[1, k], pv, cap)
        parts.append(p)
    return TierPack(TierPools(*parts[0], *parts[1]), run_iters=10,
                    run_window=windows[0], delta_iters=7,
                    delta_window=windows[1])


# ------------------------------------------------ the block search
@pytest.mark.parametrize("dist", ["uniform", "ties", "skewed"])
@pytest.mark.parametrize("n", [0, 1, 3, 16, 17, 100, 1023, 1024, 5000])
def test_isearch_is_searchsorted_left(dist, n):
    """At every live length, over near-uniform keys (what the guesses
    assume), heavy ties and skewed keys (where they miss), for keys on,
    between, below and above the pool's, signed zeros, infinities and
    NaN, steered by the row-0 key and by the next key or +inf: the index
    searchsorted-left gives, and the binary search the plain versions
    take."""
    rng = np.random.default_rng(31 * n + len(dist))
    cap = -(-(n + 1) // 4) * 4          # a row of +inf padding
    if dist == "uniform":
        vals = np.sort(rng.uniform(-60, 60, n)).astype(np.float32)
    elif dist == "ties":
        vals = np.sort(rng.integers(-6, 6, n)).astype(np.float32)
        vals[vals == 0] = np.where(rng.random((vals == 0).sum()) < 0.5,
                                   np.float32(0.0), np.float32(-0.0))
    else:
        vals = np.sort(np.exp(rng.uniform(-8, 8, n))).astype(np.float32)
    pk = np.full(cap, np.inf, np.float32)
    pk[:n] = vals
    q = np.concatenate([vals[:100], vals[-30:],
                        [-np.inf, np.inf, np.nan, 0.0, -0.0, -1e9, 1e9],
                        rng.uniform(-70, 70, 100),
                        np.exp(rng.uniform(-9, 9, 50))]).astype(np.float32)
    want = np.searchsorted(vals, q, side="left")
    want[np.isnan(q)] = 0
    plain = _lower_bound_plain(torch.from_numpy(pk),
                               torch.tensor([n], dtype=torch.int32),
                               cap.bit_length(), torch.from_numpy(q))
    assert want.tolist() == plain.tolist()
    kl = pk[0] if n else np.float32(0)
    for kh in ((pk[n - 1] if n else np.float32(0)), np.float32(np.inf),
               np.float32(1e9)):
        if n and kh < pk[n - 1]:
            continue
        got = [isearch(pk, n, x, kl, kh) for x in q]
        assert got == want.tolist(), kh


def test_isearch_reads_few_blocks_on_uniform_keys():
    """Over uniform keys, steered by the tile's first and the next
    tile's first keys, a search of a 1,024-row tile reads under three
    one-sector blocks on average (the binary search reads 11 rows in 8 or
    so sectors)."""
    rng = np.random.default_rng(4)
    keys = np.sort(rng.uniform(0, 1, 2048)).astype(np.float32)
    blocks = []
    for x in rng.choice(keys[:1024], 500):
        reads = []
        got = isearch(keys, 1024, x, keys[0], keys[1024], reads)
        assert got == np.searchsorted(keys[:1024], x, side="left")
        blocks.append(len({r // ISEARCH_ROWS for r in reads}))
    assert np.mean(blocks) < 3


@pytest.mark.parametrize("window", [1, 2, 4, 8, 9, 24])
def test_window_newest_is_the_plain_window(window):
    """``window_newest`` at the searched index matches the newest identity
    the plain versions' window finds, at windows read four rows a load
    and wider ones read row by row, with repeated identities."""
    from repro_torch.kernels.fused_lookup import _probe_index_plain

    rng = np.random.default_rng(50 + window)
    n, cap = 300, 512
    keys = np.sort(rng.integers(0, 40, n)).astype(np.float32)
    hi = rng.integers(0, 5, n).astype(np.int32)
    lo = rng.integers(0, 5, n).astype(np.int32)
    pool, _r = _pool(keys, hi, lo, np.arange(n, dtype=np.int32), cap)
    q = rng.integers(-2, 42, 200).astype(np.float32)
    qh = rng.integers(0, 5, 200).astype(np.int32)
    ql = rng.integers(0, 5, 200).astype(np.int32)
    want = _probe_index_plain(pool.pk, pool.hi, pool.lo, pool.plen, 10,
                              window, torch.from_numpy(q),
                              torch.from_numpy(qh), torch.from_numpy(ql))
    pk = pool.pk.numpy()
    got = [window_newest(hi, lo, n, window,
                         isearch(pk, n, x, pk[0], pk[n - 1]), a, c)
           for x, a, c in zip(q, qh, ql)]
    assert got == want.tolist()


# ------------------------------------------------ the whole order
@pytest.mark.parametrize("seed", [5, 6])
def test_order_on_the_streamed_pools_flow_off(seed):
    """The pools of ``test_torch_streamed.py``: runs of equal keys across
    the 1,024-row tile edges (windows of 24 and more), data, updates and
    tombstones in the run and the delta; with and without the tiers."""
    from test_torch_streamed import _written_flat  # imports JAX

    idx, truth, q = _written_flat(np.random.default_rng(seed))
    sp, tp = idx._serving.stream_pack(), idx._tier_pack()
    assert sp.window > WINDOW_VEC_MAX
    hi, lo = split_key_bits(q)
    feats = torch.from_numpy(q.astype(np.float32).reshape(-1, 1))
    args = (feats, _i32(hi), _i32(lo), None, sp)
    pay = _same(args + (tp,), dict(dim=1, use_flow=False))
    assert pay.tolist() == [truth.get(k, -1) for k in q]
    _same(args, dict(dim=1, use_flow=False))


def test_order_on_the_streamed_pools_flow_on():
    """Flow on: the NF's z locates, fresh and after writes that leave
    data and tombstones in both tiers."""
    from test_torch_streamed import _flow_nfl  # imports JAX

    nfl, keys, pv = _flow_nfl(3000)
    idx = nfl.index
    q = np.concatenate([keys[::5], keys[1::9]])
    hi, lo = split_key_bits(q)
    args = (torch.from_numpy(nfl._feats(q)), _i32(hi), _i32(lo),
            nfl._packed_w, idx._serving.stream_pack())
    kw = dict(dim=nfl.cfg.flow.dim, shapes=nfl._shapes, use_flow=True)
    truth = dict(zip(keys[::2], pv[::2]))
    assert _same(args, kw).tolist() == [truth.get(k, -1) for k in q]
    nfl.insert_batch(keys[1::2][:200], pv[1::2][:200] + 5)
    nfl.delete_batch(keys[::2][:90])
    nfl.insert_batch(keys[1::2][200:210], pv[1::2][200:210] + 5)
    nfl.delete_batch(keys[::2][90:95])
    st = nfl.stats()
    assert st["run_len"] and st["delta_len"]
    _same(args[:4] + (idx._serving.stream_pack(), idx._tier_pack()), kw)


@pytest.mark.parametrize("plen", [1, 17, 1023, 1025, 2049, 3000, 4095])
def test_order_partly_live_last_tile(plen):
    """A last tile with 1 to 1,023 live rows (``+inf`` padding after
    them), queries on every side of the live rows and past them."""
    rng = np.random.default_rng(plen)
    keys = np.sort(rng.uniform(-1e3, 1e3, plen)).astype(np.float32)
    ident = np.arange(plen, dtype=np.int32)
    pool, router = _pool(keys, ident, ident * 7, ident + 100, 4096)
    sp = StreamPack(pool, router, window=1)
    pick = rng.integers(0, plen, 300)
    q = np.concatenate([keys[pick], keys[-3:], [np.float32(2e3),
                                               np.float32(-2e3)]])
    qh = np.concatenate([ident[pick], ident[-3:], [-5, -5]])
    ql = qh * 7
    args = (torch.from_numpy(q.reshape(-1, 1)), _i32(qh.astype(np.int32)),
            _i32(ql.astype(np.int32)), None, sp)
    pay = _same(args, dict(dim=1, use_flow=False))
    assert (pay[:-2] >= 100).all() and (pay[-2:] == -1).all()


def test_order_equal_keys_across_tile_edges_and_wide_windows():
    """Runs of one key 5 to 40 rows long straddling the tile edges, so
    the bracket holds two or three tiles; windows of 5 (read four rows a
    load) and 40 (row by row); identities repeated within a run."""
    rng = np.random.default_rng(77)
    keys = np.sort(rng.uniform(0, 1e6, 5000)).astype(np.float32)
    for edge, length in ((1024, 5), (2048, 40), (3072, 17), (4096, 9)):
        keys[edge - length // 2:edge + length - length // 2] = keys[edge]
    keys = np.sort(keys)
    n = keys.shape[0]
    hi = rng.integers(0, 50, n).astype(np.int32)
    lo = rng.integers(0, 3, n).astype(np.int32)
    for window in (5, 40):
        pool, router = _pool(keys, hi, lo, np.arange(n, dtype=np.int32),
                             8192)
        sp = StreamPack(pool, router, window=window)
        pick = np.concatenate([np.arange(1000, 1060), np.arange(2000, 2100),
                               np.arange(3050, 3100), rng.integers(0, n, 200)])
        args = (torch.from_numpy(keys[pick].reshape(-1, 1)),
                _i32(hi[pick]), _i32(lo[pick]), None, sp)
        pay = _same(args, dict(dim=1, use_flow=False))
        if window >= 40:          # the window reaches every equal key
            assert (pay >= 0).all()


def test_order_bracket_slack_and_full_tile_edge():
    """The bracket's +-2 ordered-int slack and the full tile's last round:
    a key 1 or 2 ulps below a tile's first key still probes that tile (3
    ulps below, it does not), and 1 ulp above it still probes the tile
    before, whose search ends one row past its 1,024 rows, so its window
    (W = 2) reaches row 1,023 and not row 1,022.  Identities are placed
    to tell each case apart."""
    rng = np.random.default_rng(19)
    n = 3000
    keys = np.sort(rng.uniform(1.0, 2.0, n)).astype(np.float32)
    assert np.unique(keys).shape[0] == n
    ident = np.arange(n, dtype=np.int32)
    pool, router = _pool(keys, ident, ident * 3, ident + 7, 4096)
    sp = StreamPack(pool, router, window=2)
    down = np.float32(-np.inf)
    up = np.float32(np.inf)
    q, row, want = [], [], []
    for t in (1, 2):
        first = router[t].item()
        below = np.float32(first)
        for steps in (1, 2, 3):
            below = np.nextafter(below, down)
            q.append(below)
            row.append(1024 * t)
            want.append(1024 * t + 7 if steps < 3 else -1)
        above = np.nextafter(np.float32(first), up)
        q += [above, above]
        row += [1024 * t - 1, 1024 * t - 2]
        want += [1024 * t - 1 + 7, -1]
    row = np.array(row)
    args = (torch.from_numpy(np.array(q, np.float32).reshape(-1, 1)),
            _i32(ident[row]), _i32(ident[row] * 3), None, sp)
    assert _same(args, dict(dim=1, use_flow=False)).tolist() == want


@pytest.mark.parametrize("seed", range(4))
def test_order_signed_zeros_inf_padding_and_tombstones(seed):
    """-0.0 beside +0.0 in the pool and the tiers (they order as one
    key), queries of -0.0, +0.0, +-inf and NaN, identities from a small
    set so windows hold copies beside the key, tombstones in the tiers,
    windows 1-9."""
    rng = np.random.default_rng(300 + seed)
    grid = np.unique(rng.integers(-40, 40, 60)).astype(np.float32)
    ident = rng.integers(0, 16, (2, 300)).astype(np.int32)
    n = int(rng.integers(200, 2500))
    keys = np.sort(rng.choice(grid, n)).astype(np.float32)
    keys[keys == 0] = np.where(rng.random((keys == 0).sum()) < 0.5,
                               np.float32(0.0), np.float32(-0.0))
    k = rng.integers(0, 300, n)
    pool, router = _pool(keys, ident[0, k], ident[1, k],
                         rng.integers(0, 1000, n).astype(np.int32), 4096)
    sp = StreamPack(pool, router, window=int(rng.choice([1, 3, 8, 9])))
    tiers = _tiers(rng, grid, ident,
                   windows=(int(rng.choice([1, 2, 9])),
                            int(rng.choice([1, 4]))))
    q = np.concatenate([rng.choice(grid, 200),
                        [0.0, -0.0, np.inf, -np.inf, np.nan]]
                       ).astype(np.float32)
    j = rng.integers(0, 300, q.shape[0])
    args = (torch.from_numpy(q.reshape(-1, 1)), _i32(ident[0, j]),
            _i32(ident[1, j]), None, sp)
    _same(args + (tiers,), dict(dim=1, use_flow=False))
    _same(args, dict(dim=1, use_flow=False))


def test_order_empty_pool():
    """An empty scan pool (and an empty one with empty tiers): every read
    resolves from the tiers, or misses."""
    rng = np.random.default_rng(8)
    grid = np.arange(-20, 20, dtype=np.float32)
    ident = rng.integers(0, 8, (2, 40)).astype(np.int32)
    empty = np.empty(0, np.int32)
    for cap in (128, 4096):
        pool, router = _pool(np.empty(0, np.float32), empty, empty, empty,
                             cap)
        sp = StreamPack(pool, router, window=1)
        q = rng.choice(grid, 100).astype(np.float32)
        j = rng.integers(0, 40, 100)
        args = (torch.from_numpy(q.reshape(-1, 1)), _i32(ident[0, j]),
                _i32(ident[1, j]), None, sp)
        assert (_same(args, dict(dim=1, use_flow=False)) == -1).all()
        _same(args + (_tiers(rng, grid, ident),), dict(dim=1,
                                                        use_flow=False))
        _same(args + (_tiers(rng, grid, ident, sizes=(0, 0)),),
              dict(dim=1, use_flow=False))


def test_order_at_a_2_25_row_capacity():
    """A pool of 2^25-row capacity, nearly full: its router holds 32,769
    tiles' heads (128 KB, the size the kernel stages in shared memory).
    Keys above 2^24 collide in f32 in pairs, so windows of 2 match the
    newer copy; queries in the first, middle and last tiles."""
    cap = 1 << 25
    plen = cap - 1000
    pv = np.full(cap, -1, np.int32)
    pv[:plen] = np.arange(plen, dtype=np.int32)
    pk = pv.astype(np.float32)
    pk[plen:] = np.inf
    hi = (pv.view(np.uint32) * np.uint32(2654435761)).view(np.int32)
    pool = ScanPool(torch.from_numpy(pk), torch.from_numpy(hi),
                    torch.from_numpy(pv), torch.from_numpy(pv),
                    torch.tensor([plen], dtype=torch.int32))
    router = build_router(pool.pk)
    assert router.shape[0] * 4 >= 128 << 10
    sp = StreamPack(pool, router, window=2)
    rng = np.random.default_rng(25)
    pick = np.concatenate([rng.integers(0, plen, 300), [0, 1, plen - 1,
                                                        plen - 2, 1 << 24,
                                                        (1 << 24) + 1]])
    args = (torch.from_numpy(pk[pick].reshape(-1, 1)), _i32(hi[pick]),
            _i32(pv[pick]), None, sp)
    pay = _same(args, dict(dim=1, use_flow=False))
    assert pay.tolist() == pick.tolist()
