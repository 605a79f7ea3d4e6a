"""repro_torch's flash-decode plain version against the Pallas kernel, on
the CPU.

``flash_decode_plain`` (the card kernel's algorithm: per split of S an
online softmax tile by tile, then a combine of the splits' partials) is
compared with ``flash_decode_pallas`` in interpret mode and with
``flash_decode_ref`` on the sweep of ``tests/test_kernels.py`` at its
bounds: 2e-5 in f32, 2e-2 with a bf16 cache; and at split plans that put
a split boundary on ``kv_len``, whole splits past it, and S inside one
tile.  ``decode_plan`` must cover [0, S) once with whole tiles.  A row
with ``kv_len == 0`` gives zeros, as the Pallas kernel's
``o / max(l, 1e-20)`` does (``flash_decode_ref``, a full softmax, gives
NaN there).  Inputs are made with numpy from a seed."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.flash_decode import flash_decode_pallas
from repro.kernels.ref import flash_decode_ref

from repro_torch.kernels import ops
from repro_torch.kernels.flash_decode import (TILE, DecodePlan, decode_plan,
                                              flash_decode, flash_decode_plain)

torch.set_num_threads(1)

F32_TOL = 2e-5    # tests/test_kernels.py test_flash_decode_sweep
BF16_TOL = 2e-2   # tests/test_kernels.py test_flash_decode_bf16


def _inputs(b, h, kh, d, s, seed, kv_len=None):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, h, d)) / np.sqrt(d)).astype(np.float32)
    k = rng.standard_normal((b, s, kh, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kh, d)).astype(np.float32)
    if kv_len is None:
        kv_len = rng.integers(1, s + 1, b)
    return q, k, v, np.asarray(kv_len, np.int32)


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("b,h,kh,d,s", [
    (1, 4, 4, 32, 128),      # MHA
    (2, 8, 2, 64, 300),      # GQA, ragged S
    (3, 8, 8, 128, 1024),    # aligned
    (2, 16, 4, 64, 700),
])
def test_flash_decode_plain_matches_pallas_and_ref(b, h, kh, d, s):
    q, k, v, kv_len = _inputs(b, h, kh, d, s, b * 100 + s)
    kv_len[0] = s                       # a full row beside ragged ones
    o_p = flash_decode_plain(*_torch(q, k, v, kv_len)).numpy()
    o_k = np.asarray(flash_decode_pallas(*map(jnp.asarray, (q, k, v, kv_len)),
                                         block=128, interpret=True))
    o_r = np.asarray(flash_decode_ref(*map(jnp.asarray, (q, k, v, kv_len))))
    assert o_p.shape == (b, h, d) and o_p.dtype == np.float32
    np.testing.assert_allclose(o_p, o_k, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(o_p, o_r, rtol=F32_TOL, atol=F32_TOL)


def test_flash_decode_plain_bf16_cache():
    b, h, kh, d, s = 2, 8, 4, 64, 512
    q, k, v, _ = _inputs(b, h, kh, d, s, 9)
    kv_len = np.full(b, s, np.int32)
    qb, kb, vb = (x.astype(ml_dtypes.bfloat16) for x in (q, k, v))
    tq, tk, tv = (torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
                  for x in (qb, kb, vb))
    o_p = flash_decode_plain(tq, tk, tv, torch.from_numpy(kv_len)).numpy()
    o_k = np.asarray(flash_decode_pallas(*map(jnp.asarray, (qb, kb, vb,
                                                            kv_len)),
                                         interpret=True))
    o_r = np.asarray(flash_decode_ref(*(jnp.asarray(x, jnp.float32)
                                        for x in (qb, kb, vb)),
                                      jnp.asarray(kv_len)))
    np.testing.assert_allclose(o_p, o_k, rtol=BF16_TOL, atol=BF16_TOL)
    np.testing.assert_allclose(o_p, o_r, rtol=BF16_TOL, atol=BF16_TOL)


def test_flash_decode_empty_rows_give_zero():
    """kv_len 0 beside 1 and S: the empty row is 0 in the plain version
    and in the Pallas kernel; the others agree at F32_TOL."""
    q, k, v, _ = _inputs(3, 8, 2, 64, 600, 5)
    kv_len = np.array([0, 1, 600], np.int32)
    o_p = flash_decode_plain(*_torch(q, k, v, kv_len)).numpy()
    o_k = np.asarray(flash_decode_pallas(*map(jnp.asarray, (q, k, v, kv_len)),
                                         interpret=True))
    assert not o_p[0].any() and not o_k[0].any()
    np.testing.assert_allclose(o_p, o_k, rtol=F32_TOL, atol=F32_TOL)
    # one position: softmax weight 1 on it, so o is v at position 0
    np.testing.assert_allclose(o_p[1], np.repeat(v[1, 0], 4, axis=0),
                               rtol=F32_TOL, atol=F32_TOL)


def test_flash_decode_runs_plain_on_cpu_tensors():
    args = _torch(*_inputs(2, 8, 2, 32, 260, 11))
    ops.reset_launch_counts()
    o = ops.flash_decode(*args)
    assert torch.equal(o, flash_decode_plain(*args))
    assert torch.equal(o, flash_decode(*args))
    assert ops.launch_counts()["flash_decode"] == 0
    with pytest.raises(ValueError, match="multiple"):
        q, k, v, kv_len = args
        flash_decode_plain(q[:, :7], k, v, kv_len)


@pytest.mark.parametrize("b,h,kh,s", [
    (1, 40, 8, 32768), (16, 40, 8, 32768), (4, 40, 8, 4096), (1, 8, 8, 1),
    (3, 8, 2, 300), (3, 6, 3, 77), (2, 64, 1, 1000), (1, 4, 4, 0),
    (128, 40, 8, 32768), (1, 16, 2, 255), (1, 16, 2, 257)])
def test_decode_plan_covers_s_once(b, h, kh, s):
    """Every split is a whole number of tiles and non-empty, and the
    splits cover [0, S) exactly once, on the card's 132 SMs and on a
    smaller card, at one and at three resident blocks per SM; a grid
    past one wave of resident blocks fills its last wave to within one
    split of every row."""
    for sms, per_sm in ((132, 3), (132, 1), (20, 3)):
        plan = decode_plan(b, h, kh, s, sms, per_sm)
        rows = b * kh * -(-(h // kh) // 8)
        wave = sms * per_sm
        n = rows * plan.splits
        assert n <= wave or (-n) % wave < rows or plan.splits == 1
        assert plan.tile == TILE and plan.split_len % TILE == 0
        assert plan.splits >= 1
        cover = np.zeros(s, np.int64)
        for i in range(plan.splits):
            lo, hi = i * plan.split_len, min((i + 1) * plan.split_len, s)
            assert hi > lo or s == 0
            cover[lo:hi] += 1
        assert (cover == 1).all()
    if (b, s) == (1, 32768):
        assert decode_plan(b, h, kh, s).splits > 1


@pytest.mark.parametrize("s,kv_len,plan", [
    # a split boundary exactly at kv_len (64 and 128), one row full
    (300, [128, 64, 300], DecodePlan(5, 64, 16)),
    # whole splits past kv_len
    (300, [10, 70, 33], DecodePlan(5, 64, 16)),
    # kv_len 0, 1 and S
    (300, [0, 1, 300], DecodePlan(3, 128, 16)),
    # S shorter than one tile
    (12, [0, 7, 12], DecodePlan(1, 16, 16)),
    # one split, and a tile that does not divide S
    (300, [299, 1, 150], DecodePlan(1, 304, 16)),
    # the plain version's tile is free; the kernel's is TILE
    (300, [255, 256, 257], DecodePlan(2, 256, 64)),
])
def test_flash_decode_split_plans_match_pallas_and_ref(s, kv_len, plan):
    b, h, kh, d = 3, 10, 2, 64
    q, k, v, kv = _inputs(b, h, kh, d, s, s + sum(kv_len), kv_len)
    o_p = flash_decode_plain(*_torch(q, k, v, kv), plan=plan).numpy()
    o_k = np.asarray(flash_decode_pallas(*map(jnp.asarray, (q, k, v, kv)),
                                         block=128, interpret=True))
    np.testing.assert_allclose(o_p, o_k, rtol=F32_TOL, atol=F32_TOL)
    live = kv > 0
    o_r = np.asarray(flash_decode_ref(*map(jnp.asarray, (q, k, v, kv))))
    np.testing.assert_allclose(o_p[live], o_r[live], rtol=F32_TOL,
                               atol=F32_TOL)
    assert not o_p[~live].any()
    # the plan changes the order of the sums, not the function
    o_1 = flash_decode_plain(*_torch(q, k, v, kv),
                             plan=DecodePlan(1, -(-s // 16) * 16, 16)).numpy()
    np.testing.assert_allclose(o_p, o_1, rtol=F32_TOL, atol=F32_TOL)


def test_flash_decode_plain_rejects_a_plan_short_of_s():
    args = _torch(*_inputs(1, 4, 2, 32, 100, 3))
    with pytest.raises(ValueError, match="cover"):
        flash_decode_plain(*args, plan=DecodePlan(1, 64, 16))
