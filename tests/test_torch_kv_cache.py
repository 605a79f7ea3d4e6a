"""repro_torch's ``PagedKVCache`` against the JAX ``PagedKVCache`` on the
CPU: the same appends (``tests/test_serve.py::test_paged_kv_cache_
roundtrip``'s sequences, and more) go into both; the pages each
sequence gets, ``gather_kv``'s views (equal: both store f32 as given),
the page-table probes and the stats agree, before and after a release
whose pages are reused."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve.kv_cache import PagedKVCache as JCache
from repro.serve.kv_cache import PagedKVConfig as JConfig

from repro_torch.serve.kv_cache import PagedKVCache, PagedKVConfig

torch.set_num_threads(1)


def _pair(**kw):
    return (JCache(JConfig(dtype=jnp.float32, **kw)),
            PagedKVCache(PagedKVConfig(dtype=torch.float32, **kw),
                         device="cpu"))


def _append(jc, tc, sid, n, rng):
    c = tc.cfg
    for _ in range(n):
        k = rng.standard_normal((c.n_layers, c.kv_heads, c.head_dim)
                                ).astype(np.float32)
        v = rng.standard_normal(k.shape).astype(np.float32)
        jc.append(sid, jnp.asarray(k), jnp.asarray(v))
        tc.append(sid, torch.from_numpy(k), torch.from_numpy(v))


def _same(jc, tc, sid):
    jk, jv, jn = jc.gather_kv(sid)
    tk, tv, tn = tc.gather_kv(sid)
    assert tn == jn
    assert np.array_equal(tk.numpy(), np.asarray(jk))
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    nb = -(-jn // tc.cfg.page_size)
    assert np.array_equal(tc.lookup_pages(sid, nb), jc.lookup_pages(sid, nb))
    assert tc._seq_blocks[sid] == jc._seq_blocks[sid]


@pytest.mark.parametrize("seqs", [{7: 11, 9: 6}, {3: 1, 4: 4, 5: 17}])
def test_paged_kv_cache_roundtrip_matches_jax(seqs):
    jc, tc = _pair(n_pages=64, page_size=4, n_layers=2, kv_heads=2,
                   head_dim=8)
    rng = np.random.default_rng(2)
    for sid, n in seqs.items():
        jc.register_sequence(sid)
        tc.register_sequence(sid)
        _append(jc, tc, sid, n, rng)
    for sid in seqs:
        _same(jc, tc, sid)
    assert tc.stats()["used_pages"] == jc.stats()["used_pages"]
    first = next(iter(seqs))
    used = tc.stats()["used_pages"]
    jc.release(first)
    tc.release(first)
    assert tc.stats()["used_pages"] < used
    assert tc.free_pages() == jc.free_pages()
    # a new sequence takes the released pages, in the same order
    for c in (jc, tc):
        c.register_sequence(100)
    _append(jc, tc, 100, 9, rng)
    _same(jc, tc, 100)
    for sid in list(seqs)[1:]:
        _same(jc, tc, sid)


def test_empty_sequence_and_exhausted_pool():
    jc, tc = _pair(n_pages=2, page_size=2, n_layers=1, kv_heads=1,
                   head_dim=4)
    tc.register_sequence(1)
    k, v, n = tc.gather_kv(1)
    assert n == 0 and tuple(k.shape) == (1, 0, 1, 4)
    rng = np.random.default_rng(0)
    jc.register_sequence(1)
    _append(jc, tc, 1, 4, rng)
    _same(jc, tc, 1)
    with pytest.raises(MemoryError):
        tc.append(1, torch.zeros(1, 1, 4), torch.zeros(1, 1, 4))
    with pytest.raises(MemoryError):
        jc.append(1, jnp.zeros((1, 1, 4)), jnp.zeros((1, 1, 4)))
