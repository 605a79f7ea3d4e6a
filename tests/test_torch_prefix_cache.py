"""repro_torch's NFL page table (``serve.prefix_cache``) on the CPU against
the JAX package's: the page-table cases of ``tests/test_serve.py`` run on
the port; ``composite_key`` and ``prefix_hash`` are bit-equal to the
reference's; with one flow carried into both packages (``train_flow``
patched in both modules), both tables give the same pages, on the
AutoSwitch verdict of each, through bulk loads, inserts, and the rebuild
that re-fits the flow every ``retrain_every`` folds.  Tolerance: none,
pages are compared exactly."""

import jax
import numpy as np
import pytest
import torch

import repro.serve.prefix_cache as j_pc
from repro.core.conflict import dataset_tail_conflict as j_tail
from repro.core.flat_afli import FlatAFLIConfig as JFlatConfig
from repro.core.flow import FlowConfig as JFlowConfig
from repro.core.train_flow import FlowTrainConfig as JTrainConfig

import repro_torch.serve.prefix_cache as t_pc
from repro_torch.core.conflict import dataset_tail_conflict
from repro_torch.core.flat_afli import FlatAFLIConfig
from repro_torch.serve import (MAX_BLOCKS, NFLPageTable, composite_key,
                               prefix_hash)
from repro_torch.weights import params_from_numpy

torch.set_num_threads(1)

# tier bounds tight enough that a few hundred inserts fold several times
_TIGHT = dict(rebuild_frac=0.1, delta_cap=24, fold_step_keys=48,
              fold_work_factor=4.0)


def _sessions(rng, n_seq, n_blocks, lo=0):
    seqs = np.repeat(rng.integers(lo, lo + (1 << 30), n_seq), n_blocks)
    blocks = np.tile(np.arange(n_blocks), n_seq)
    return np.unique(composite_key(seqs, blocks))


# ------------------------------------------- tests/test_serve.py, port
def test_composite_keys_are_clustered():
    rng = np.random.default_rng(0)
    seqs = np.repeat(rng.integers(0, 1 << 30, 64), 128)
    blocks = np.tile(np.arange(128), 64)
    keys = composite_key(seqs, blocks)
    assert dataset_tail_conflict(np.unique(keys)) > 6
    assert dataset_tail_conflict(np.unique(keys)) == j_tail(np.unique(keys))


def test_page_table_bulk_and_insert():
    rng = np.random.default_rng(1)
    keys = _sessions(rng, 32, 64)
    pages = np.arange(len(keys), dtype=np.int64)
    pt = NFLPageTable(device="cpu")
    assert (pt.lookup(keys[:4]) == -1).all()
    pt.bulkload(keys, pages)
    assert np.array_equal(pt.lookup(keys), pages)
    new_keys = composite_key(np.full(16, 999_999_999), np.arange(16))
    pt.insert(new_keys, np.arange(16) + 10_000)
    assert np.array_equal(pt.lookup(new_keys), np.arange(16) + 10_000)
    assert np.array_equal(pt.lookup(keys), pages)
    st = pt.stats()
    assert st["builds"] == 1 and st["n_keys"] == len(keys) + 16


def test_prefix_hash_distinct():
    h1 = prefix_hash(np.array([1, 2, 3, 4]))
    h2 = prefix_hash(np.array([1, 2, 3, 5]))
    h3 = prefix_hash(np.array([1, 2, 3, 4]))
    assert h1 == h3 and h1 != h2


def test_first_insert_bulkloads():
    rng = np.random.default_rng(2)
    keys = _sessions(rng, 8, 32)
    pt = NFLPageTable(device="cpu")
    pt.insert(keys, np.arange(len(keys)))
    assert pt.stats()["builds"] == 1
    assert np.array_equal(pt.lookup(keys), np.arange(len(keys)))


# --------------------------------------------------- against the JAX table
def test_keys_bit_equal():
    rng = np.random.default_rng(3)
    seqs = rng.integers(0, 1 << 32, 4096, dtype=np.int64)
    blocks = rng.integers(0, MAX_BLOCKS, 4096)
    a, b = composite_key(seqs, blocks), j_pc.composite_key(seqs, blocks)
    assert MAX_BLOCKS == j_pc.MAX_BLOCKS
    assert a.dtype == b.dtype and np.array_equal(a.view(np.uint64),
                                                 b.view(np.uint64))
    toks = rng.integers(0, 1 << 31, (256, 16))
    for t in toks:
        ha, hb = prefix_hash(t), j_pc.prefix_hash(t)
        assert type(ha) is float and ha == hb and ha < 2.0 ** 53


def _carry_flow(keys, monkeypatch):
    """One flow trained by the JAX package on ``keys``, handed to both
    packages' ``train_flow`` (every later re-fit gets it too)."""
    params, norm, metrics = j_pc.train_flow(
        keys, JFlowConfig(), JTrainConfig(epochs=1, sample_frac=1.0))
    t_params = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    monkeypatch.setattr(j_pc, "train_flow",
                        lambda *a, **k: (params, norm, dict(metrics)))
    monkeypatch.setattr(t_pc, "train_flow",
                        lambda *a, **k: (t_params, norm, dict(metrics)))


@pytest.mark.parametrize("kind", ["sessions", "prefix_hashes"])
def test_page_table_matches_jax(kind, monkeypatch):
    rng = np.random.default_rng(4)
    if kind == "sessions":
        keys = _sessions(rng, 128, 32)
        new = _sessions(rng, 2, 32, lo=1 << 30)
    else:
        toks = rng.integers(0, 1 << 31, (1600, 16))
        hashes = np.unique([prefix_hash(t) for t in toks])
        keys, new = hashes[:1536], hashes[1536:]
    _carry_flow(keys, monkeypatch)
    pages = rng.permutation(len(keys)).astype(np.int64)
    jt = j_pc.NFLPageTable()
    pt = NFLPageTable(device="cpu")
    for t in (jt, pt):
        t.bulkload(keys, pages)
    assert pt.stats()["flow_enabled"] == jt.stats()["flow_enabled"]
    # composite session keys take the flow, near-uniform hashes decline it
    assert pt.stats()["flow_enabled"] is (kind == "sessions")
    q = np.concatenate([keys[::3], new])
    got = pt.lookup(q)
    assert np.array_equal(got, jt.lookup(q))
    assert np.array_equal(got[:len(keys[::3])], pages[::3])
    assert (got[len(keys[::3]):] == -1).all()
    npages = np.arange(len(new)) + 50_000
    for t in (jt, pt):
        t.insert(new, npages)
    got = pt.lookup(np.concatenate([keys, new]))
    assert np.array_equal(got, jt.lookup(np.concatenate([keys, new])))
    assert np.array_equal(got, np.concatenate([pages, npages]))


def test_page_table_retrain_matches_jax(monkeypatch):
    """With tight tier bounds the inserts fold the index again and
    again; every ``retrain_every``-th fold re-fits the flow and rebuilds
    (``builds`` grows).  Both packages give the same pages throughout,
    before, across and after each one's rebuilds."""
    rng = np.random.default_rng(5)
    keys = _sessions(rng, 8, 64)
    _carry_flow(keys, monkeypatch)
    pages = np.arange(len(keys), dtype=np.int64)
    jt = j_pc.NFLPageTable(index_cfg=JFlatConfig(**_TIGHT))
    pt = NFLPageTable(index_cfg=FlatAFLIConfig(**_TIGHT), device="cpu")
    for t in (jt, pt):
        t.bulkload(keys, pages)
    live_k, live_p = [keys], [pages]
    builds = (1, 1)
    for i in range(160):
        new = _sessions(rng, 4, 64, lo=1 << 30)
        npages = np.arange(len(new)) + 100_000 * (i + 1)
        for t in (jt, pt):
            t.insert(new, npages)
        live_k.append(new)
        live_p.append(npages)
        now = (pt.stats()["builds"], jt.stats()["builds"])
        if i % 8 == 0 or now != builds:
            q = np.concatenate([new, live_k[0][i % 64::64]])
            assert np.array_equal(pt.lookup(q), jt.lookup(q))
        builds = now
        if min(builds) > 1:
            break
    # the packages charge fold work per call differently, so each
    # reaches its eighth fold at its own call
    assert pt.stats()["builds"] > 1 and jt.stats()["builds"] > 1
    assert pt.index.n_rebuilds >= 8
    allk, allp = np.concatenate(live_k), np.concatenate(live_p)
    got = pt.lookup(allk)
    assert np.array_equal(got, allp)
    assert np.array_equal(got, jt.lookup(allk))
