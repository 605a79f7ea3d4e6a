"""repro_torch's own numpy copies (datasets, workloads, feature
expansion, conflict degrees) against the JAX package's modules: the same
seeds give bit-equal outputs."""

import numpy as np
import pytest
import torch

from repro.core import conflict as j_conflict
from repro.core import feature as j_feature
from repro.data import datasets as j_datasets
from repro.data import workloads as j_workloads

from repro_torch.core import conflict, feature
from repro_torch.data import datasets, workloads

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["longitudes", "longlat", "lognormal",
                                  "llt", "lgn"])
@pytest.mark.parametrize("seed", [None, 7])
def test_datasets_bitwise(name, seed):
    a = datasets.make_dataset(name, 5000, seed=seed)
    b = j_datasets.make_dataset(name, 5000, seed=seed)
    assert a.dtype == b.dtype and np.array_equal(a, b)


def test_unported_dataset_raises():
    with pytest.raises(NotImplementedError, match="A13"):
        datasets.make_dataset("ycsb", 100)


@pytest.mark.parametrize("mix", ["read_only", "read_heavy"])
def test_workload_bitwise(mix):
    keys = datasets.lognormal(6000)
    cfg = dict(mix=mix, n_ops=3000, batch_size=512, zipf_s=0.99, seed=3)
    a = workloads.make_workload(keys, workloads.WorkloadConfig(**cfg))
    b = j_workloads.make_workload(keys, j_workloads.WorkloadConfig(**cfg))
    assert np.array_equal(a.load_keys, b.load_keys)
    assert np.array_equal(a.load_payloads, b.load_payloads)
    assert len(a.batches) == len(b.batches)
    for x, y in zip(a.batches, b.batches):
        for u, v in zip(x, y):
            assert np.array_equal(u, v)


@pytest.mark.parametrize("dim", [2, 3, 5])
def test_expand_features_bitwise(dim):
    keys = datasets.longlat(4000)
    na = feature.KeyNormalizer.fit(keys, scale=1e4)
    nb = j_feature.KeyNormalizer.fit(keys, scale=1e4)
    assert (na.mu, na.sigma, na.scale) == (nb.mu, nb.sigma, nb.scale)
    for dtype in (np.float64, np.float32):
        a = feature.expand_features(keys, na, dim, 1e3, dtype=dtype)
        b = j_feature.expand_features(keys, nb, dim, 1e3, dtype=dtype)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(feature.decode_features(a),
                          j_feature.decode_features(b))
    assert np.array_equal(feature.feature_scales(dim, 1e3),
                          j_feature.feature_scales(dim, 1e3))


@pytest.mark.parametrize("name", ["longlat", "lognormal", "longitudes"])
def test_conflict_bitwise(name):
    keys = datasets.make_dataset(name, 8000)
    ma = conflict.fit_linear_model(keys)
    mb = j_conflict.fit_linear_model(keys)
    assert (ma.slope, ma.intercept) == (mb.slope, mb.intercept)
    assert np.array_equal(conflict.conflict_degrees(keys, ma),
                          j_conflict.conflict_degrees(keys, mb))
    for gamma in (0.5, 0.99):
        assert (conflict.dataset_tail_conflict(keys, gamma)
                == j_conflict.dataset_tail_conflict(keys, gamma))
    z = np.log1p(keys - keys.min())
    assert conflict.should_use_flow(keys, z) == j_conflict.should_use_flow(
        keys, z)
    for ts, tc in [(10, 9), (10, 8), (100, 89), (5, 5)]:
        assert (conflict.accept_candidate(ts, tc)
                == j_conflict.accept_candidate(ts, tc))
