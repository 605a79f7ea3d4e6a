"""repro_torch NFL end to end on the CPU (plain versions of the kernels):
bulkload and lookups against ground truth, the AutoSwitch verdict against
the JAX package given the same flow, and the device rules of the entry
points."""

import jax
import numpy as np
import pytest
import torch

import repro.core.nfl as j_nfl
from repro.core.flow import FlowConfig as JFlowConfig
from repro.core.train_flow import FlowTrainConfig as JTrainConfig

import repro_torch.core.nfl as t_nfl
from repro_torch.core.flat_afli import FlatAFLI
from repro_torch.core.flow import FlowConfig, init_flow
from repro_torch.core.train_flow import FlowTrainConfig, FlowTrainer, train_flow
from repro_torch.data.datasets import make_dataset
from repro_torch.data.workloads import WorkloadConfig, make_workload
from repro_torch.kernels import ops
from repro_torch.weights import params_from_numpy

torch.set_num_threads(1)


def _cfg(**kw):
    return t_nfl.NFLConfig(backend="flat",
                           flow_train=FlowTrainConfig(epochs=1), **kw)


@pytest.mark.parametrize("name", ["longlat", "lognormal"])
@pytest.mark.parametrize("force_flow", [True, False])
def test_bulkload_and_lookup_ground_truth(name, force_flow):
    """Read-only workload (paper §4.1.1) at a small scale: half the keys
    loaded, zipf reads of loaded keys, then every unloaded key misses."""
    keys = make_dataset(name, 12000)
    wl = make_workload(keys, WorkloadConfig(n_ops=8192, batch_size=2048))
    # the counters are process-wide: start from zero, whatever ran before
    ops.reset_launch_counts()
    nfl = t_nfl.NFL(_cfg(force_flow=force_flow), device="cpu")
    nfl.bulkload(wl.load_keys, wl.load_payloads)
    assert nfl.use_flow is force_flow
    for _op, k, p in wl.batches:
        assert np.array_equal(nfl.lookup_batch(k), p)
    unloaded = np.setdiff1d(keys, wl.load_keys)
    assert (nfl.lookup_batch(unloaded) == -1).all()
    stats = nfl.dispatch_stats()
    assert stats == {"nf_forward_launches": 0, "fused_lookup_launches": 0,
                     "streamed_lookup_launches": 0,
                     "fused_range_scan_launches": 0, "scan_truncated": 0,
                     "shadowed": 0, "rebuilds": 0}


def _shared_flow(keys):
    """One flow trained by the JAX package, handed to both packages."""
    params, norm, metrics = j_nfl.train_flow(keys, JFlowConfig(),
                                             JTrainConfig(epochs=1))
    return params, norm, metrics


@pytest.mark.parametrize("name", ["longlat", "lognormal", "longitudes"])
def test_autoswitch_verdict_matches_jax(name, monkeypatch):
    keys = make_dataset(name, 6000)
    payloads = np.arange(keys.shape[0], dtype=np.int64)
    params, norm, metrics = _shared_flow(keys)
    t_params = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    monkeypatch.setattr(j_nfl, "train_flow",
                        lambda *a, **k: (params, norm, metrics))
    monkeypatch.setattr(t_nfl, "train_flow",
                        lambda *a, **k: (t_params, norm, dict(metrics)))
    jx = j_nfl.NFL(j_nfl.NFLConfig(backend="flat"))
    jx.bulkload(keys, payloads)
    pt = t_nfl.NFL(t_nfl.NFLConfig(backend="flat"), device="cpu")
    pt.bulkload(keys, payloads)
    assert pt.use_flow == jx.use_flow
    for k in ("tail_conflict_original", "tail_conflict_transformed"):
        assert pt.metrics[k] == jx.metrics[k], k
    assert np.array_equal(pt.lookup_batch(keys), payloads)


def test_entry_points_raise_without_a_card(monkeypatch):
    """With no card and no device="cpu", every entry point raises; none
    falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    keys = make_dataset("lognormal", 2000)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_nfl.NFL(t_nfl.NFLConfig(backend="flat"))
    with pytest.raises(RuntimeError):
        FlatAFLI()
    with pytest.raises(RuntimeError):
        train_flow(keys, FlowConfig())
    with pytest.raises(RuntimeError):
        FlowTrainer(keys, FlowConfig())
    with pytest.raises(RuntimeError):
        init_flow(torch.Generator().manual_seed(0), FlowConfig())
    params, norm, _ = train_flow(keys, FlowConfig(), FlowTrainConfig(epochs=1),
                                 device="cpu")
    with pytest.raises(RuntimeError):
        ops.nf_transform_keys(params, norm, keys, FlowConfig())
    with pytest.raises(RuntimeError):
        params_from_numpy({"layers": [], "out_log_scale": np.zeros(2)})
    with pytest.raises(RuntimeError):
        t_nfl.NFL(t_nfl.NFLConfig(backend="flat"), device="cuda")


@pytest.mark.parametrize("kw,item", [({"backend": "afli"}, "A13")])
def test_unported_configs_raise(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        t_nfl.NFL(t_nfl.NFLConfig(**kw), device="cpu")


def test_unported_operations_raise():
    keys = make_dataset("lognormal", 3000)
    nfl = t_nfl.NFL(_cfg(force_flow=False), device="cpu")
    nfl.bulkload(keys, np.arange(keys.shape[0]))
    for call, item in [
            (lambda: nfl.index.start_reflow(lambda k: k, None,
                                            lambda: None), "A11")]:
        with pytest.raises(NotImplementedError, match=item):
            call()


def test_bulkload_metrics_and_pack():
    keys = make_dataset("longlat", 5000)
    nfl = t_nfl.NFL(_cfg(force_flow=True), device="cpu")
    nfl.bulkload(keys, np.arange(keys.shape[0]))
    m = nfl.metrics
    for k in ("flow_train_s", "transform_s", "index_build_s",
              "tail_conflict_original", "tail_conflict_transformed"):
        assert k in m
    assert nfl._packed_w.device.type == "cpu"
    assert nfl._packed_w.shape == (1, 28) and nfl._shapes == ((4, 2), (2, 4))
    assert nfl.index.stats()["n_keys"] == keys.shape[0]
