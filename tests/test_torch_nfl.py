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
from repro_torch.core.drift import DriftConfig, ReshardConfig
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
    ops.reset_fused_lookup_stats()
    nfl = t_nfl.NFL(_cfg(force_flow=force_flow), device="cpu")
    nfl.bulkload(wl.load_keys, wl.load_payloads)
    assert nfl.use_flow is force_flow
    for _op, k, p in wl.batches:
        assert np.array_equal(nfl.lookup_batch(k), p)
    unloaded = np.setdiff1d(keys, wl.load_keys)
    assert (nfl.lookup_batch(unloaded) == -1).all()
    stats = nfl.dispatch_stats()
    counts = {"nf_forward_launches": 0, "fused_lookup_launches": 0,
              "streamed_lookup_launches": 0, "fused_range_scan_launches": 0,
              "scan_truncated": 0, "shadowed": 0, "rebuilds": 0}
    assert {k: stats[k] for k in counts} == counts
    # the dispatch counters count on every device: each read batch (and
    # the bulkload's verify) on the fused rung, its plain version here
    d = stats["dispatch"]
    assert d["dispatch_count"] == d["fused_count"] >= len(wl.batches) + 1
    assert d["streamed_count"] == 0
    # the serving block, the default drift telemetry (re-flow off) and
    # the reshard block, as the JAX package reports them
    assert set(stats) == {*counts, "dispatch", "serving", "autoswitch",
                          "drift", "reshard"}
    assert stats["drift"]["enabled"] and stats["drift"]["state"] == "idle"
    assert stats["drift"]["use_flow"] is force_flow
    assert stats["reshard"] == {"enabled": False}


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


@pytest.mark.parametrize("kw,item", [
    ({"backend": "afli"}, "A13"),
    ({"backend": "flat", "shards": 2,
      "drift": DriftConfig(reflow=True)}, "A11b"),
    ({"backend": "flat", "shards": 4,
      "reshard": ReshardConfig(enabled=True)}, "A11b")])
def test_unported_configs_raise(kw, item):
    """A config of a part not yet ported raises, naming its ROADMAP item.
    The sharded re-flow and resharding (A11b) raised so until they were
    ported: their configs now build their manager on the sharded index,
    both managers sharing one exclusion token, and serve a bulk load;
    resharding a single index is refused as in the JAX package."""
    if item != "A11b":
        with pytest.raises(NotImplementedError, match=item):
            t_nfl.NFL(t_nfl.NFLConfig(**kw), device="cpu")
        return
    keys = make_dataset("lognormal", 3000)
    nfl = t_nfl.NFL(t_nfl.NFLConfig(flow_train=FlowTrainConfig(epochs=1),
                                    force_flow=False, **kw), device="cpu")
    reshard = kw.get("reshard") is not None
    mgr = nfl._reshard if reshard else nfl._reflow
    assert mgr is not None and mgr.exclusion is nfl._exclusion
    nfl.bulkload(keys, np.arange(keys.shape[0]))
    assert np.array_equal(nfl.lookup_batch(keys), np.arange(keys.shape[0]))
    ds = nfl.dispatch_stats()
    assert ds["drift"]["enabled"] and ds["reshard"]["enabled"] == reshard
    if reshard:
        assert nfl.index.load_window_keys == ReshardConfig().load_window_keys
        assert ds["reshard"]["load"]["n_keys"] == [
            int(s.n_keys) for s in nfl.index.shards]
        with pytest.raises(ValueError, match="shards > 1"):
            t_nfl.NFL(_cfg(reshard=ReshardConfig(enabled=True)),
                      device="cpu")


def test_unported_operations_raise():
    """The operations that raised until A11b was ported now run: the
    single index re-keys (A11a); the sharded index re-keys across its
    shards, migrates a window of them and reports its load gauges
    (A11b), each serving the same answers after."""
    keys = make_dataset("lognormal", 3000)
    pv = np.arange(keys.shape[0])
    nfl = t_nfl.NFL(_cfg(force_flow=False, shards=2), device="cpu")
    nfl.bulkload(keys, pv)
    idx = nfl.index
    snap = idx.load_snapshot()
    assert snap["n_keys"] == [int(s.n_keys) for s in idx.shards]
    assert sum(snap["reads"]) == 0 and sum(snap["writes"]) == 0
    seen = []
    assert idx.start_reshard(0, 1, lambda: seen.append("reshard"))
    idx.rebuild()
    assert idx.start_reflow(lambda k: np.asarray(k, np.float64), None,
                            lambda: seen.append("reflow"))
    idx.rebuild()
    assert seen == ["reshard", "reflow"]
    assert idx.n_reshards == idx.n_reflows == 1
    assert np.array_equal(nfl.lookup_batch(keys), pv)
    single = t_nfl.NFL(_cfg(force_flow=False), device="cpu")
    single.bulkload(keys, pv)
    assert single.index.start_reflow(lambda k: k, None, lambda: None)


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
