"""repro_torch NFL end to end on the CPU (plain versions of the kernels):
bulkload and lookups against ground truth, the AutoSwitch verdict against
the JAX package given the same flow, and the device rules of the entry
points."""

import jax
import numpy as np
import pytest
import torch

import repro.core.drift as j_drift
import repro.core.nfl as j_nfl
from repro.core.flow import FlowConfig as JFlowConfig
from repro.core.train_flow import FlowTrainConfig as JTrainConfig

import repro_torch.core.nfl as t_nfl
from repro_torch.core.afli import AFLI
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
    """The configs that raised until their ROADMAP item was ported now
    serve.  The paper's backend (A13): ``NFL(NFLConfig())`` with the
    default flow and training bulk-loads and serves on the AFLI tree,
    and the drift re-flow and resharding are refused on it with the JAX
    package's ``ValueError``.  The sharded re-flow and resharding (A11b)
    build their manager on the sharded index, both managers sharing one
    exclusion token, and serve a bulk load; resharding a single index is
    refused as in the JAX package."""
    if item == "A13":
        keys = make_dataset("longlat", 3000)
        pv = np.arange(keys.shape[0])
        nfl = t_nfl.NFL(t_nfl.NFLConfig(), device="cpu")
        assert isinstance(nfl.index, AFLI)
        assert nfl._drift is None and nfl._reflow is None
        nfl.bulkload(keys[::2], pv[::2])
        assert np.array_equal(nfl.lookup_batch(keys[::2]), pv[::2])
        assert (nfl.lookup_batch(keys[1::2]) == -1).all()
        nfl.insert_batch(keys[1::2], pv[1::2])
        assert np.array_equal(nfl.lookup_batch(keys), pv)
        assert nfl._packed_w is None
        for bad in ({"drift": DriftConfig(reflow=True)},
                    {"reshard": ReshardConfig(enabled=True)},
                    {"reshard": ReshardConfig(enabled=True), "shards": 4}):
            with pytest.raises(ValueError, match="backend='flat'"):
                t_nfl.NFL(t_nfl.NFLConfig(**bad), device="cpu")
            with pytest.raises(ValueError, match="backend='flat'"):
                j_nfl.NFL(j_nfl.NFLConfig(**{
                    k: (j_drift.DriftConfig(reflow=True) if k == "drift"
                        else j_drift.ReshardConfig(enabled=True)
                        if k == "reshard" else v)
                    for k, v in bad.items()}))
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


# ------------------------------------------------ the AFLI backend (A13)
def _afli_trace(sides, keys, rng, n_steps=12, batch=96):
    """One random trace of lookup, insert (absent keys), update and
    delete batches (present and absent keys mixed) on every side; each
    answer is equal across the sides and to a dict.  ``sides`` are NFLs
    bulk-loaded with the even keys."""
    live = {float(k): i for i, k in enumerate(keys) if i % 2 == 0}
    for step in range(n_steps):
        op = ("lookup", "insert", "update", "delete")[step % 4]
        q = keys[rng.integers(keys.shape[0], size=batch)]
        if op == "insert":
            q = np.unique(q[[float(k) not in live for k in q]])
            v = np.arange(q.shape[0]) + 100_000 * (step + 1)
            for nfl in sides:
                nfl.insert_batch(q, v)
            live.update(zip(q.tolist(), v.tolist()))
            continue
        q = np.unique(q)
        if op == "lookup":
            want = [live.get(k, -1) for k in q.tolist()]
            for nfl in sides:
                assert nfl.lookup_batch(q).tolist() == want
        elif op == "update":
            v = np.arange(q.shape[0]) + 200_000 * (step + 1)
            want = [k in live for k in q.tolist()]
            for nfl in sides:
                assert nfl.update_batch(q, v).tolist() == want
            live.update((k, x) for k, x, w in
                        zip(q.tolist(), v.tolist(), want) if w)
        else:
            want = [k in live for k in q.tolist()]
            for nfl in sides:
                assert nfl.delete_batch(q).tolist() == want
            for k in q.tolist():
                live.pop(k, None)
    want = [live.get(k, -1) for k in keys.tolist()]
    for nfl in sides:
        assert nfl.lookup_batch(keys).tolist() == want
    return live


@pytest.mark.parametrize("name", ["longlat", "lognormal"])
def test_afli_backend_flow_off_bit_equal(name):
    """Flow off: the port's AFLI-backend NFL and the JAX one build the
    same tree bit for bit from the same keys and stay so over a random
    trace, ``stats()`` equal."""
    from test_torch_afli import assert_same_tree

    keys = make_dataset(name, 6000)
    pv = np.arange(keys.shape[0])
    jx = j_nfl.NFL(j_nfl.NFLConfig(force_flow=False,
                                   flow_train=JTrainConfig(epochs=1)))
    pt = t_nfl.NFL(t_nfl.NFLConfig(force_flow=False,
                                   flow_train=FlowTrainConfig(epochs=1)),
                   device="cpu")
    for nfl in (jx, pt):
        nfl.bulkload(keys[::2], pv[::2])
        assert nfl.use_flow is False
    assert_same_tree(pt.index, jx.index)
    _afli_trace([pt, jx], keys, np.random.default_rng(3))
    assert_same_tree(pt.index, jx.index)
    assert pt.stats().as_dict() == jx.stats().as_dict()
    assert pt.metrics["serve_verify_shadowed"] == 0.0
    assert set(pt.metrics) >= {"tail_conflict_original",
                               "tail_conflict_transformed", "use_flow",
                               "flow_train_s", "transform_s",
                               "index_build_s"}


@pytest.mark.parametrize("name", ["longlat", "longitudes"])
def test_afli_backend_flow_on_matches_jax(name, monkeypatch):
    """Flow on, one flow carried into both packages: the AutoSwitch
    verdict and both tails equal, and every answer of a random trace
    equal to the JAX NFL's and to a dict.  Positioning keys come from
    ``transform_keys`` on each side (XLA and torch may round the f32 flow
    a few ulp apart), so the trees are held by their answers."""
    keys = make_dataset(name, 6000)
    pv = np.arange(keys.shape[0])
    params, norm, metrics = _shared_flow(keys[::2])
    t_params = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    monkeypatch.setattr(j_nfl, "train_flow",
                        lambda *a, **k: (params, norm, metrics))
    monkeypatch.setattr(t_nfl, "train_flow",
                        lambda *a, **k: (t_params, norm, dict(metrics)))
    jx = j_nfl.NFL(j_nfl.NFLConfig(force_flow=True))
    pt = t_nfl.NFL(t_nfl.NFLConfig(force_flow=True), device="cpu")
    auto_j = j_nfl.NFL(j_nfl.NFLConfig())
    auto_t = t_nfl.NFL(t_nfl.NFLConfig(), device="cpu")
    for nfl in (jx, pt, auto_j, auto_t):
        nfl.bulkload(keys[::2], pv[::2])
    assert pt.use_flow and jx.use_flow
    assert auto_t.use_flow == auto_j.use_flow
    for k in ("tail_conflict_original", "tail_conflict_transformed",
              "use_flow", "serve_verify_shadowed"):
        assert pt.metrics[k] == jx.metrics[k], k
        assert auto_t.metrics[k] == auto_j.metrics[k], k
    assert set(pt.metrics) == set(jx.metrics)
    _afli_trace([pt, jx], keys, np.random.default_rng(4))
    assert pt.stats().n_data_slots > 0
    assert pt.index.n_keys == jx.index.n_keys


def test_afli_backend_api():
    """``scan_batch`` raises on the AFLI backend, as in the JAX package;
    ``lookup_batch_async`` returns an eager finisher; ``dispatch_stats``
    has only the dispatch block, and no kernel launches."""
    keys = make_dataset("lognormal", 2000)
    pv = np.arange(keys.shape[0])
    nfl = t_nfl.NFL(t_nfl.NFLConfig(flow_train=FlowTrainConfig(epochs=1)),
                    device="cpu")
    nfl.bulkload(keys, pv)
    with pytest.raises(NotImplementedError, match="backend='flat'"):
        nfl.scan_batch(keys[:4], keys[4:8])
    with pytest.raises(NotImplementedError, match="backend='flat'"):
        nfl.lookup_range(keys[:4], keys[4:8])
    finish = nfl.lookup_batch_async(keys[:100])
    assert callable(finish)
    assert np.array_equal(finish(), pv[:100])
    stats = nfl.dispatch_stats(reset=True)
    assert set(stats) == {"dispatch"}
    assert set(stats["dispatch"]) == set(ops.fused_lookup_stats())
    assert ops.launch_counts() == dict.fromkeys(ops.launch_counts(), 0)
    st = nfl.stats()
    assert st.as_dict()["n_data_slots"] + st.n_bucket > 0
    assert nfl.update_batch(keys[:3], np.array([7, 8, 9])).all()
    assert not nfl.update_batch(np.array([-1.0]), np.array([1])).any()
    assert nfl.lookup_batch(keys[:3]).tolist() == [7, 8, 9]
