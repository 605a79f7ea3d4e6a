"""repro_torch flow stack against the JAX package: NF forward, weight
packing, the kernel-backed key transform and flow training.

Inputs are made with numpy and passed to both packages as numpy; the
port runs on the CPU (its plain PyTorch versions), the JAX package as
its own tests run it (Pallas in interpret mode)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.flow import FlowConfig as JFlowConfig
from repro.core.flow import init_flow as j_init_flow
from repro.core.flow import materialize_weights as j_materialize
from repro.core.flow import flow_forward_with_logdet as j_logdet
from repro.core.train_flow import FlowTrainConfig as JTrainConfig
from repro.core.train_flow import FlowTrainer as JFlowTrainer
from repro.core.train_flow import train_flow as j_train_flow
from repro.kernels import ops as j_ops
from repro.kernels.nf_forward import nf_forward_pallas
from repro.kernels.nf_forward import pack_flow_weights as j_pack
from repro.kernels.ref import nf_forward_ref

from repro_torch.core.flow import FlowConfig, flow_forward_with_logdet
from repro_torch.core.flow import materialize_weights
from repro_torch.core.train_flow import FlowTrainConfig, FlowTrainer
from repro_torch.data.datasets import make_dataset
from repro_torch.kernels import ops
from repro_torch.kernels.nf_forward import nf_forward_plain, pack_flow_weights
from repro_torch.weights import params_from_numpy

torch.set_num_threads(1)

EPS32 = float(np.finfo(np.float32).eps)
# z bound: XLA evaluates tanh with its own approximation and may contract
# a*b+c into an FMA, torch rounds every op and calls libm's tanhf; the
# two differ by a few ulp per tanh, which the output layer carries into
# z.  Measured at most ~3 ulp of max|z| on these flows; bound 8.
Z_ULPS = 8


def _jax_flow(dim, hidden, layers, seed):
    cfg = JFlowConfig(dim=dim, hidden=hidden, layers=layers)
    params = j_init_flow(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)
    params["out_log_scale"] = jnp.asarray(
        rng.normal(0, 1, dim).astype(np.float32))
    params["feat_mu"] = jnp.asarray(rng.normal(0, 3, dim).astype(np.float32))
    params["feat_sd"] = jnp.asarray(rng.uniform(0.5, 3, dim)
                                    .astype(np.float32))
    return cfg, params, rng


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("dim,hidden,layers", [(2, 2, 2), (3, 2, 2),
                                               (4, 3, 3), (6, 4, 4)])
def test_nf_forward_plain_matches_pallas(dim, hidden, layers):
    cfg, params, rng = _jax_flow(dim, hidden, layers, dim * 7 + layers)
    weights = j_materialize(params, cfg)
    out_scale = jnp.exp(params["out_log_scale"])
    packed, shapes = j_pack(weights, out_scale, params["feat_mu"],
                            params["feat_sd"])
    feats = rng.normal(0, 4, (1024, dim)).astype(np.float32)
    z_pallas = np.asarray(nf_forward_pallas(jnp.asarray(feats), packed,
                                            shapes, dim, interpret=True))
    z_ref = np.asarray(nf_forward_ref(jnp.asarray(feats), weights, out_scale,
                                      params["feat_mu"], params["feat_sd"]))
    z_port = nf_forward_plain(torch.from_numpy(feats),
                              torch.from_numpy(np.array(packed)), shapes,
                              dim).numpy()
    bound = Z_ULPS * EPS32 * np.abs(z_pallas).max()
    assert np.abs(z_port - z_pallas).max() <= bound
    assert np.abs(z_port - z_ref).max() <= bound


@pytest.mark.parametrize("dim,hidden,layers", [(2, 2, 2), (4, 3, 3)])
def test_pack_flow_weights_bitwise(dim, hidden, layers):
    cfg, params, _ = _jax_flow(dim, hidden, layers, 11)
    weights = j_materialize(params, cfg)
    out_scale = jnp.exp(params["out_log_scale"])
    packed, shapes = j_pack(weights, out_scale, params["feat_mu"],
                            params["feat_sd"])
    t_weights = [(torch.from_numpy(np.array(w)), torch.from_numpy(np.array(b)))
                 for w, b in weights]
    t_packed, t_shapes = pack_flow_weights(
        t_weights, torch.from_numpy(np.array(out_scale)),
        torch.from_numpy(np.array(params["feat_mu"])),
        torch.from_numpy(np.array(params["feat_sd"])))
    assert t_shapes == shapes
    assert t_packed.shape == tuple(packed.shape)
    assert np.array_equal(t_packed.numpy().view(np.int32),
                          np.asarray(packed).view(np.int32))


def test_materialize_weights_close():
    cfg, params, _ = _jax_flow(3, 2, 3, 5)
    t_cfg = FlowConfig(dim=3, hidden=2, layers=3)
    t_params = params_from_numpy(_np_tree(params), "cpu")
    for (jw, jb), (tw, tb) in zip(j_materialize(params, cfg),
                                  materialize_weights(t_params, t_cfg)):
        # exp differs by at most 1 ulp between XLA and torch
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=2 * EPS32,
                                   atol=0)
        assert np.array_equal(tb.numpy(), np.asarray(jb))


def test_flow_forward_with_logdet_matches_jax():
    """Inputs inside tanh's unsaturated range: at saturation the
    Jacobian diagonal is 1 - tanh^2 of a value within an ulp of 1, which
    no two tanh implementations agree on in relative terms."""
    cfg, params, rng = _jax_flow(2, 2, 2, 3)
    params["feat_mu"] = jnp.zeros(2, jnp.float32)
    params["feat_sd"] = jnp.ones(2, jnp.float32)
    x = rng.normal(0, 1, (512, 2)).astype(np.float32)
    zj, lj = j_logdet(params, jnp.asarray(x), cfg)
    t_params = params_from_numpy(_np_tree(params), "cpu")
    zt, lt = flow_forward_with_logdet(t_params, torch.from_numpy(x),
                                      FlowConfig())
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-5,
                               atol=1e-5)


def test_nf_transform_keys_matches_jax():
    keys = make_dataset("lognormal", 6000)
    params, norm, _ = j_train_flow(keys, JFlowConfig(), JTrainConfig(epochs=1))
    z_jax = j_ops.nf_transform_keys(params, norm, keys, JFlowConfig())
    t_params = params_from_numpy(_np_tree(params), "cpu")
    z_port = ops.nf_transform_keys(t_params, norm, keys, FlowConfig(),
                                   device="cpu")
    assert z_port.dtype == np.float64 and z_port.shape == keys.shape
    # exp() in the weight materialization adds one more ulp per weight
    bound = 2 * Z_ULPS * EPS32 * np.abs(z_jax).max()
    assert np.abs(z_port - z_jax).max() <= bound


def test_flow_trainer_steps_match_jax():
    """Same sample, standardization, minibatch order and initial
    parameters: 20 AdamW steps land within 1e-6 of each other."""
    keys = make_dataset("longlat", 20000)
    jt = JFlowTrainer(keys, JFlowConfig(), JTrainConfig(epochs=3))
    tt = FlowTrainer(keys, FlowConfig(), FlowTrainConfig(epochs=3),
                     device="cpu")
    assert np.array_equal(tt._mu, jt._mu) and np.array_equal(tt._sd, jt._sd)
    assert np.array_equal(tt._x_all.numpy(), np.asarray(jt._x_all))
    tt.params = params_from_numpy(_np_tree(jt.params), "cpu")
    for _ in range(20):
        jt.step()
        tt.step()
    assert len(tt.losses) == len(jt.losses) == 20
    np.testing.assert_allclose(tt.losses, jt.losses, rtol=1e-6)
    jp = _np_tree(jt.params)
    for i, layer in enumerate(jp["layers"]):
        for k in ("w", "b"):
            np.testing.assert_allclose(tt.params["layers"][i][k].numpy(),
                                       layer[k], rtol=0, atol=1e-6)
    np.testing.assert_allclose(tt.params["out_log_scale"].numpy(),
                               jp["out_log_scale"], rtol=0, atol=1e-6)


def test_train_flow_result_contract():
    keys = make_dataset("lognormal", 4000)
    tt = FlowTrainer(keys, FlowConfig(), FlowTrainConfig(epochs=2),
                     device="cpu")
    while not tt.step():
        pass
    params, norm, metrics = tt.result()
    assert set(params) == {"layers", "out_log_scale", "feat_mu", "feat_sd"}
    assert metrics["n_steps"] == len(tt.losses) > 0
    assert np.isfinite(metrics["final_loss"])
    assert norm.mu == float(keys.min())
