"""The dense model on a (2, 2) data x model mesh of 4 gloo ranks, held
to the JAX package's unsharded functions.

One spawn of 4 ranks (``file://`` rendezvous, each joined with its own
timeout) runs ``_torch_dist_workers.run_mesh_rank``: qwen3-14b's smoke
config in f32 twice, once as it is (2 kv heads: a rank computes its own
heads) and once with 1 kv head (its flat columns split into half a head
a rank, so every rank gathers them and computes every head).  The
numpy-seeded parameters are the JAX ``model.init`` tree's, carried
across; the ranks place them by ``param_sharding``, train and decode on
their rows, and gather what they computed.  The test process runs the
JAX legs.  Tolerances (f32; the ranks sum products and gradients in
other orders than XLA):

* forward logits and decode logits: ``LOGIT_TOL`` of the largest
  |logit|;
* loss ``LOSS_TOL`` relative; each gradient leaf ``GRAD_TOL`` of its
  largest |g| (``test_torch_train_loss.py``'s bounds);
* two AdamW steps (``fsdp`` and the microbatch rule): the moments each
  ``STEP_TOL`` of their largest |x| (``test_torch_train.py``'s bound),
  the parameters ``ADAM_PARAM_TOL``: qk-norm leaves some of ``wq``'s
  gradient components at f32 noise, and Adam divides each by its own
  RMS, so their updates follow the summation order (the meshless port
  itself is 1.0e-3 off JAX on ``wq`` here);
* two Adafactor steps against the port's meshless steps: ``STEP_TOL``;
* the decode step's written K/V caches: ``LOGIT_TOL``;
* a checkpoint saved on (2, 2) restores bit for bit on (1, 2) and onto
  no mesh; the resumed losses are within ``RESUME_TOL`` of the
  uninterrupted run's (a (1, 2) mesh sums over data ranks no more).
"""

import multiprocessing as mp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_workers as W
from repro.configs import get_config as j_get_config
from repro.models import transformer as j_tfm
from repro.models.model import build_model as j_build_model
from repro.train import optimizer as jopt
from repro.train.schedule import ScheduleConfig as JScheduleConfig
from repro.train.train_step import TrainConfig as JTrainConfig
from repro.train.train_step import TrainState as JTrainState
from repro.train.train_step import make_train_step as j_make_train_step

from repro_torch.configs import get_config
from repro_torch.train.optimizer import AdafactorConfig

WORLD = 4
JOIN_S = 150
LOGIT_TOL = 2e-5
LOSS_TOL = 2e-6
GRAD_TOL = 1e-4
STEP_TOL = 1e-4
ADAM_PARAM_TOL = 4e-3
RESUME_TOL = 1e-5
CASES = list(W.MESH_CASES)


def _jax_pair(case):
    jcfg = W.mesh_cfg(W.MESH_CASES[case], j_get_config)
    jm = j_build_model(jcfg)
    return jcfg, jm, jm.init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    for case in CASES:
        _jcfg, _jm, jp = _jax_pair(case)
        np.savez(tmp / f"params_{case}.npz", **W.flat_params(
            jax.tree.map(np.asarray, jp)))
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=W.run_mesh_rank,
                         args=(r, WORLD, str(tmp / "store"), str(tmp)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    hung = []
    for r, p in enumerate(procs):
        p.join(JOIN_S)
        if p.is_alive():
            hung.append(r)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    assert not hung, f"ranks {hung} still running after {JOIN_S} s"
    codes = [p.exitcode for p in procs]
    assert codes == [0] * WORLD, f"rank exit codes {codes}"
    return [torch.load(tmp / f"mesh_rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def _rows(ranks, case, key):
    """The batch's rows from the data ranks (model coordinate 0)."""
    return torch.cat([ranks[0][case][key], ranks[2][case][key]]).numpy()


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("case", CASES)
def test_layout_and_local_shards(ranks, case):
    """The heads split over ``model`` only where the kv heads divide;
    every rank keeps only its blocks."""
    r = ranks[0][case]
    assert r["heads"] is (case == "divides")
    assert r["mlp"] and r["vocab"]
    cfg = W.mesh_cfg(W.MESH_CASES[case], get_config)
    a, d = cfg.attn, cfg.d_model
    sh = r["local_shapes"]
    assert sh["layers/attn/wq"] == (cfg.n_layers, d // 2,
                                    a.n_heads * a.head_dim // 2)
    assert sh["layers/attn/wk"] == (cfg.n_layers, d // 2,
                                    a.kv_heads * a.head_dim // 2)
    assert sh["embed"] == (cfg.vocab // 2, d // 2)
    kv = a.kv_heads // 2 if case == "divides" else a.kv_heads
    assert r["cache_local"] == (cfg.n_layers, W.MESH_ROWS // 2, W.MESH_S,
                                kv, a.head_dim)


@pytest.mark.parametrize("case", CASES)
def test_forward_logits_match_jax(ranks, case):
    jcfg, jm, jp = _jax_pair(case)
    toks, _ = W.mesh_batch(jcfg)
    x, _ = j_tfm.forward(jp, jnp.asarray(toks), jcfg)
    want = np.asarray(x @ jp["unembed"].T)
    for r in (0, 1):     # the model ranks of a data row agree
        assert _rel(ranks[r][case]["logits"], want[:2]) <= LOGIT_TOL
    assert _rel(_rows(ranks, case, "logits"), want) <= LOGIT_TOL


@pytest.mark.parametrize("case", CASES)
def test_loss_and_gathered_grads_match_jax(ranks, case):
    jcfg, jm, jp = _jax_pair(case)
    toks, tg = W.mesh_batch(jcfg)
    (jl, _), jg = jax.value_and_grad(jm.train_loss, has_aux=True)(
        jp, {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tg)})
    for r in ranks:
        np.testing.assert_allclose(float(r[case]["loss"]), float(jl),
                                   rtol=LOSS_TOL)
    want = W.flat_params(jax.tree.map(np.asarray, jg))
    got = W.flat_params(ranks[0][case]["grads"])
    assert set(got) == set(want)
    worst = max((_rel(got[p].numpy(), want[p]), p) for p in want)
    print(case, "worst gradient leaf", worst)
    assert worst[0] <= GRAD_TOL, worst


@pytest.mark.parametrize("case", CASES)
def test_adamw_steps_under_fsdp_match_jax(ranks, case):
    jcfg, jm, jp = _jax_pair(case)
    jo = jopt.AdamWConfig(lr=W.MESH_LR)
    jt = JTrainConfig(optimizer=jo, schedule=JScheduleConfig(
        peak_lr=W.MESH_LR, warmup_steps=1, total_steps=10), microbatches=2)
    js = JTrainState(jp, jopt.adamw_init(jp, jo), jnp.zeros((), jnp.int32))
    step = jax.jit(j_make_train_step(jm, jt))
    toks, tg = W.mesh_batch(jcfg)
    for _ in range(2):
        js, jmet = step(js, {"tokens": jnp.asarray(toks),
                             "targets": jnp.asarray(tg)})
    got = ranks[1][case]["adamw"]
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(got["metrics"][k], float(jmet[k]),
                                   rtol=2e-5, err_msg=k)
    want = jax.tree.leaves(jax.tree.map(np.asarray, js))
    state = list(got["state"].items())
    assert len(state) == len(want)
    diffs = [(_rel(x.numpy(), w), p) for (p, x), w in zip(state, want)]
    params = max(d for d in diffs if d[1].startswith("params/"))
    moments = max(d for d in diffs if not d[1].startswith("params/"))
    print(case, "worst AdamW leaf: params", params, "moments", moments)
    assert params[0] <= ADAM_PARAM_TOL, params
    assert moments[0] <= STEP_TOL, moments


@pytest.mark.parametrize("case", CASES)
def test_adafactor_steps_match_unsharded(ranks, case):
    from repro_torch.weights import model_params_from_numpy

    jcfg, _jm, jp = _jax_pair(case)
    cfg = W.mesh_cfg(W.MESH_CASES[case], get_config)
    params = model_params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                     "cpu")
    want, met = W.unsharded_steps(cfg, params, AdafactorConfig(
        lr=W.MESH_LR, min_dim_factored=64))
    got = ranks[3][case]["adafactor"]
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(got["metrics"][k], met[k], rtol=2e-5,
                                   err_msg=k)
    assert list(got["state"]) == list(want)
    worst = max((_rel(x.numpy(), want[p].numpy()), p)
                for p, x in got["state"].items())
    print(case, "worst Adafactor state leaf", worst)
    assert worst[0] <= STEP_TOL, worst


@pytest.mark.parametrize("case", CASES)
def test_decode_step_on_local_heads_matches_jax(ranks, case):
    jcfg, jm, jp = _jax_pair(case)
    kc, vc, lens, toks = W.mesh_decode_inputs(jcfg)
    state = {"k_cache": jnp.asarray(kc), "v_cache": jnp.asarray(vc),
             "cache_len": jnp.asarray(lens)}
    logits, new = jm.decode_step(jp, state, jnp.asarray(toks))
    assert _rel(_rows(ranks, case, "decode_logits"),
                np.asarray(logits)) <= LOGIT_TOL
    got = ranks[0][case]["decode_state"]
    for k in ("k_cache", "v_cache"):
        assert _rel(got[k].numpy(), np.asarray(new[k])) <= LOGIT_TOL, k
    assert np.array_equal(got["cache_len"].numpy(),
                          np.asarray(new["cache_len"]))


def test_checkpoint_saved_on_2x2_restores_on_1x2_and_no_mesh(ranks):
    for r, out in enumerate(ranks):
        c = out["ckpt"]
        assert c["active"] is (r < 2)
        if not c["active"]:
            continue
        assert list(c["restored"]) == list(c["saved"])
        for p, x in c["saved"].items():
            assert torch.equal(c["restored"][p], x), p
            assert torch.equal(c["meshless"][1][p], x), p
        assert c["meshless"][0] == 2
        np.testing.assert_allclose(c["resumed"], c["uninterrupted"][2:],
                                   rtol=RESUME_TOL)
        # each restore reads the bytes of the blocks it fills, no more
        assert c["read"][0] == c["read"][1]
        assert c["read_meshless"][0] == c["read_meshless"][1]


def test_remesh_moves_the_state_block_by_block(ranks):
    """The run saved at step 2 on (2, 2) re-meshed onto (1, 2): ranks 0-1
    hold the same whole state, bit for bit, each having read only the
    bytes of its new blocks; ranks 2-3 hold none; the staging directory
    is gone."""
    for r, out in enumerate(ranks):
        c = out["ckpt"]
        assert c["remesh_active"] is (r < 2)
        assert c["remesh_left"] == []
        if not c["remesh_active"]:
            continue
        assert c["remesh_read"][0] == c["remesh_read"][1]
        assert c["remesh_read"][1] < sum(
            x.numel() * x.element_size() for x in c["saved"].values())
        assert list(c["remeshed"]) == list(c["saved"])
        for p, x in c["saved"].items():
            assert torch.equal(c["remeshed"][p], x), p


def test_elastic_demo_halves_the_mesh(ranks):
    """``launch.train --mesh 2x2:data,model --elastic-demo``: 2 steps on
    (2, 2), then ranks 0-1 go on alone on (1, 2)."""
    for r, out in enumerate(ranks):
        e = out["elastic"]
        assert e["mesh"] == (1, 2)
        assert e["active"] is (r < 2)
        assert len(e["losses"]) == (4 if r < 2 else 2)
        assert np.isfinite(e["losses"]).all()
    np.testing.assert_array_equal(ranks[0]["elastic"]["losses"],
                                  ranks[1]["elastic"]["losses"])
