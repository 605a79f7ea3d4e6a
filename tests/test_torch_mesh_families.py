"""The moe, ssm and hybrid models on a (2, 2) data x model mesh of 4 gloo
ranks, held to the JAX package's unsharded functions.

One spawn of 4 ranks (``file://`` rendezvous, each joined with its own
timeout) runs ``_torch_dist_workers.run_family_rank`` over
``FAMILY_CASES``: granite-moe-1b-a400m's and arctic-480b's smoke configs
(experts over ``model``, arctic's dense residual MLP over ``mlp``), one
granite case routed with ``capacity_factor`` 0.5 over four token chunks
(pairs dropped across the data ranks' boundary), falcon-mamba-7b's
(Mamba1 on a rank's ``d_inner`` block; also through ``use_scan_kernel``,
whose plain version runs here) and zamba2-2.7b's (Mamba2 on a rank's heads, the shared
attention block's heads and MLP columns over ``model``), all in f32.
The numpy-seeded parameters are the JAX ``model.init`` tree's, carried
across; the ranks place them by ``param_sharding``, train and decode on
their rows, and gather what they computed.  The test process runs the
JAX legs (the chunked scan: the JAX kernel route expects
``d_inner``-local shards on a mesh).  Tolerances (f32; the ranks sum
products and gradients in other orders than XLA):

* forward, prefill and decode logits: ``LOGIT_TOL`` of the largest
  |logit|; the decode step's new state likewise;
* loss (aux included) ``LOSS_TOL`` relative; each gradient leaf
  ``GRAD_TOL`` of its largest |g|;
* two AdamW steps: the moments each ``STEP_TOL`` of their largest |x|,
  the parameters ``ADAM_PARAM_TOL`` (``test_torch_mesh.py``'s bound:
  Adam divides each gradient component by its own RMS, so components at
  f32 noise follow the summation order; the meshless port itself is
  2.6e-4 off JAX on falcon's ``w_in`` and 5.5e-4 on zamba2's ``w_bc``
  here).  Every case takes two microbatches: a rank's rows of each are
  its block of the JAX step's (``rank_rows``), so the MoE cases route
  the reference's groups of rows;
  arctic's two Adafactor steps (its optimizer at full size, ``vr``/
  ``vc`` on the ``[L, E, D, F]`` expert leaves) against the port's
  meshless steps, ``STEP_TOL``;
* the dropped-pair case's ``slot`` and ``keep``: integer-equal to the
  meshless route's;
* a checkpoint saved on (2, 2) restores, and re-meshes, bit for bit on
  (1, 2) for one moe and one ssm case.
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
CASES = list(W.FAMILY_CASES)
TRAINED = [c for c in CASES if c not in W.FORWARD_ONLY]
CKPT = ("granite", "falcon")


def _jax_cfg(case):
    """The JAX reference's config: the chunked scan (see the module
    docstring)."""
    import dataclasses

    jcfg = W.family_cfg(case, j_get_config)
    if jcfg.ssm is not None and jcfg.ssm.use_scan_kernel:
        jcfg = dataclasses.replace(jcfg, ssm=dataclasses.replace(
            jcfg.ssm, use_scan_kernel=False))
    return jcfg


_PAIRS = {}
# the cases whose JAX reference is another's (the scan kernel changes
# nothing in an unsharded JAX run)
_SAME_JAX = {"falcon_kernel": "falcon"}
_MEMO = {}


def _jax_pair(case):
    if case not in _PAIRS:
        jcfg = _jax_cfg(case)
        jm = j_build_model(jcfg)
        _PAIRS[case] = (jcfg, jm, jm.init(jax.random.PRNGKey(0)))
    return _PAIRS[case]


def _memo(leg, case, fn):
    key = (leg, _SAME_JAX.get(case, case))
    if key not in _MEMO:
        _MEMO[key] = fn()
    return _MEMO[key]


def _batch(jcfg):
    toks, tg = W.mesh_batch(jcfg)
    return {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tg)}


def _forward_ref(case):
    """(logits of ``forward``, its aux, prefill logits) of the JAX model."""
    jcfg, jm, jp = _jax_pair(case)
    toks, _ = W.mesh_batch(jcfg)

    def run():
        x, aux = jax.jit(lambda p, t: j_tfm.forward(p, t, jcfg))(
            jp, jnp.asarray(toks))
        scale = jcfg.d_model ** -0.5 if jcfg.tie_embeddings else 1.0
        un = jp["embed"] if jcfg.tie_embeddings else jp["unembed"]
        pl = jax.jit(lambda p, t: jm.prefill(p, t, W.MESH_S)[1])(
            jp, jnp.asarray(toks))
        return np.asarray((x * scale) @ un.T), float(aux), np.asarray(pl)

    return _memo("forward", case, run)


def _grads_ref(case):
    """((loss, metrics), gradients) of the JAX ``train_loss``."""
    jcfg, jm, jp = _jax_pair(case)
    return _memo("grads", case, lambda: jax.jit(jax.value_and_grad(
        jm.train_loss, has_aux=True))(jp, _batch(jcfg)))


def _adamw_ref(case):
    """(state, metrics) after two JAX AdamW steps of ``W.MICRO``
    microbatches."""
    jcfg, jm, jp = _jax_pair(case)

    def run():
        jo = jopt.AdamWConfig(lr=W.MESH_LR)
        jt = JTrainConfig(optimizer=jo, schedule=JScheduleConfig(
            peak_lr=W.MESH_LR, warmup_steps=1, total_steps=10),
            microbatches=W.MICRO)
        js = JTrainState(jp, jopt.adamw_init(jp, jo),
                         jnp.zeros((), jnp.int32))
        step = jax.jit(j_make_train_step(jm, jt))
        for _ in range(2):
            js, jmet = step(js, _batch(jcfg))
        return js, jmet

    return _memo("adamw", case, run)


def _decode_ref(case):
    """(logits, new state) of one JAX decode step."""
    jcfg, jm, jp = _jax_pair(case)
    whole, toks = W.family_decode_inputs(jcfg)
    return _memo("decode", case, lambda: jax.jit(jm.decode_step)(
        jp, {k: jnp.asarray(v) for k, v in whole.items()},
        jnp.asarray(toks)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("families")
    for case in CASES:
        _jcfg, _jm, jp = _jax_pair(case)
        np.savez(tmp / f"params_{case}.npz", **W.flat_params(
            jax.tree.map(np.asarray, jp)))
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=W.run_family_rank,
                         args=(r, WORLD, str(tmp / "store"), str(tmp),
                               tuple(CASES), CKPT))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    # the JAX references, computed while the ranks run
    for case in CASES:
        _forward_ref(case)
        _decode_ref(case)
        if case in TRAINED:
            _grads_ref(case)
            _adamw_ref(case)
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
    return [torch.load(tmp / f"family_rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def _rows(ranks, case, key):
    """The batch's rows from the data ranks (model coordinate 0)."""
    return torch.cat([ranks[0][case][key], ranks[2][case][key]]).numpy()


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("case", CASES)
def test_layout_splits_what_divides(ranks, case):
    """Experts, ``d_inner`` and the shared block's heads split over
    ``model``; the decode state holds the rank's rows and channels."""
    r = ranks[0][case]
    cfg = W.family_cfg(case, get_config)
    plan = r["plan"]
    assert plan["vocab"]
    assert plan["experts"] is (cfg.family == "moe")
    assert plan["ssm"] is (cfg.ssm is not None)
    sh, st = r["local_shapes"], r["state_local"]
    assert st["cache_len"] == (W.MESH_ROWS // 2,)
    if cfg.moe is not None:
        m = cfg.moe
        assert sh["layers/moe/we_gate"] == (cfg.n_layers, m.n_experts // 2,
                                            cfg.d_model // 2, m.d_ff_expert)
    if cfg.ssm is not None:
        di = cfg.ssm.expand * cfg.d_model
        assert sh["layers/ssm/w_in"][-1] == di
        assert st["ssm_conv"][-1] == di // 2
    if cfg.family == "hybrid":
        assert plan["heads"] and plan["mlp"]
        a = cfg.attn
        assert st["k_cache"][-2] == a.kv_heads // 2


@pytest.mark.parametrize("case", CASES)
def test_forward_and_prefill_logits_match_jax(ranks, case):
    want, aux, pl = _forward_ref(case)
    for r in (0, 1):     # the model ranks of a data row agree
        assert _rel(ranks[r][case]["logits"], want[:2]) <= LOGIT_TOL
    assert _rel(_rows(ranks, case, "logits"), want) <= LOGIT_TOL
    # the ranks' aux parts sum to the reference's
    got = float(ranks[0][case]["aux"]) + float(ranks[2][case]["aux"])
    np.testing.assert_allclose(got, aux, rtol=LOSS_TOL, atol=1e-12)
    assert _rel(_rows(ranks, case, "prefill_logits"), pl) <= LOGIT_TOL


@pytest.mark.parametrize("case", TRAINED)
def test_loss_and_gathered_grads_match_jax(ranks, case):
    (jl, jmet), jg = _grads_ref(case)
    for r in ranks:
        np.testing.assert_allclose(float(r[case]["loss"]), float(jl),
                                   rtol=LOSS_TOL)
        np.testing.assert_allclose(float(r[case]["metrics"]["aux"]),
                                   float(jmet["aux"]), rtol=LOSS_TOL,
                                   atol=1e-12)
    want = W.flat_params(jax.tree.map(np.asarray, jg))
    got = W.flat_params(ranks[0][case]["grads"])
    assert set(got) == set(want)
    worst = max((_rel(got[p].numpy(), want[p]), p) for p in want)
    print(case, "worst gradient leaf", worst)
    assert worst[0] <= GRAD_TOL, worst


@pytest.mark.parametrize("case", TRAINED)
def test_adamw_steps_match_jax(ranks, case):
    js, jmet = _adamw_ref(case)
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


def test_arctic_adafactor_steps_match_unsharded(ranks):
    from repro_torch.weights import model_params_from_numpy

    _jcfg, _jm, jp = _jax_pair("arctic")
    cfg = W.family_cfg("arctic", get_config)
    params = model_params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                     "cpu")
    want, met = W.unsharded_steps(cfg, params, AdafactorConfig(
        lr=W.MESH_LR, min_dim_factored=32), W.MICRO)
    got = ranks[3]["arctic"]["adafactor"]
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(got["metrics"][k], met[k], rtol=2e-5,
                                   err_msg=k)
    assert list(got["state"]) == list(want)
    # the expert leaves' second moments are factored
    assert want["opt/vr/layers/moe/we_up"].dim() == 3
    worst = max((_rel(x.numpy(), want[p].numpy()), p)
                for p, x in got["state"].items())
    print("arctic worst Adafactor state leaf", worst)
    assert worst[0] <= STEP_TOL, worst


@pytest.mark.parametrize("case", CASES)
def test_decode_step_matches_jax(ranks, case):
    logits, new = _decode_ref(case)
    assert _rel(_rows(ranks, case, "decode_logits"),
                np.asarray(logits)) <= LOGIT_TOL
    got = ranks[0][case]["decode_state"]
    assert set(got) == set(new)
    for k in new:
        if k == "cache_len":
            assert np.array_equal(got[k].numpy(), np.asarray(new[k]))
        else:
            assert _rel(got[k].numpy(), np.asarray(new[k])) <= LOGIT_TOL, k


def test_dropped_pairs_route_as_the_meshless_route(ranks):
    """The global chunk's slots and drops, integer-equal, with pairs
    dropped on both sides of the data ranks' boundary."""
    from repro_torch.models import moe as moe_mod
    from repro_torch.weights import model_params_from_numpy

    _jcfg, _jm, jp = _jax_pair("drop")
    cfg = W.family_cfg("drop", get_config)
    params = model_params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                     "cpu")
    xc = torch.from_numpy(W.route_input(cfg))
    _w, _e, slot, keep, cap, _aux = moe_mod.route(
        xc, {"router": params["layers"]["moe"]["router"][0]}, cfg.moe)
    n = slot.shape[0] // 2
    for r in range(WORLD):
        got = ranks[r]["drop"]["route"]
        half = slice(0, n) if r < 2 else slice(n, 2 * n)
        assert got["cap"] == cap
        assert torch.equal(got["slot"], slot[half]), r
        assert torch.equal(got["keep"], keep[half]), r
    assert not keep[:n].all() and not keep[n:].all()
    assert W.family_cfg("drop", get_config).moe.token_chunk // W.MESH_ROWS \
        < W.MESH_LEN    # more than one chunk a step


@pytest.mark.parametrize("tag", CKPT)
def test_checkpoint_saved_on_2x2_restores_on_1x2(ranks, tag):
    for r, out in enumerate(ranks):
        c = out[f"ckpt_{tag}"]
        assert c["active"] is (r < 2)
        if not c["active"]:
            continue
        for key in ("restored", "remeshed"):
            assert list(c[key]) == list(c["saved"])
            for p, x in c["saved"].items():
                assert torch.equal(c[key][p], x), (key, p)
