"""The vlm and encdec models, and the Mamba families under
``SSMConfig.batch_tp``, on meshes of 4 gloo ranks, held to the JAX
package's unsharded functions.

One spawn of 4 ranks (``file://`` rendezvous, each joined with its own
timeout) runs ``_torch_dist_workers.run_vlm_rank`` over ``VLM_CASES``:
llama-3.2-vision-11b's smoke config on (2, 2), where its 2 kv heads
split over ``model`` (the cross layers' too), and on (1, 4), where they
do not divide 4 and every rank computes every head on gathered weights
(the branch the real model's 8 kv heads take at ``model`` 16);
whisper-medium's on (2, 2) (encoder, decoder and cross-attention on the
rank's heads, the GELU MLP over ``mlp``, the tied vocabulary over
``model``); falcon-mamba-7b's and zamba2-2.7b's with ``batch_tp`` on
(2, 2) (the Mamba rows over ``model``, ``d_inner`` whole; a decode step
on the rank's ``d_inner`` block of whole weights).  All in f32; the
numpy-seeded parameters are the JAX ``model.init`` tree's, carried
across, and the numpy-seeded ``patches``/``frames`` go to both packages.
The ranks place the parameters by ``param_sharding``, train, prefill and
decode on their rows, and gather what they computed.  Tolerances
(``test_torch_mesh_families.py``'s, for the same reasons):

* forward and prefill logits: ``LOGIT_TOL`` of the largest |logit|; the
  prefill's state (the cross caches filled from the rank's kv heads)
  and the decode step's logits and new state (its cross caches
  included) likewise;
* loss ``LOSS_TOL`` relative; each gradient leaf ``GRAD_TOL`` of its
  largest |g| (the vlm cross layers' tanh ``gate`` among them: summed
  over the data ranks once, not once per model rank);
* two AdamW steps at two microbatches (a rank's rows each its block of
  the JAX step's, ``rank_rows``; under ``batch_tp`` a data rank's one
  row a microbatch does not split over ``model``, so those steps run
  every row on every model rank): the moments ``STEP_TOL``, the
  parameters ``ADAM_PARAM_TOL``;
* a trainer whose batches carry the stub inputs, saved on (2, 2),
  restores and re-meshes bit for bit on (1, 2), for one vlm case and
  the encdec case.
"""

import multiprocessing as mp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_workers as W
from repro.configs import get_config as j_get_config
from repro.models import encdec as j_encdec
from repro.models import transformer as j_tfm
from repro.models.model import build_model as j_build_model
from repro.train import optimizer as jopt
from repro.train.schedule import ScheduleConfig as JScheduleConfig
from repro.train.train_step import TrainConfig as JTrainConfig
from repro.train.train_step import TrainState as JTrainState
from repro.train.train_step import make_train_step as j_make_train_step

from repro_torch.configs import get_config

WORLD = 4
JOIN_S = 200
LOGIT_TOL = 2e-5
LOSS_TOL = 2e-6
GRAD_TOL = 1e-4
STEP_TOL = 1e-4
ADAM_PARAM_TOL = 4e-3
CASES = list(W.VLM_CASES)
CKPT = W.VLM_CKPT

_PAIRS = {}
# the cases whose JAX reference is another's (the mesh changes nothing
# in an unsharded JAX run)
_SAME_JAX = {"vlm_unsplit": "vlm"}
_MEMO = {}


def _jax_pair(case):
    if case not in _PAIRS:
        jcfg = W.vlm_cfg(case, j_get_config)
        jm = j_build_model(jcfg)
        _PAIRS[case] = (jcfg, jm, jm.init(jax.random.PRNGKey(0)))
    return _PAIRS[case]


def _memo(leg, case, fn):
    key = (leg, _SAME_JAX.get(case, case))
    if key not in _MEMO:
        _MEMO[key] = fn()
    return _MEMO[key]


def _extra(jcfg):
    return {k: jnp.asarray(v) for k, v in W.stub_inputs(jcfg).items()}


def _batch(jcfg):
    toks, tg = W.mesh_batch(jcfg)
    return {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tg),
            **_extra(jcfg)}


def _forward_ref(case):
    """(logits of the final hidden states, prefill state, prefill
    logits) of the JAX model."""
    jcfg, jm, jp = _jax_pair(case)
    toks = jnp.asarray(W.mesh_batch(jcfg)[0])
    extra = _extra(jcfg) or None

    def hidden(p, t, e):
        if jcfg.family == "encdec":
            enc = j_encdec.encode(p, e["frames"], jcfg)
            return j_encdec._decode_forward(p, t, enc, jcfg)
        return j_tfm.forward(p, t, jcfg, extra=e)[0]

    def run():
        x = jax.jit(hidden)(jp, toks, extra)
        scale = jcfg.d_model ** -0.5 if jcfg.tie_embeddings else 1.0
        un = jp["embed"] if jcfg.tie_embeddings else jp["unembed"]
        st, pl = jax.jit(lambda p, t, e: jm.prefill(p, t, W.MESH_S, e))(
            jp, toks, extra)
        return (np.asarray((x * scale) @ un.T),
                jax.tree.map(np.asarray, st), np.asarray(pl))

    return _memo("forward", case, run)


def _grads_ref(case):
    jcfg, jm, jp = _jax_pair(case)
    return _memo("grads", case, lambda: jax.jit(jax.value_and_grad(
        jm.train_loss, has_aux=True))(jp, _batch(jcfg)))


def _adamw_ref(case):
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
    jcfg, jm, jp = _jax_pair(case)
    whole, toks = W.family_decode_inputs(jcfg)
    return _memo("decode", case, lambda: jax.jit(jm.decode_step)(
        jp, {k: jnp.asarray(v) for k, v in whole.items()},
        jnp.asarray(toks)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("vlm_encdec")
    for case in CASES:
        _jcfg, _jm, jp = _jax_pair(case)
        np.savez(tmp / f"params_{case}.npz", **W.flat_params(
            jax.tree.map(np.asarray, jp)))
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=W.run_vlm_rank,
                         args=(r, WORLD, str(tmp / "store"), str(tmp),
                               tuple(CASES), CKPT))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    # the JAX references, computed while the ranks run
    for case in CASES:
        _forward_ref(case)
        _decode_ref(case)
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
    return [torch.load(tmp / f"vlm_rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def _data_ranks(case):
    """One rank of each data row (model coordinate 0), in data order."""
    d, m = W.VLM_CASES[case][2]
    return [i * m for i in range(d)]


def _rows(ranks, case, key):
    return torch.cat([ranks[r][case][key]
                      for r in _data_ranks(case)]).numpy()


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("case", CASES)
def test_layout_splits_what_divides(ranks, case):
    """The heads (the cross layers' and cross caches' too) split over
    ``model`` where ``kv_heads`` divides; under ``batch_tp`` the Mamba
    weights keep ``d_inner`` whole and the rows split, while the decode
    state holds the rank's ``d_inner`` block."""
    r = ranks[0][case]
    cfg = W.vlm_cfg(case, get_config)
    m = W.VLM_CASES[case][2][1]
    plan, sh, st = r["plan"], r["local_shapes"], r["state_local"]
    assert plan["vocab"]
    assert st["cache_len"] == (W.MESH_ROWS // W.VLM_CASES[case][2][0],)
    if cfg.attn is not None and cfg.family != "hybrid":
        a = cfg.attn
        split = a.kv_heads % m == 0
        assert plan["heads"] is split
        kvh = a.kv_heads // m if split else a.kv_heads
        assert st["k_cache"][-2] == kvh
        assert st["cross_k"][-2] == kvh
        key = ("cross_layers/attn/wk" if cfg.family == "vlm"
               else "dec_layers/cross/wk")
        # the stored columns split either way (guarded_spec on the flat
        # kv_heads * head_dim axis); unsplit heads gather them
        assert sh[key][-1] == a.kv_heads * a.head_dim // m
    if cfg.ssm is not None:
        di = cfg.ssm.expand * cfg.d_model
        assert not plan["ssm"] and plan["rows"]
        assert sh["layers/ssm/w_in"] == (cfg.n_layers, cfg.d_model // 2,
                                         2 * di)
        assert st["ssm_conv"][-1] == di // m


@pytest.mark.parametrize("case", CASES)
def test_forward_and_prefill_match_jax(ranks, case):
    want, pst, pl = _forward_ref(case)
    d, m = W.VLM_CASES[case][2]
    rows = W.MESH_ROWS // d
    for r in range(m):     # the model ranks of a data row agree
        assert _rel(ranks[r][case]["logits"], want[:rows]) <= LOGIT_TOL
    assert _rel(_rows(ranks, case, "logits"), want) <= LOGIT_TOL
    assert _rel(_rows(ranks, case, "prefill_logits"), pl) <= LOGIT_TOL
    got = ranks[0][case]["prefill_state"]
    assert set(got) == set(pst)
    for k in pst:
        if k == "cache_len":
            assert np.array_equal(got[k].numpy(), pst[k])
        elif np.abs(pst[k]).max() > 0:
            assert _rel(got[k].numpy(), pst[k]) <= LOGIT_TOL, k
        else:
            assert not got[k].any(), k


@pytest.mark.parametrize("case", CASES)
def test_loss_and_gathered_grads_match_jax(ranks, case):
    (jl, _jmet), jg = _grads_ref(case)
    for r in ranks:
        np.testing.assert_allclose(float(r[case]["loss"]), float(jl),
                                   rtol=LOSS_TOL)
    want = W.flat_params(jax.tree.map(np.asarray, jg))
    got = W.flat_params(ranks[0][case]["grads"])
    assert set(got) == set(want)
    worst = max((_rel(got[p].numpy(), want[p]), p) for p in want)
    print(case, "worst gradient leaf", worst)
    assert worst[0] <= GRAD_TOL, worst
    if case == "vlm":
        assert _rel(got["cross_layers/gate"].numpy(),
                    want["cross_layers/gate"]) <= GRAD_TOL


@pytest.mark.parametrize("case", CASES)
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


@pytest.mark.parametrize("tag", CKPT)
def test_checkpoint_saved_on_2x2_restores_on_1x2(ranks, tag):
    for r, out in enumerate(ranks):
        c = out[f"ckpt_{tag}"]
        assert len(c["losses"]) == 2 and np.all(np.isfinite(c["losses"]))
        assert c["active"] is (r < 2)
        if not c["active"]:
            continue
        for key in ("restored", "remeshed"):
            assert list(c[key]) == list(c["saved"])
            for p, x in c["saved"].items():
                assert torch.equal(c[key][p], x), (key, p)
