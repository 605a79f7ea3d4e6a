"""The port's optimizers, train step and trainer.

Against the JAX package: ``adamw_update``/``adafactor_update`` given the
same gradients.  AdamW's moments are bit-equal while the clip is
inactive; XLA's f32 ``sqrt`` on the CPU is not correctly rounded (1 ulp
off in about 1% of elements, where PyTorch's is exact), and the
libraries' means, ``pow``, ``rsqrt`` and global-norm sums round
differently, so every leaf is held to ``OPT_TOL`` as max |d| over max
|x| (an ulp of an update can be many ulps of a parameter it nearly
cancels); and
three ``make_train_step`` steps from one state carried across with
``train_state_from_numpy``, m = 1 and m = 2 microbatches.  The port's own
counterparts of ``tests/test_train.py``: convergence on a quadratic,
Adafactor's factored state, loss decreasing, the straggler watchdog,
microbatching, and the launcher."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models.model import build_model as j_build_model
from repro.train import optimizer as jopt
from repro.train.schedule import ScheduleConfig as JScheduleConfig
from repro.train.train_step import TrainConfig as JTrainConfig
from repro.train.train_step import init_train_state as j_init_train_state
from repro.train.train_step import make_train_step as j_make_train_step

from repro_torch.configs import get_config
from repro_torch.data.tokens import SyntheticTokens
from repro_torch.models.model import build_model
from repro_torch.train import optimizer as topt
from repro_torch.train.checkpoint import tree_flatten
from repro_torch.train.optimizer import (AdafactorConfig, AdamWConfig,
                                         adafactor_init, adafactor_update,
                                         adafactor_update_, adamw_update,
                                         make_optimizer)
from repro_torch.train.schedule import ScheduleConfig
from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                          make_train_step)
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.weights import _leaf_from_numpy, train_state_from_numpy

torch.set_num_threads(1)

OPT_TOL = 1e-6      # optimizer on identical grads: max |d| / max |x|
STEP_TOL = 1e-4     # three train steps: max |dp| over max |p| per leaf


# ------------------------------------------------------------ optimizers
def _tree(rng):
    return {"a": rng.standard_normal((128, 160)).astype(np.float32) * 0.1,
         "b": {"c": rng.standard_normal((2, 128, 144)).astype(np.float32),
               "d": rng.standard_normal((64,)).astype(np.float32)},
         "e": rng.standard_normal((8, 200)).astype(np.float32),
         "g": np.float32(0.3)}


def _both(tree, bf16_keys=()):
    j = {k: (jnp.asarray(v, jnp.bfloat16) if k in bf16_keys else
             jnp.asarray(v)) if not isinstance(v, dict) else _both(v)[0]
         for k, v in tree.items()}
    return j, jax.tree.map(lambda x: _leaf_from_numpy(np.asarray(x), "cpu"),
                           j)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _grads(rng, tree, scale):
    return jax.tree.map(
        lambda p: np.asarray(rng.standard_normal(np.shape(p)) * scale,
                             np.float32), tree)


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
@pytest.mark.parametrize("grad_scale", [1e-3, 1.0])   # clip off, then on
@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_optimizer_update_matches_jax(kind, grad_scale, wd):
    rng = np.random.default_rng(0)
    base = _tree(rng)
    jp, tp = _both(base, bf16_keys=("e",))
    if kind == "adamw":
        jc, tc = (jopt.AdamWConfig(lr=1e-2, weight_decay=wd),
                  AdamWConfig(lr=1e-2, weight_decay=wd))
    else:
        jc, tc = (jopt.AdafactorConfig(lr=1e-2, weight_decay=wd),
                  AdafactorConfig(lr=1e-2, weight_decay=wd))
    jinit, jupd = jopt.make_optimizer(jc)
    # the functional update (new trees) and make_optimizer's in-place one
    tinit, tupd_ = make_optimizer(tc)
    fn = adamw_update if kind == "adamw" else adafactor_update
    tupd = lambda g, s, p, lr: fn(g, s, p, tc, lr)
    js, ts = jinit(jp), tinit(tp)
    tp_ = jax.tree.map(lambda x: x.clone(), tp)
    ts_ = tinit(tp_)
    worst = {}
    for i in range(3):
        g = _grads(rng, base, grad_scale)
        jg = jax.tree.map(jnp.asarray, g)
        tg = jax.tree.map(torch.from_numpy, g)
        lr = np.float32(1e-2 * (i + 1) / 3)
        jp, js, jn = jupd(jg, js, jp, lr=jnp.float32(lr))
        tlr = torch.tensor(float(lr), dtype=torch.float32)
        before = [x.clone() for _, x in tree_flatten((tp, ts))]
        tp_old, ts_old = tp, ts
        tp, ts, tn = tupd(tg, ts, tp, lr=tlr)
        assert all(torch.equal(a, b) for a, (_, b) in zip(
            before, tree_flatten((tp_old, ts_old)))), \
            "the functional update wrote into its inputs"
        tp_, ts_, tn_ = tupd_(tg, ts_, tp_, lr=tlr)
        assert torch.equal(tn, tn_)
        assert _rel(float(tn), float(jn)) <= OPT_TOL
        want = [np.asarray(x, np.float32) for x in
                jax.tree.leaves((jp, js))]
        got = [(p, x.float().numpy()) for p, x in tree_flatten((tp, ts))]
        got_ = [x.float().numpy() for _, x in tree_flatten((tp_, ts_))]
        assert len(want) == len(got)
        for (path, a), b, c in zip(got, got_, want):
            assert a.shape == c.shape, path
            assert np.array_equal(a.view(np.int32), b.view(np.int32)), \
                f"{path}: the in-place update differs from the functional one"
            worst[path] = max(worst.get(path, 0.0), _rel(a, c))
            if kind == "adamw" and grad_scale < 1 and path[2:3] in "mv":
                assert np.array_equal(a, c), path   # clip inactive
    print(kind, grad_scale, wd, "max rel err", max(worst.values()))
    assert max(worst.values()) <= OPT_TOL, worst


def test_adafactor_per_layer_statistics(monkeypatch):
    """A stacked leaf past the threshold updates layer by layer with each
    layer's own statistics: the same as each layer as its own leaf (the
    JAX ``lax.map``), and the in-place update gives the same bits."""
    monkeypatch.setattr(topt, "_PER_LAYER_BYTES", 1 << 10)
    rng = np.random.default_rng(1)
    p = rng.standard_normal((3, 128, 136)).astype(np.float32)
    cfg = AdafactorConfig(lr=1e-2, grad_clip=None)
    jcfg = jopt.AdafactorConfig(lr=1e-2, grad_clip=None)
    tp = {"w": torch.from_numpy(p.copy())}
    ts = adafactor_init(tp, cfg)
    tp_ = {"w": torch.from_numpy(p.copy())}
    ts_ = adafactor_init(tp_, cfg)
    jp = {f"l{i}": jnp.asarray(p[i]) for i in range(3)}
    js = jopt.adafactor_init(jp, jcfg)
    for _ in range(2):
        g = rng.standard_normal(p.shape).astype(np.float32)
        tp, ts, _ = adafactor_update({"w": torch.from_numpy(g)}, ts, tp, cfg)
        tp_, ts_, _ = adafactor_update_({"w": torch.from_numpy(g)}, ts_,
                                        tp_, cfg)
        jp, js, _ = jopt.adafactor_update(
            {f"l{i}": jnp.asarray(g[i]) for i in range(3)}, js, jp, jcfg)
    assert torch.equal(tp["w"], tp_["w"]) and torch.equal(ts.vr["w"],
                                                          ts_.vr["w"])
    assert ts.vr["w"].shape == (3, 128) and ts.vc["w"].shape == (3, 136)
    for i in range(3):
        assert _rel(tp["w"][i].numpy(), jp[f"l{i}"]) <= OPT_TOL
        assert _rel(ts.vr["w"][i].numpy(), js.vr[f"l{i}"]) <= OPT_TOL
        assert _rel(ts.vc["w"][i].numpy(), js.vc[f"l{i}"]) <= OPT_TOL


def _quadratic_losses(init_fn, update_fn, steps=60):
    params = {"w": torch.tensor([3.0, -2.0, 1.0]),
              "b": torch.full((4, 256), 2.0)}
    state = init_fn(params)
    losses = []
    for _ in range(steps):
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss = torch.sum(p["w"] ** 2) + torch.sum(p["b"] ** 2)
        gw, gb = torch.autograd.grad(loss, (p["w"], p["b"]))
        params, state, _ = update_fn({"w": gw, "b": gb}, state, params)
        losses.append(float(loss.detach()))
    return losses


def _pair(cfg, inplace):
    """make_optimizer's (init, in-place update), or the functional update
    in its place."""
    init, upd = make_optimizer(cfg)
    if inplace:
        return init, upd
    fn = adafactor_update if isinstance(cfg, AdafactorConfig) else \
        adamw_update
    return init, lambda g, s, p: fn(g, s, p, cfg)


@pytest.mark.parametrize("inplace", [False, True])
def test_adamw_converges(inplace):
    cfg = AdamWConfig(lr=0.1)
    init, upd = _pair(cfg, inplace)
    losses = _quadratic_losses(init, upd)
    assert losses[-1] < losses[0] * 0.05


@pytest.mark.parametrize("inplace", [False, True])
def test_adafactor_converges(inplace):
    cfg = AdafactorConfig(lr=0.3, min_dim_factored=4)
    init, upd = _pair(cfg, inplace)
    losses = _quadratic_losses(init, upd)
    assert losses[-1] < losses[0] * 0.2


def test_adafactor_state_is_factored():
    cfg = AdafactorConfig(min_dim_factored=8)
    params = {"w": torch.zeros((16, 32)), "tiny": torch.zeros((3,)),
              "stack": torch.zeros((4, 16, 24))}
    st = adafactor_init(params, cfg)
    assert st.vr["w"].shape == (16,)
    assert st.vc["w"].shape == (32,)
    assert st.vr["tiny"].shape == (3,)
    assert st.vc["tiny"].shape == (1,)
    assert st.vr["stack"].shape == (4, 16)
    assert st.vc["stack"].shape == (4, 24)


# ------------------------------------------------------------ train step
def _step_pair(arch, m, opt="adamw"):
    jm = j_build_model(j_get_config(arch, smoke=True))
    tm = build_model(get_config(arch, smoke=True), device="cpu")
    sched = dict(peak_lr=5e-3, warmup_steps=1, total_steps=10)
    if opt == "adamw":
        jo, to = jopt.AdamWConfig(lr=5e-3), AdamWConfig(lr=5e-3)
    else:
        jo = jopt.AdafactorConfig(lr=5e-3, min_dim_factored=64)
        to = AdafactorConfig(lr=5e-3, min_dim_factored=64)
    jt = JTrainConfig(optimizer=jo, schedule=JScheduleConfig(**sched),
                      microbatches=m)
    tt = TrainConfig(optimizer=to, schedule=ScheduleConfig(**sched),
                     microbatches=m)
    js = j_init_train_state(jm, jax.random.PRNGKey(0), jt)
    ts = train_state_from_numpy(jax.tree.map(np.asarray, js), tm.cfg, "cpu")
    return jm, tm, jt, tt, js, ts


@pytest.mark.parametrize("arch,m,opt", [
    ("internlm2-1.8b", 1, "adamw"), ("internlm2-1.8b", 2, "adamw"),
    ("granite-moe-1b-a400m", 2, "adamw"), ("zamba2-2.7b", 1, "adafactor")])
def test_train_steps_match_jax(arch, m, opt):
    """Three steps from one state: losses, grad norms and learning rates,
    then every leaf of the state (params and optimizer moments)."""
    jm, tm, jt, tt, js, ts = _step_pair(arch, m, opt)
    jstep = jax.jit(j_make_train_step(jm, jt))
    tstep = make_train_step(tm, tt)
    rng = np.random.default_rng(7)
    for _ in range(3):
        toks = rng.integers(0, tm.cfg.vocab, (4, 32)).astype(np.int32)
        tg = rng.integers(0, tm.cfg.vocab, (4, 32)).astype(np.int32)
        js, jmet = jstep(js, {"tokens": jnp.asarray(toks),
                              "targets": jnp.asarray(tg)})
        ts, tmet = tstep(ts, {"tokens": torch.from_numpy(toks),
                              "targets": torch.from_numpy(tg)})
        for k in ("loss", "grad_norm", "lr", "nll", "aux"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                       rtol=2e-5, atol=1e-7, err_msg=k)
    assert int(ts.step) == int(js.step) == 3
    diffs = []
    for (path, t), j in zip(tree_flatten(ts),
                            jax.tree.leaves(jax.tree.map(np.asarray, js))):
        t, j = t.float().numpy(), np.asarray(j, np.float32)
        d = np.abs(t - j)
        scale = max(float(np.abs(j).max()), 1e-30)
        diffs.append((float(d.max()) / scale, path))
        if d.size > 1:
            print(path, "max", d.max(), "p99.9", np.percentile(d, 99.9))
    worst = max(diffs)
    print(arch, m, opt, "worst rel leaf diff", worst)
    assert worst[0] <= STEP_TOL, worst


def _token_batch(cfg, b=8, l=32, seed=1):
    rng = np.random.default_rng(seed)
    return {"tokens": torch.from_numpy(
                rng.integers(0, cfg.vocab, (b, l)).astype(np.int32)),
            "targets": torch.from_numpy(
                rng.integers(0, cfg.vocab, (b, l)).astype(np.int32))}


def test_microbatched_step_matches_full_batch():
    model = build_model(get_config("internlm2-1.8b", smoke=True),
                        device="cpu")
    batch = _token_batch(model.cfg)
    out = {}
    for m in (1, 4):
        tcfg = TrainConfig(microbatches=m)
        state = init_train_state(model, torch.Generator().manual_seed(0),
                                 tcfg)
        state, _ = make_train_step(model, tcfg)(state, batch)
        out[m] = [x for _, x in tree_flatten(state.params)]
    for a, b in zip(out[1], out[4]):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   rtol=5e-2, atol=5e-4)


def test_bf16_accumulation_step():
    """``accum_dtype="bfloat16"`` accumulates in bf16 and still trains
    finite, the bf16 parameters updated in place."""
    cfg = dataclasses.replace(get_config("internlm2-1.8b", smoke=True),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    model = build_model(cfg, device="cpu")
    tcfg = TrainConfig(microbatches=2, accum_dtype="bfloat16")
    st = init_train_state(model, torch.Generator().manual_seed(0), tcfg)
    before = [x.clone() for _, x in tree_flatten(st.params)]
    ids = [id(x) for _, x in tree_flatten(st.params)]
    step = make_train_step(model, tcfg)
    for _ in range(2):
        st, met = step(st, _token_batch(cfg, b=4))
        assert all(bool(torch.isfinite(v)) for v in met.values())
    after = [x for _, x in tree_flatten(st.params)]
    assert [id(x) for x in after] == ids
    assert after[0].dtype == torch.bfloat16
    assert any(not torch.equal(a, b) for a, b in zip(before, after))


# --------------------------------------------------------------- trainer
def _trainer(tmp_path=None, steps_cfg=None):
    cfg = get_config("internlm2-1.8b", smoke=True)
    model = build_model(cfg, device="cpu")
    data = SyntheticTokens(vocab=cfg.vocab, seq=32, local_batch=4)
    tcfg = TrainerConfig(
        train=TrainConfig(
            optimizer=AdamWConfig(lr=5e-3),
            schedule=ScheduleConfig(peak_lr=5e-3, warmup_steps=5,
                                    total_steps=100)),
        ckpt_dir=str(tmp_path / "ckpt") if tmp_path else None,
        ckpt_every=5, log_every=100)
    return Trainer(model, tcfg, data), data


def test_loss_decreases():
    trainer, _ = _trainer()
    trainer.run(60)
    first = np.mean([m["loss"] for m in trainer.metrics_log[:4]])
    last = np.mean([m["loss"] for m in trainer.metrics_log[-8:]])
    assert last < first - 0.15, (first, last)
    assert all(m["step_time_s"] > 0 for m in trainer.metrics_log)


def test_straggler_watchdog():
    t = Trainer.__new__(Trainer)
    t.cfg = TrainerConfig(straggler_z=3.0)
    t.straggler_events = []
    t._step_time_ema = None
    t._step_time_var = 0.0
    for i in range(20):
        t._watchdog(i, 0.1 + 0.001 * (i % 3))
    t._watchdog(20, 5.0)  # a 50x step: must be flagged
    assert len(t.straggler_events) == 1
    assert t.straggler_events[0]["step"] == 20


def test_launcher_trains_on_the_cpu(tmp_path, capsys):
    """``--mesh`` starts a one-process gloo world (torn down here)."""
    from repro_torch.launch.train import main

    try:
        trainer = main(["--smoke", "--device", "cpu", "--steps", "6",
                        "--seq", "32", "--batch", "4", "--microbatches", "2",
                        "--optimizer", "adafactor", "--ckpt-dir",
                        str(tmp_path / "ck"), "--ckpt-every", "2",
                        "--elastic-demo", "--mesh", "1x1:data,model"])
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    out = capsys.readouterr().out
    assert "[elastic] step 3" in out and "train summary" in out
    assert int(trainer.state.step) == 6
    assert [m["step"] for m in trainer.metrics_log] == list(range(6))
    assert all(np.isfinite(m["loss"]) for m in trainer.metrics_log)
    from repro_torch.train.checkpoint import latest_step

    assert latest_step(str(tmp_path / "ck")) == 6
