"""repro_torch's falcon-mamba-7b serving path against the JAX package, on
the CPU, at the smoke config (2 layers, d_model 128, vocab 512, f32).

The same parameters (JAX ``model.init``, carried across as numpy) and
the same numpy-made tokens go through both packages: ``forward`` hidden
states, ``prefill`` logits and decode state (whose ``ssm_h`` and
``ssm_conv`` stay zero in both: the reference drops the scan's final
state), and 8 teacher-forced ``decode_step`` logits, on the chunked
branch and on the kernel branch (the plain version here).  The port's
``ContinuousBatcher`` is held to its own sequential greedy loop and to
the JAX batcher's tokens; the launcher and the registry are checked."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models.model import build_model as j_build_model
from repro.serve.scheduler import ContinuousBatcher as JBatcher
from repro.serve.scheduler import Request as JRequest
from repro.serve.scheduler import ServeConfig as JServeConfig

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.models.model import build_model
from repro_torch.serve.scheduler import (ContinuousBatcher, Request,
                                         ServeConfig)
from repro_torch.weights import model_params_from_numpy

torch.set_num_threads(1)

ARCH = "falcon-mamba-7b"
# f32 at smoke width: matmuls, norms and the scan's sums round in another
# order in the two libraries; observed differences are ~1e-6 on logits of
# magnitude ~4
TOL = 2e-5


def _kernel_cfg(cfg, on):
    return dataclasses.replace(
        cfg, ssm=dataclasses.replace(cfg.ssm, use_scan_kernel=on))


@pytest.fixture(scope="module")
def params():
    jparams = j_build_model(j_get_config(ARCH, smoke=True)).init(
        jax.random.PRNGKey(0))
    tp = model_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                 get_config(ARCH, smoke=True), "cpu")
    return jparams, tp


@pytest.mark.parametrize("kernel", [False, True])
def test_forward_prefill_decode_match_jax(params, kernel):
    from repro.models import transformer as j_tfm
    from repro_torch.models import transformer as t_tfm

    jp, tp = params
    jcfg = _kernel_cfg(j_get_config(ARCH, smoke=True), kernel)
    cfg = _kernel_cfg(get_config(ARCH, smoke=True), kernel)
    jm, tm = j_build_model(jcfg), build_model(cfg, device="cpu")
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (2, 48)
                                             ).astype(np.int32)
    ttoks = torch.from_numpy(toks).long()
    xj, _ = j_tfm.forward(jp, jnp.asarray(toks), jcfg)
    xt, _ = t_tfm.forward(tp, ttoks, cfg)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=TOL, atol=TOL)

    ops.reset_launch_counts()
    sj, lj = jm.prefill(jp, jnp.asarray(toks), 64)
    st, lt = tm.prefill(tp, ttoks, 64)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=TOL, atol=TOL)
    assert set(st) == set(sj)
    for k in sj:
        assert tuple(st[k].shape) == np.asarray(sj[k]).shape, k
    assert np.array_equal(st["cache_len"].numpy(), np.asarray(sj["cache_len"]))
    for k in ("ssm_h", "ssm_conv"):     # the reference's zero state, kept
        assert not np.asarray(sj[k]).any() and not st[k].any(), k
    tok = np.argmax(np.asarray(lj), -1)[:, None].astype(np.int32)
    for _ in range(8):                  # teacher-forced: JAX's tokens
        lj, sj = jm.decode_step(jp, sj, jnp.asarray(tok))
        lt, st = tm.decode_step(tp, st, torch.from_numpy(tok).long())
        assert lt.dtype == torch.float32
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=TOL,
                                   atol=TOL)
        for k in ("ssm_h", "ssm_conv", "cache_len"):
            np.testing.assert_allclose(st[k].numpy(), np.asarray(sj[k]),
                                       rtol=TOL, atol=TOL)
        tok = np.argmax(np.asarray(lj), -1)[:, None].astype(np.int32)
    assert ops.launch_counts()["mamba_scan"] == 0     # CPU: plain version


def test_kernel_flag_in_model_matches_chunked(params):
    """SSMConfig.use_scan_kernel routes every layer through the scan;
    the full model's prefill logits stay within the JAX test's 2e-3 of
    the chunked path (``test_mamba_kernel_flag_in_model``)."""
    _jp, tp = params
    cfg = get_config(ARCH, smoke=True)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 64))).long()
    _, l_ref = build_model(cfg, "cpu").prefill(tp, toks, 64)
    _, l_ker = build_model(_kernel_cfg(cfg, True), "cpu").prefill(tp, toks,
                                                                  64)
    np.testing.assert_allclose(l_ker.numpy(), l_ref.numpy(), rtol=2e-3,
                               atol=2e-3)


PROMPTS = [np.array([5, 6, 7], np.int32), np.array([9, 2], np.int32),
           np.array([11, 3, 1, 8], np.int32)]
MAX_NEW = 6


def test_batcher_matches_sequential_and_jax_batcher(params):
    """As ``tests/test_serve.py`` does for internlm2: the port's batcher
    (2 slots, 3 requests, so a slot is reused) gives its own sequential
    greedy tokens, and the JAX batcher's tokens on the same parameters
    and prompts."""
    jp, tp = params
    cfg = get_config(ARCH, smoke=True)
    model = build_model(cfg, device="cpu")

    def generate(prompt):
        state, logits = model.prefill(
            tp, torch.from_numpy(prompt[None]).long(), 64)
        toks = [int(torch.argmax(logits[0]))]
        for _ in range(MAX_NEW - 1):
            logits, state = model.decode_step(
                tp, state, torch.tensor([[toks[-1]]]))
            toks.append(int(torch.argmax(logits[0])))
        return toks

    expected = [generate(p) for p in PROMPTS]
    batcher = ContinuousBatcher(model, tp, ServeConfig(batch_slots=2,
                                                       max_len=64))
    reqs = [Request(rid=i, prompt=p, max_new_tokens=MAX_NEW)
            for i, p in enumerate(PROMPTS)]
    for r in reqs:
        batcher.submit(r)
    status = batcher.run_until_drained()
    assert status.drained and status.unfinished == []
    jb = JBatcher(j_build_model(j_get_config(ARCH, smoke=True)), jp,
                  JServeConfig(batch_slots=2, max_len=64))
    jreqs = [JRequest(rid=i, prompt=p, max_new_tokens=MAX_NEW)
             for i, p in enumerate(PROMPTS)]
    for r in jreqs:
        jb.submit(r)
    jb.run_until_drained()
    assert batcher.steps == jb.steps
    for r, jr, exp in zip(reqs, jreqs, expected):
        assert r.done and r.t_first is not None
        assert r.output == exp, (r.rid, r.output, exp)
        assert r.output == jr.output, (r.rid, r.output, jr.output)


def test_batcher_truncation_is_loud(params):
    _jp, tp = params
    model = build_model(get_config(ARCH, smoke=True), device="cpu")
    b = ContinuousBatcher(model, tp, ServeConfig(batch_slots=2, max_len=64))
    for i, p in enumerate(PROMPTS):
        b.submit(Request(rid=i, prompt=p, max_new_tokens=50))
    with pytest.raises(RuntimeError, match="truncated"):
        b.run_until_drained(max_steps=3)
    b = ContinuousBatcher(model, tp, ServeConfig(batch_slots=2, max_len=64))
    reqs = [Request(rid=i, prompt=p, max_new_tokens=50)
            for i, p in enumerate(PROMPTS)]
    for r in reqs:
        b.submit(r)
    status = b.run_until_drained(max_steps=3, strict=False)
    assert not status.drained and status.steps == 3
    assert sorted(status.unfinished) == [0, 1, 2]
    assert all(r.truncated for r in reqs)


def test_serve_launcher_runs_on_cpu(capsys):
    launch_serve.main(["--mode", "lm", "--device", "cpu", "--requests", "3",
                       "--max-new", "4", "--slots", "2"])
    out = capsys.readouterr().out
    assert "served 3 requests / 12 tokens" in out and "on cpu" in out
    with pytest.raises(NotImplementedError, match="A12"):
        launch_serve.main(["--mode", "index", "--device", "cpu"])


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "qwen3-14b"])
def test_ported_configs_equal_the_jax_configs(arch):
    for smoke in (False, True):
        assert dataclasses.asdict(get_config(arch, smoke)) == \
            dataclasses.asdict(j_get_config(arch, smoke))


def test_registry_and_unported_families_raise():
    with pytest.raises(NotImplementedError, match="A15b"):
        get_config("internlm2-1.8b")
    with pytest.raises(NotImplementedError, match="A15b"):
        get_config("zamba2-2.7b", smoke=True)
    with pytest.raises(KeyError):
        get_config("no-such-arch")
    with pytest.raises(NotImplementedError, match="A15b"):
        build_model(get_config("qwen3-14b", smoke=True), device="cpu")
    model = build_model(get_config(ARCH, smoke=True), device="cpu")
    with pytest.raises(NotImplementedError, match="training"):
        model.train_loss({}, {})


def test_model_needs_a_card_unless_cpu_is_asked():
    """Entry points run on the card by default: without one,
    ``build_model`` raises rather than falling back to the CPU, and
    ``init`` takes a generator on the model's device only."""
    cfg = get_config(ARCH, smoke=True)
    if torch.cuda.is_available():
        model = build_model(cfg)
        assert model.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_model(cfg)
    model = build_model(cfg, device="cpu")
    assert model.device.type == "cpu"
    params = model.init(torch.Generator().manual_seed(0))
    assert params["embed"].device.type == "cpu"
    assert params["layers"]["ssm"]["w_in"].shape == (
        cfg.n_layers, cfg.d_model, 2 * cfg.ssm.expand * cfg.d_model)
