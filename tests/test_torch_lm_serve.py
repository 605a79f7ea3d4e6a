"""repro_torch's falcon-mamba-7b serving path against the JAX package, on
the CPU, at the smoke config (2 layers, d_model 128, vocab 512, f32).

The same parameters (JAX ``model.init``, carried across as numpy) and
the same numpy-made tokens go through both packages: ``forward`` hidden
states, ``prefill`` logits and decode state (whose ``ssm_h`` and
``ssm_conv`` stay zero in both: the reference drops the scan's final
state), and 8 teacher-forced ``decode_step`` logits, on the chunked
branch and on the kernel branch (the plain version here).  The port's
``ContinuousBatcher`` is held to its own sequential greedy loop and to
the JAX batcher's tokens; the launcher and the registry are checked (the
other families: ``test_torch_lm_*.py``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import arch_names as j_arch_names
from repro.configs import get_config as j_get_config
from repro.models.model import build_model as j_build_model
from repro.serve.scheduler import ContinuousBatcher as JBatcher
from repro.serve.scheduler import Request as JRequest
from repro.serve.scheduler import ServeConfig as JServeConfig

from repro_torch.configs import arch_names, get_config
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
    """Both launcher modes run on the CPU when asked: ``--mode lm``
    serves its requests, and ``--mode index`` replays its open-loop
    point trace through the SLO front end and prints its goodput and
    on-time latency lines; without a card and without ``--device``, the
    index mode raises."""
    launch_serve.main(["--mode", "lm", "--device", "cpu", "--arch", ARCH,
                       "--requests", "3", "--max-new", "4", "--slots", "2"])
    out = capsys.readouterr().out
    assert "served 3 requests / 12 tokens" in out and "on cpu" in out
    launch_serve.main(["--mode", "index", "--device", "cpu", "--requests",
                       "200"])
    out = capsys.readouterr().out
    assert "replayed 200 requests" in out and "on cpu" in out
    assert "goodput " in out and "/200 (" in out
    assert "on-time latency p50=" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            launch_serve.main(["--mode", "index", "--requests", "10"])


@pytest.mark.parametrize("arch", j_arch_names())
def test_ported_configs_equal_the_jax_configs(arch):
    for smoke in (False, True):
        assert dataclasses.asdict(get_config(arch, smoke)) == \
            dataclasses.asdict(j_get_config(arch, smoke))


def test_registry_and_unported_families_raise():
    """Every architecture of the JAX registry is registered, in its
    order, and builds on the CPU; an unknown one raises ``KeyError``;
    ``train_loss`` runs (a finite f32 scalar loss and its metrics)."""
    assert arch_names() == j_arch_names()
    for arch in j_arch_names():
        assert build_model(get_config(arch, smoke=True),
                           device="cpu").cfg.name == arch
    with pytest.raises(KeyError):
        get_config("no-such-arch")
    model = build_model(get_config(ARCH, smoke=True), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, model.cfg.vocab, (2, 16),
                         generator=torch.Generator().manual_seed(1))
    loss, metrics = model.train_loss(params, {"tokens": toks,
                                              "targets": toks})
    assert loss.shape == () and loss.dtype == torch.float32
    assert bool(torch.isfinite(loss)) and set(metrics) == {"nll", "aux"}


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


@pytest.mark.parametrize("arch", j_arch_names())
def test_every_arch_inits_and_serves_on_cpu(arch):
    """``init`` gives the JAX tree's leaves, shapes and dtypes (from
    ``jax.eval_shape``: nothing drawn on the JAX side); a prefill and two
    decode steps on the port's own weights give finite logits; without a
    card and without ``device``, ``build_model`` raises."""
    cfg = get_config(arch, smoke=True)
    want = jax.eval_shape(j_build_model(j_get_config(arch, smoke=True)).init,
                          jax.random.PRNGKey(0))
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(1))
    flat = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    for path, sds in flat.items():
        leaf = params
        for p in path:
            leaf = leaf[p.key]
        assert tuple(leaf.shape) == sds.shape, (arch, path)
        assert str(leaf.dtype).split(".")[-1] == sds.dtype.name, (arch, path)
    n = sum(1 for _ in _leaves(params))
    assert n == len(flat), (arch, n, len(flat))
    extra = None
    if cfg.family in ("vlm", "encdec"):
        name, rows = (("patches", cfg.n_patches) if cfg.family == "vlm"
                      else ("frames", cfg.enc_seq))
        extra = {name: torch.randn(2, rows, cfg.d_model)}
    state, logits = model.prefill(params, torch.ones((2, 5), dtype=torch.long),
                                  16, extra=extra)
    for _ in range(2):
        logits, state = model.decode_step(
            params, state, torch.argmax(logits, -1)[:, None], extra=extra)
        assert logits.shape == (2, cfg.vocab)
        assert bool(torch.isfinite(logits).all())
    assert state["cache_len"].tolist() == [7, 7]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_model(cfg)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
