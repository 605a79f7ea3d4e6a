"""Shared harness of the LM family parity tests (``test_torch_lm_*.py``).

The JAX ``model.init`` parameters of an architecture's smoke config
(2 layers, d_model 128, vocab 512, f32) cross to the port as numpy
through ``model_params_from_numpy``; numpy-made tokens (and, for vlm and
encdec, patches or frames) go through both packages: ``forward`` hidden
states (encdec: the encoder output and the decoder's hidden states) and
the aux loss, ``prefill`` logits and every decode-state leaf, then 8
teacher-forced ``decode_step`` logits (the JAX step's argmax fed to
both) and every state leaf after them."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as j_get_config
from repro.models.model import build_model as j_build_model
from repro.serve.scheduler import ContinuousBatcher as JBatcher
from repro.serve.scheduler import Request as JRequest
from repro.serve.scheduler import ServeConfig as JServeConfig

from repro_torch.configs import get_config
from repro_torch.models.model import build_model
from repro_torch.serve.scheduler import (ContinuousBatcher, Request,
                                         ServeConfig)
from repro_torch.weights import model_params_from_numpy

torch.set_num_threads(1)

# f32 at smoke width: matmuls, norms, softmaxes and scans round in another
# order in the two libraries; observed differences are ~3e-6 on logits of
# magnitude ~3-10 (the falcon-mamba-7b tests' bound, test_torch_lm_serve)
TOL = 2e-5
PROMPT_LEN, MAX_LEN, STEPS = 24, 40, 8


@functools.lru_cache(maxsize=None)
def pair(arch):
    """(JAX model, JAX params, port model, port params) at smoke size."""
    jm = j_build_model(j_get_config(arch, smoke=True))
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = get_config(arch, smoke=True)
    tp = model_params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jm, jp, build_model(cfg, device="cpu"), tp


def extras(cfg, b, seed):
    """(JAX extra, port extra) of numpy-made patches or frames, or Nones."""
    rng = np.random.default_rng(seed)
    names = {"vlm": ("patches", cfg.n_patches),
             "encdec": ("frames", cfg.enc_seq)}
    if cfg.family not in names:
        return None, None
    name, n = names[cfg.family]
    x = (rng.standard_normal((b, n, cfg.d_model)) * 0.5).astype(np.float32)
    return {name: jnp.asarray(x)}, {name: torch.from_numpy(x)}


def close(got, want, what):
    got = got.detach().to(torch.float32).numpy() if isinstance(
        got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want).astype(np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=what)


def states_close(st, sj, what):
    assert set(st) == set(sj), (what, sorted(st), sorted(sj))
    for k in sj:
        if k == "cache_len":
            assert np.array_equal(st[k].numpy(), np.asarray(sj[k])), what
        else:
            close(st[k], sj[k], f"{what}: {k}")


def hidden_states(arch, toks, jx, tx):
    """{name: (port, JAX)} of the forward pass's outputs."""
    from repro.models import encdec as j_ed, transformer as j_tfm
    from repro_torch.models import encdec as t_ed, transformer as t_tfm

    jm, jp, tm, tp = pair(arch)
    jcfg, cfg = jm.cfg, tm.cfg
    jt, tt = jnp.asarray(toks), torch.from_numpy(toks).long()
    if cfg.family == "encdec":
        ej = j_ed.encode(jp, jx["frames"], jcfg)
        et = t_ed.encode(tp, tx["frames"], cfg)
        return {"encoder": (et, ej),
                "decoder": (t_ed._decode_forward(tp, tt, et, cfg),
                            j_ed._decode_forward(jp, jt, ej, jcfg))}
    xj, aj = j_tfm.forward(jp, jt, jcfg, extra=jx)
    xt, at = t_tfm.forward(tp, tt, cfg, extra=tx)
    return {"hidden": (xt, xj), "aux": (at, aj)}


def check_family(arch, seed=7):
    """Forward, prefill and 8 teacher-forced decode steps, port vs JAX."""
    jm, jp, tm, tp = pair(arch)
    cfg = tm.cfg
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab, (2, PROMPT_LEN)).astype(np.int32)
    jx, tx = extras(cfg, 2, seed + 1)
    for name, (got, want) in hidden_states(arch, toks, jx, tx).items():
        close(got, want, f"{arch} forward {name}")
    sj, lj = jm.prefill(jp, jnp.asarray(toks), MAX_LEN, extra=jx)
    st, lt = tm.prefill(tp, torch.from_numpy(toks).long(), MAX_LEN,
                        extra=tx)
    close(lt, lj, f"{arch} prefill logits")
    states_close(st, sj, f"{arch} prefill state")
    step = jax.jit(lambda p, s, t: jm.decode_step(p, s, t, extra=jx))
    tok = np.argmax(np.asarray(lj), -1)[:, None].astype(np.int32)
    for i in range(STEPS):
        lj, sj = step(jp, sj, jnp.asarray(tok))
        lt, st = tm.decode_step(tp, st, torch.from_numpy(tok).long(),
                                extra=tx)
        assert lt.dtype == torch.float32
        close(lt, lj, f"{arch} decode step {i} logits")
        tok = np.argmax(np.asarray(lj), -1)[:, None].astype(np.int32)
    states_close(st, sj, f"{arch} state after {STEPS} steps")


PROMPTS = [np.array([5, 6, 7], np.int32), np.array([9, 2], np.int32),
           np.array([11, 3, 1, 8], np.int32)]
MAX_NEW = 6


def check_batcher(arch):
    """As ``tests/test_serve.py`` does: the port's batcher (2 slots, 3
    requests, so a slot is reused) gives the JAX batcher's tokens on the
    same parameters and prompts, in as many decode steps."""
    jm, jp, tm, tp = pair(arch)
    batcher = ContinuousBatcher(tm, tp, ServeConfig(batch_slots=2,
                                                    max_len=64))
    reqs = [Request(rid=i, prompt=p, max_new_tokens=MAX_NEW)
            for i, p in enumerate(PROMPTS)]
    for r in reqs:
        batcher.submit(r)
    assert batcher.run_until_drained().drained
    jb = JBatcher(jm, jp, JServeConfig(batch_slots=2, max_len=64))
    jreqs = [JRequest(rid=i, prompt=p, max_new_tokens=MAX_NEW)
             for i, p in enumerate(PROMPTS)]
    for r in jreqs:
        jb.submit(r)
    jb.run_until_drained()
    assert batcher.steps == jb.steps
    for r, jr in zip(reqs, jreqs):
        assert r.done and len(r.output) == MAX_NEW
        assert r.output == jr.output, (arch, r.rid, r.output, jr.output)
