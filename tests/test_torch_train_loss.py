"""The port's training loss and its gradients against the JAX package's.

Every architecture's smoke config (2 layers, d_model 128, vocab 512, f32)
starts from the JAX ``model.init`` parameters carried across with
``model_params_from_numpy`` (``_torch_lm.pair``); the same numpy-made
tokens, targets and stub patches or frames go through
``jax.value_and_grad(model.train_loss)`` and the port's ``train_loss``
under ``torch.autograd.grad``.  Held per gradient leaf: max |dg| over
max |g| <= ``GRAD_TOL`` (the two libraries sum and contract in other
orders in f32); the loss to ``LOSS_TOL``.  Also: the chunked
cross-entropy's mask, soft cap and logit scale; remat modes give the
same bits; every core weight receives gradient (``test_models_smoke``'s
``test_grads_flow_everywhere``); ``use_scan_kernel`` under autograd
raises."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import extras, pair
from repro.configs import arch_names as j_arch_names
from repro.models.layers import chunked_cross_entropy as j_xent

from repro_torch.configs import arch_names, get_config
from repro_torch.models.layers import chunked_cross_entropy
from repro_torch.models.model import build_model
from repro_torch.train.checkpoint import tree_flatten
from repro_torch.train.train_step import loss_and_grads

torch.set_num_threads(1)

GRAD_TOL = 1e-4   # max |dg| / max |g| per leaf, f32
LOSS_TOL = 2e-6   # relative, f32
B, L = 2, 128     # 2 loss chunks of 64; 8 Mamba chunks of 16


def _batches(cfg, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, L)).astype(np.int32)
    tg = rng.integers(0, cfg.vocab, (B, L)).astype(np.int32)
    jx, tx = extras(cfg, B, seed + 1)
    jb = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tg),
          **(jx or {})}
    tb = {"tokens": torch.from_numpy(toks), "targets": torch.from_numpy(tg),
          **(tx or {})}
    return jb, tb


@pytest.mark.parametrize("arch", j_arch_names())
def test_train_loss_and_grads_match_jax(arch):
    jm, jp, tm, tp = pair(arch)
    jb, tb = _batches(tm.cfg, 11)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.train_loss,
                                                has_aux=True))(jp, jb)
    tl, tmet, tg = loss_and_grads(tm, tp, tb)
    assert tl.dtype == torch.float32 and tl.shape == ()
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_TOL)
    np.testing.assert_allclose(float(tmet["aux"].detach()),
                               float(jmet["aux"]), rtol=1e-5, atol=1e-7)
    paths = [p for p, _ in tree_flatten(tp)]
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(tg) == len(paths)
    worst = {}
    for path, g, want in zip(paths, tg, jleaves):
        want = np.asarray(want, np.float32)
        got = g.numpy()
        assert got.shape == want.shape, path
        scale = float(np.abs(want).max())
        err = float(np.abs(got - want).max())
        worst[path] = err / scale if scale > 0 else err
    bad = {p: e for p, e in worst.items() if e > GRAD_TOL}
    print(arch, "max rel grad err", max(worst.values()))
    assert not bad, f"{arch}: {bad}"


@pytest.mark.parametrize("mask,cap,scale", [
    (False, None, 1.0), (True, None, 1.0), (True, 30.0, 128 ** -0.5),
    (False, 5.0, 1.0)])
def test_chunked_cross_entropy_matches_jax(mask, cap, scale):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 96, 32)).astype(np.float32)
    un = rng.standard_normal((80, 32)).astype(np.float32)
    tg = rng.integers(0, 80, (2, 96)).astype(np.int32)
    mk = (rng.random((2, 96)) < 0.6) if mask else None
    jm = None if mk is None else jnp.asarray(mk)
    tmk = None if mk is None else torch.from_numpy(mk)
    jfn = lambda x_, u_: j_xent(x_, u_, jnp.asarray(tg), 32,
                                logit_softcap=cap, mask=jm,
                                logit_scale=scale)
    jl, (jgx, jgu) = jax.value_and_grad(jfn, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(un))
    tx = torch.from_numpy(x).requires_grad_(True)
    tu = torch.from_numpy(un).requires_grad_(True)
    tl = chunked_cross_entropy(tx, tu, torch.from_numpy(tg), 32,
                               logit_softcap=cap, mask=tmk,
                               logit_scale=scale)
    gx, gu = torch.autograd.grad(tl, (tx, tu))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=LOSS_TOL)
    for got, want in ((gx, jgx), (gu, jgu)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= GRAD_TOL * np.abs(
            want).max()


def test_chunked_cross_entropy_needs_even_chunks():
    x = torch.zeros(1, 100, 8)
    with pytest.raises(ValueError, match="chunks"):
        chunked_cross_entropy(x, torch.zeros(16, 8),
                              torch.zeros(1, 100, dtype=torch.long), 32)


def _loss_grads(arch, remat, seed=5, **ssm):
    cfg = get_config(arch, smoke=True)
    if ssm:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                               **ssm))
    cfg = dataclasses.replace(cfg, remat=remat)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    _, tb = _batches(cfg, seed)
    return loss_and_grads(model, params, tb)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "granite-moe-1b-a400m",
                                  "zamba2-2.7b", "whisper-medium",
                                  "llama-3.2-vision-11b", "falcon-mamba-7b"])
def test_remat_modes_give_the_same_bits(arch):
    """``full`` and ``dots`` recompute the same operations: loss and every
    gradient leaf bit-equal to ``none``."""
    l0, _, g0 = _loss_grads(arch, "none")
    for mode in ("full", "dots"):
        l1, _, g1 = _loss_grads(arch, mode)
        assert torch.equal(l0, l1), mode
        assert all(torch.equal(a, b) for a, b in zip(g0, g1)), mode


def test_remat_leaves_serving_unchanged(monkeypatch):
    """With grad mode on but weights that require no grad (serving), remat
    never enters ``torch.utils.checkpoint``, for the layers and for the
    Mamba2 chunks alike, and the forward is bit-equal across modes; the
    training forward does enter it."""
    from torch.utils import checkpoint as ckpt_mod

    from repro_torch.models import transformer as tfm

    real, entered = ckpt_mod.checkpoint, []

    def spy(*args, **kwargs):
        entered.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(ckpt_mod, "checkpoint", spy)
    assert torch.is_grad_enabled()
    for arch in ("qwen3-14b", "zamba2-2.7b"):
        outs = []
        for mode in ("none", "full", "dots"):
            cfg = dataclasses.replace(get_config(arch, smoke=True),
                                      remat=mode)
            params = build_model(cfg, device="cpu").init(
                torch.Generator().manual_seed(0))
            toks = torch.arange(64).reshape(2, 32) % cfg.vocab
            outs.append(tfm.forward(params, toks, cfg)[0])
        assert not entered, arch
        assert all(torch.equal(outs[0], o) for o in outs[1:]), arch
    _loss_grads("zamba2-2.7b", "full")
    assert entered


def test_unknown_remat_mode_raises():
    with pytest.raises(ValueError, match="remat"):
        _loss_grads("internlm2-1.8b", "some")


@pytest.mark.parametrize("arch", arch_names())
def test_grads_flow_everywhere(arch):
    """Every core weight receives a nonzero gradient (dt_bias and conv
    biases can be dead at smoke scale; vlm cross layers wake only once
    their zero-initialized tanh gate moves), as the JAX test holds."""
    model = build_model(get_config(arch, smoke=True), device="cpu")
    params = model.init(torch.Generator().manual_seed(1))
    _, tb = _batches(model.cfg, 2)
    tb = {k: (v[:, :16] if k in ("tokens", "targets") else v)
          for k, v in tb.items()}
    _, _, grads = loss_and_grads(model, params, tb)
    dead = [p for (p, _), g in zip(tree_flatten(params), grads)
            if float(g.abs().max()) == 0.0
            and any(w in p for w in ("wq", "wk", "wv", "wo", "w_up",
                                     "w_down", "embed", "w_in", "w_out"))
            and "cross_layers" not in p]
    assert not dead, f"{arch}: dead core weights {dead}"


def test_scan_kernel_has_no_backward():
    """``use_scan_kernel=True`` under autograd raises naming the missing
    backward kernel (the JAX Pallas kernel cannot be differentiated
    either); the forward without autograd still runs through
    ``ops.mamba_scan``'s plain version on the CPU."""
    with pytest.raises(NotImplementedError, match="no backward kernel"):
        _loss_grads("falcon-mamba-7b", "none", use_scan_kernel=True)
    with pytest.raises(NotImplementedError, match="no backward kernel"):
        _loss_grads("falcon-mamba-7b", "full", use_scan_kernel=True)
    cfg = get_config("falcon-mamba-7b", smoke=True)
    cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
        cfg.ssm, use_scan_kernel=True))
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    _, tb = _batches(cfg, 4)
    with torch.no_grad():
        loss, _ = model.train_loss(params, tb)
    assert bool(torch.isfinite(loss))
