"""repro_torch's Mamba1 and Mamba2 pieces against the JAX package, on the
CPU.

The selective scan's plain version is held to ``mamba_scan_pallas``
(interpret mode) and ``mamba_scan_ref``; the port's ``mamba_block``, on
both branches (the kernel's plain version and the chunked path), to the
JAX ``mamba_block``; the port's init to the JAX tree; Mamba2's block,
decode step and init (zamba2's smoke config) to the JAX ones.  Inputs are made
with numpy from a seed; JAX parameters cross as numpy through
``model_params_from_numpy``.  Everything here is f32: bf16 rounds at
different places in XLA and PyTorch, so bf16 is compared on the card,
port against port (chip_smoke.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.kernels.mamba_scan import mamba_scan_pallas
from repro.kernels.ref import mamba_scan_ref
from repro.models import ssm as j_ssm
from repro.models.layers import Initializer as JInitializer
from repro.models.model import build_model as j_build_model

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels.mamba_scan import (KERNELS, MAX_STATE, SMEM_BUDGET,
                                            mamba_scan, mamba_scan_plain,
                                            scan_plan)
from repro_torch.models import ssm
from repro_torch.models.layers import Initializer
from repro_torch.models.model import build_model
from repro_torch.weights import model_params_from_numpy

torch.set_num_threads(1)

# plain scan vs Pallas / ref: the JAX test's bound (the recurrence runs in
# f32; the N-term sums and XLA's exp round apart from torch's)
SCAN_TOL = 1e-4
# same branch, port vs JAX: f32 matmuls and sums in another order
BLOCK_TOL = 2e-5
# kernel branch vs chunked branch: the JAX test's bound (the chunked path
# multiplies the decays in another order)
BRANCH_TOL = 2e-3


def _scan_inputs(b, l, di, n, seed):
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, di)))).astype(np.float32)
    xi = rng.standard_normal((b, l, di)).astype(np.float32)
    b_in = rng.standard_normal((b, l, n)).astype(np.float32)
    c_out = rng.standard_normal((b, l, n)).astype(np.float32)
    a_log = (rng.standard_normal((di, n)) * 0.5).astype(np.float32)
    return dt, xi, b_in, c_out, a_log


@pytest.mark.parametrize("b,l,di,n,chunk,dblk", [
    (2, 64, 32, 8, 16, 16),
    (1, 300, 64, 16, 128, 64),     # ragged L (the Pallas padding path)
    (3, 128, 128, 16, 32, 128),
    (2, 96, 48, 8, 32, 24),
])
def test_mamba_scan_plain_matches_pallas_and_ref(b, l, di, n, chunk, dblk):
    args = _scan_inputs(b, l, di, n, b * 1000 + l)
    y_k = np.asarray(mamba_scan_pallas(*map(jnp.asarray, args), chunk=chunk,
                                       dblock=dblk, interpret=True))
    y_r = np.asarray(mamba_scan_ref(*map(jnp.asarray, args)))
    y_p = mamba_scan_plain(*map(torch.from_numpy, args)).numpy()
    assert y_p.shape == (b, l, di) and y_p.dtype == np.float32
    np.testing.assert_allclose(y_p, y_k, rtol=SCAN_TOL, atol=SCAN_TOL)
    np.testing.assert_allclose(y_p, y_r, rtol=SCAN_TOL, atol=SCAN_TOL)


def test_mamba_scan_runs_plain_on_cpu_tensors():
    """The wrapper takes the plain version for CPU tensors, bit for bit,
    and counts no launch (only CUDA launches count)."""
    args = [torch.from_numpy(a) for a in _scan_inputs(2, 40, 24, 8, 3)]
    ops.reset_launch_counts()
    y = ops.mamba_scan(*args)
    assert torch.equal(y, mamba_scan_plain(*args))
    assert torch.equal(y, mamba_scan(*args))
    assert ops.launch_counts()["mamba_scan"] == 0


def test_scan_plan_has_a_kernel_for_every_state_width():
    """Every N up to MAX_STATE gets a (lanes, states per lane) pair the
    kernel is built for, enough states, chunks of whole 16-byte rows and
    shared memory within the budget; falcon-mamba-7b's N 16 takes 8 lanes
    of 2 states."""
    for n in range(1, MAX_STATE + 1):
        plan = scan_plan(1, 2048, 8192, n)
        assert (plan.lanes, plan.npl) in KERNELS
        assert plan.lanes * plan.npl >= n and plan.chunk % 4 == 0
        assert plan.smem_bytes <= SMEM_BUDGET
        assert plan.blocks == 8192 // plan.channel_tile
    assert scan_plan(1, 2048, 8192, 16)[:3] == (8, 2, 32)


def _layer(d_model, s, seed):
    init = JInitializer(jax.random.PRNGKey(seed), jnp.float32)
    jp = j_ssm.init_mamba(init, d_model, s)
    cfg = get_config("falcon-mamba-7b", smoke=True)
    tp = model_params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jp, tp


@pytest.mark.parametrize("l", [64, 40, 7])
def test_mamba_block_both_branches_match_jax(l):
    """At reduce_for_smoke width (d_model 128, state 16, chunk 16): the
    port's kernel branch and chunked branch each equal the same JAX
    branch within BLOCK_TOL, and each other within BRANCH_TOL."""
    cfg = get_config("falcon-mamba-7b", smoke=True)
    d = cfg.d_model
    s_chunk = cfg.ssm
    s_kernel = dataclasses.replace(s_chunk, use_scan_kernel=True)
    jp, tp = _layer(d, s_chunk, 0)
    x = (np.random.default_rng(l).standard_normal((2, l, d)) * 0.3
         ).astype(np.float32)
    out = {}
    for name, s in (("chunked", s_chunk), ("kernel", s_kernel)):
        want = np.asarray(j_ssm.mamba_block(jnp.asarray(x), jp, d, s,
                                            remat_chunks=False))
        got = ssm.mamba_block(torch.from_numpy(x), tp, d, s).numpy()
        np.testing.assert_allclose(got, want, rtol=BLOCK_TOL,
                                   atol=BLOCK_TOL, err_msg=name)
        out[name] = got
    np.testing.assert_allclose(out["kernel"], out["chunked"],
                               rtol=BRANCH_TOL, atol=BRANCH_TOL)


def test_chunked_path_needs_even_chunks_as_in_jax():
    """L = 41 is not max(41 // 16, 1) = 2 chunks of 20: the JAX chunked
    path fails to reshape, and the port raises."""
    cfg = get_config("falcon-mamba-7b", smoke=True)
    d = cfg.d_model
    jp, tp = _layer(d, cfg.ssm, 1)
    x = np.zeros((1, 41, d), np.float32)
    with pytest.raises(Exception):
        j_ssm.mamba_block(jnp.asarray(x), jp, d, cfg.ssm)
    with pytest.raises(ValueError, match="chunks"):
        ssm.mamba_block(torch.from_numpy(x), tp, d, cfg.ssm)


def test_decode_step_recurrence_matches_jax():
    """Four steps of ``mamba_decode_step`` from a nonzero state: the
    outputs and the new h and conv equal the JAX step's."""
    cfg = get_config("falcon-mamba-7b", smoke=True)
    d, s = cfg.d_model, cfg.ssm
    jp, tp = _layer(d, s, 2)
    rng = np.random.default_rng(4)
    di = s.expand * d
    h = (rng.standard_normal((3, di, s.state_dim)) * 0.1).astype(np.float32)
    conv = rng.standard_normal((3, s.conv_width - 1, di)).astype(np.float32)
    js = {"h": jnp.asarray(h), "conv": jnp.asarray(conv)}
    ts = {"h": torch.from_numpy(h), "conv": torch.from_numpy(conv)}
    before = {k: v.clone() for k, v in ts.items()}
    for step in range(4):
        x = rng.standard_normal((3, 1, d)).astype(np.float32)
        yj, js = j_ssm.mamba_decode_step(jnp.asarray(x), js, jp, d, s)
        yt, ts_new = ssm.mamba_decode_step(torch.from_numpy(x), ts, tp, d, s)
        if step == 0:       # the given state is not modified
            assert all(torch.equal(ts[k], before[k]) for k in ts)
        ts = ts_new
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj),
                                   rtol=BLOCK_TOL, atol=BLOCK_TOL)
        for k in ("h", "conv"):
            np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                       rtol=BLOCK_TOL, atol=BLOCK_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_matches_jax_tree(dtype):
    """``init_params`` gives the JAX tree's leaves, shapes and dtypes;
    ``D`` exactly, ``A_log`` within 1 ulp (log may round apart), zero
    leaves zero, and every normal leaf's mean and stddev within sampling
    bounds of the JAX stddev (the generators differ)."""
    base = get_config("falcon-mamba-7b", smoke=True)
    cfg = dataclasses.replace(base, param_dtype=dtype, compute_dtype=dtype)
    jcfg = dataclasses.replace(j_get_config("falcon-mamba-7b", smoke=True),
                               param_dtype=dtype, compute_dtype=dtype)
    jtree = jax.tree.map(np.asarray,
                         j_build_model(jcfg).init(jax.random.PRNGKey(0)))
    tree = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    jflat = dict(jax.tree_util.tree_flatten_with_path(jtree)[0])
    d, di = cfg.d_model, cfg.ssm.expand * cfg.d_model
    dtr = max(d // 16, 1)
    stddev = {"embed": 1.0, "unembed": d ** -0.5, "w_in": d ** -0.5,
              "conv_w": 0.2, "w_out": di ** -0.5, "w_bc": di ** -0.5,
              "w_dt_down": di ** -0.5, "w_dt_up": dtr ** -0.5,
              "dt_bias": 0.1}
    seen = 0
    for path, jleaf in jflat.items():
        keys = [p.key for p in path]
        leaf = tree
        for k in keys:
            leaf = leaf[k]
        name = keys[-1]
        assert tuple(leaf.shape) == jleaf.shape, keys
        assert str(leaf.dtype).split(".")[-1] == jleaf.dtype.name, keys
        got = leaf.to(torch.float64).numpy()
        want = jleaf.astype(np.float64)
        if name == "D":
            assert np.array_equal(got, want)
        elif name == "A_log":
            ulp = np.spacing(np.abs(jleaf)).astype(np.float64)
            assert (np.abs(got - want) <= ulp).all()
        elif name in ("ln", "final_norm", "conv_b"):
            assert not got.any() and not want.any()
        else:
            sd, n = stddev[name], got.size
            assert abs(got.mean()) < 6 * sd / np.sqrt(n), keys
            assert abs(got.std() / sd - 1) < 6 / np.sqrt(2 * n) + 0.01, keys
        seen += 1
    assert seen == len(jflat) == 14


def _layer2(seed):
    cfg = get_config("zamba2-2.7b", smoke=True)
    init = JInitializer(jax.random.PRNGKey(seed), jnp.float32)
    jp = j_ssm.init_mamba(init, cfg.d_model, cfg.ssm)
    tp = model_params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return cfg, jp, tp


@pytest.mark.parametrize("l", [64, 40, 7])
def test_mamba2_block_matches_jax(l):
    """zamba2's Mamba2 block at its smoke width (d_model 128, 8 heads of
    32, state 16, chunk 16): the chunked SSD, the per-head decay and the
    gate norm equal the JAX block within BLOCK_TOL, at 4, 2 (of 20) and 1
    chunks."""
    cfg, jp, tp = _layer2(l)
    d = cfg.d_model
    x = (np.random.default_rng(l).standard_normal((2, l, d)) * 0.3
         ).astype(np.float32)
    want = np.asarray(j_ssm.mamba_block(jnp.asarray(x), jp, d, cfg.ssm,
                                        remat_chunks=False))
    got = ssm.mamba_block(torch.from_numpy(x), tp, d, cfg.ssm).numpy()
    np.testing.assert_allclose(got, want, rtol=BLOCK_TOL, atol=BLOCK_TOL)
    with pytest.raises(ValueError, match="chunks"):     # 41: 2 chunks of 20
        ssm.mamba_block(torch.zeros((1, 41, d)), tp, d, cfg.ssm)


def test_mamba2_decode_step_matches_jax():
    """Four Mamba2 decode steps from a nonzero state: outputs, h [B, H,
    P, N] and conv equal the JAX step's; the given state is kept."""
    cfg, jp, tp = _layer2(3)
    d, s = cfg.d_model, cfg.ssm
    rng = np.random.default_rng(5)
    di = s.expand * d
    nh = di // s.head_dim
    h = (rng.standard_normal((3, nh, s.head_dim, s.state_dim)) * 0.1
         ).astype(np.float32)
    conv = rng.standard_normal((3, s.conv_width - 1, di)).astype(np.float32)
    js = {"h": jnp.asarray(h), "conv": jnp.asarray(conv)}
    ts = {"h": torch.from_numpy(h), "conv": torch.from_numpy(conv)}
    before = {k: v.clone() for k, v in ts.items()}
    for step in range(4):
        x = rng.standard_normal((3, 1, d)).astype(np.float32)
        yj, js = j_ssm.mamba_decode_step(jnp.asarray(x), js, jp, d, s)
        yt, ts_new = ssm.mamba_decode_step(torch.from_numpy(x), ts, tp, d, s)
        if step == 0:
            assert all(torch.equal(ts[k], before[k]) for k in ts)
        ts = ts_new
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj),
                                   rtol=BLOCK_TOL, atol=BLOCK_TOL)
        for k in ("h", "conv"):
            np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                       rtol=BLOCK_TOL, atol=BLOCK_TOL)


def test_mamba2_init_and_state_match_jax_shapes():
    """``init_mamba`` and ``init_ssm_state`` at version 2 give the JAX
    leaves, shapes and dtypes; ``A_log`` zero, ``D`` one, as there."""
    cfg = get_config("zamba2-2.7b", smoke=True)
    jp = j_ssm.init_mamba(JInitializer(jax.random.PRNGKey(0), jnp.float32),
                          cfg.d_model, cfg.ssm)
    tp = ssm.init_mamba(Initializer(torch.Generator(), torch.float32),
                        cfg.d_model, cfg.ssm)
    assert set(tp) == set(jp)
    for k in jp:
        assert tuple(tp[k].shape) == jp[k].shape, k
        assert str(tp[k].dtype).split(".")[-1] == jp[k].dtype.name, k
    assert not tp["A_log"].any() and bool((tp["D"] == 1).all())
    js = j_ssm.init_ssm_state(2, cfg.d_model, cfg.ssm, jnp.float32)
    ts = ssm.init_ssm_state(2, cfg.d_model, cfg.ssm, torch.float32, "cpu")
    for k in js:
        assert tuple(ts[k].shape) == js[k].shape, k
