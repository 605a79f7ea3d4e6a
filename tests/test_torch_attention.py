"""repro_torch's attention and layer pieces against the JAX package on
the CPU, in f32 with numpy-made inputs: ``decode_attention`` on both
routes (the kernel route's ``ops.flash_decode`` runs its plain version
on CPU tensors) with ragged ``cache_len``, ``flash_attention`` with
causal masking, a window and softcap, over JAX's chunks and over chunks
JAX cannot reshape, ``rope``, the SwiGLU and GELU MLPs, and the in-place
K/V write (a position past the cache dropped, as JAX's scatter drops
it)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import attention as j_attn
from repro.models import layers as j_layers

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import attention, layers
from repro_torch.weights import model_params_from_numpy

torch.set_num_threads(1)

# f32, port vs JAX: matmuls and softmax sums in another order (observed
# ~1e-6 on outputs of magnitude ~1)
TOL = 2e-5


def _attn_params(arch, seed, **over):
    a = dataclasses.replace(j_get_config(arch, smoke=True).attn, **over)
    init = j_layers.Initializer(jax.random.PRNGKey(seed), jnp.float32)
    jp = j_attn.init_attention(init, 128, a)
    # the norm scales are zero at init; give them values so qk-norm counts
    if a.qk_norm:
        for k in ("q_norm", "k_norm"):
            jp[k] = jax.random.normal(jax.random.PRNGKey(seed + 1), (
                a.head_dim,)) * 0.1
    tp = model_params_from_numpy(jax.tree.map(np.asarray, jp),
                                 get_config(arch, smoke=True), "cpu")
    ta = dataclasses.replace(get_config(arch, smoke=True).attn, **over)
    return a, ta, jp, tp


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("arch,window,route", [
    ("qwen3-14b", None, "kernel"),             # qk-norm, groups of 2
    ("whisper-medium", None, "kernel"),        # kv heads = q heads
    ("gemma2-9b", attention.BIG_WINDOW, "plain"),   # softcap 50
    ("gemma2-9b", 5, "plain"),                 # softcap and a local window
])
def test_decode_attention_matches_jax(arch, window, route):
    a, ta, jp, tp = _attn_params(arch, 3)
    assert attention.decode_route(ta, window) == route
    rng = np.random.default_rng(11)
    b, s = 4, 24
    x = rng.standard_normal((b, 1, 128)).astype(np.float32)
    kc = rng.standard_normal((b, s, a.kv_heads, a.head_dim)).astype(
        np.float32)
    vc = rng.standard_normal((b, s, a.kv_heads, a.head_dim)).astype(
        np.float32)
    cache_len = np.array([1, 9, 17, s], np.int32)     # ragged, S included
    want = j_attn.decode_attention(
        jnp.asarray(x), jp, a, jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(cache_len), window=window)
    ops.reset_launch_counts()
    args = (torch.from_numpy(x), tp, ta, torch.from_numpy(kc),
            torch.from_numpy(vc), torch.from_numpy(cache_len))
    _close(attention.decode_attention(*args, window=window), want)
    assert ops.launch_counts()["flash_decode"] == 0    # CPU: plain version
    if route == "kernel":     # the plain route on the same cache agrees
        _close(attention.decode_attention(*args, route="plain"), want)
        cross = j_attn.decode_attention(
            jnp.asarray(x), jp, a, jnp.asarray(kc), jnp.asarray(vc),
            jnp.asarray(cache_len), use_rope=False)
        _close(attention.decode_attention(*args, use_rope=False), cross)


@pytest.mark.parametrize("lq,lk,causal,window,cap,cq,ck", [
    (48, 48, True, None, None, 16, 16),        # 3 x 3 JAX chunks
    (48, 48, True, 7, None, 16, 32),           # a window
    (48, 48, True, 7, 5.0, 16, 16),            # and softcap
    (12, 40, False, None, None, 4, 8),         # cross: Lq != Lk
    (40, 40, True, 9, 5.0, 40, 40),            # one chunk each
])
def test_flash_attention_matches_jax(lq, lk, causal, window, cap, cq, ck):
    rng = np.random.default_rng(lq + lk + cq)
    q = rng.standard_normal((2, lq, 4, 32)).astype(np.float32)
    k = rng.standard_normal((2, lk, 2, 32)).astype(np.float32)
    v = rng.standard_normal((2, lk, 2, 32)).astype(np.float32)
    qp = np.arange(lk - lq, lk, dtype=np.int32)
    kp = np.arange(lk, dtype=np.int32)
    want = j_attn.flash_attention(
        *(jnp.asarray(t) for t in (q, k, v, qp, kp)), causal=causal,
        window=window, cap=cap, chunk_q=cq, chunk_k=ck)
    got = attention.flash_attention(
        *(torch.from_numpy(t) for t in (q, k, v, qp, kp)), causal=causal,
        window=window, cap=cap, chunk_q=cq, chunk_k=ck)
    _close(got, want)


def test_flash_attention_ragged_chunks_equal_one_chunk():
    """L 50 with chunks of 16: JAX cannot reshape 50 into 3 chunks; the
    port's last chunk is shorter, and the result is JAX's at one chunk."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((1, 50, 4, 32)).astype(np.float32)
    k = rng.standard_normal((1, 50, 2, 32)).astype(np.float32)
    pos = np.arange(50, dtype=np.int32)
    want = j_attn.flash_attention(
        *(jnp.asarray(t) for t in (q, k, k, pos, pos)), causal=True,
        window=11, cap=3.0, chunk_q=50, chunk_k=50)
    got = attention.flash_attention(
        *(torch.from_numpy(t) for t in (q, k, k, pos, pos)), causal=True,
        window=11, cap=3.0, chunk_q=16, chunk_k=16)
    _close(got, want)
    assert attention._chunks(50, 16) == [(0, 17), (17, 34), (34, 50)]


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_matches_jax(theta):
    rng = np.random.default_rng(int(theta) % 97)
    x = rng.standard_normal((2, 9, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 9)).astype(np.int32)
    _close(layers.rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
           j_layers.rope(jnp.asarray(x), jnp.asarray(pos), theta))


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp_matches_jax(act):
    """SwiGLU, and the GELU MLP with ``jax.nn.gelu``'s default tanh
    approximation (torch's default erf would be ~1e-3 apart)."""
    init = j_layers.Initializer(jax.random.PRNGKey(4), jnp.float32)
    jp = j_layers.init_mlp(init, 64, 96, act)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = (np.random.default_rng(5).standard_normal((3, 5, 64)) * 2
         ).astype(np.float32)
    _close(layers.swiglu(torch.from_numpy(x), tp, act),
           j_layers.swiglu(jnp.asarray(x), jp, act))


def test_softcap_and_rms_norm_match_jax():
    x = np.random.default_rng(6).standard_normal((4, 32)).astype(np.float32)
    w = np.random.default_rng(7).standard_normal(32).astype(np.float32)
    _close(layers.softcap(torch.from_numpy(x * 40), 30.0),
           j_layers.softcap(jnp.asarray(x * 40), 30.0))
    _close(layers.rms_norm(torch.from_numpy(x), torch.from_numpy(w)),
           j_layers.rms_norm(jnp.asarray(x), jnp.asarray(w)))


def test_update_kv_cache_matches_jax_and_drops_past_the_end():
    """The new token's K/V written in place at each row's ``cache_len``,
    as ``update_kv_cache``'s scatter writes it; a row at S writes
    nothing (JAX drops the out-of-range update)."""
    a, ta, jp, tp = _attn_params("qwen3-14b", 8)
    rng = np.random.default_rng(9)
    s = 6
    x = rng.standard_normal((3, 1, 128)).astype(np.float32)
    kc = rng.standard_normal((3, s, a.kv_heads, a.head_dim)).astype(
        np.float32)
    vc = kc[::-1].copy()
    lens = np.array([0, 4, s], np.int32)
    jk, jv = j_attn.update_kv_cache(jnp.asarray(x), jp, a, jnp.asarray(kc),
                                    jnp.asarray(vc), jnp.asarray(lens))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    out = attention.update_kv_cache(torch.from_numpy(x), tp, ta, tk, tv,
                                    torch.from_numpy(lens))
    assert out[0] is tk and out[1] is tv                 # in place
    _close(tk, jk)
    _close(tv, jv)
    assert np.array_equal(tk[2].numpy(), kc[2])          # row at S kept
