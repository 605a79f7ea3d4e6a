"""repro_torch's moe family (granite-moe-1b-a400m, arctic-480b with its
dense residual branch) and ``moe_block`` against the JAX package on the
CPU: the family through ``_torch_lm``'s harness (the aux loss included),
``moe_block`` with more tokens than capacity (the drop masks equal, and
some pairs dropped), the sequence-chunked dispatch, and the batcher."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import TOL, check_batcher, check_family

from repro.configs import get_config as j_get_config
from repro.models import moe as j_moe
from repro.models.layers import Initializer as JInitializer

from repro_torch.configs import get_config
from repro_torch.models import moe
from repro_torch.weights import model_params_from_numpy


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "arctic-480b"])
def test_moe_family_matches_jax(arch):
    check_family(arch)


def test_batcher_matches_jax_batcher_moe():
    check_batcher("granite-moe-1b-a400m")


def _jax_keep(x, p, m):
    """The JAX ``moe_block``'s drop mask of one chunk
    (``src/repro/models/moe.py:76-92``), written out with the same jax
    calls: stable ``argsort``, left ``searchsorted``."""
    tc = x.shape[0]
    k, e = m.top_k, m.n_experts
    probs = jax.nn.softmax(x.astype(jnp.float32) @ p["router"], axis=-1)
    _w, top_e = jax.lax.top_k(probs, k)
    cap = min(max(int(tc * k / e * m.capacity_factor), 4), tc * k)
    e_flat = top_e.reshape(tc * k)
    order = jnp.argsort(e_flat)
    sorted_e = e_flat[order]
    start = jnp.searchsorted(sorted_e, jnp.arange(e))
    rank_sorted = jnp.arange(tc * k, dtype=jnp.int32) - start[sorted_e]
    rank = jnp.zeros((tc * k,), jnp.int32).at[order].set(rank_sorted)
    return np.asarray(rank < cap), np.asarray(top_e), cap


def _moe_pair(arch, seed, **over):
    jm = dataclasses.replace(j_get_config(arch, smoke=True).moe, **over)
    m = dataclasses.replace(get_config(arch, smoke=True).moe, **over)
    jp = j_moe.init_moe(JInitializer(jax.random.PRNGKey(seed), jnp.float32),
                        128, jm)
    tp = model_params_from_numpy(jax.tree.map(np.asarray, jp),
                                 get_config(arch, smoke=True), "cpu")
    return jm, m, jp, tp


@pytest.mark.parametrize("arch,b,s,factor", [
    ("granite-moe-1b-a400m", 2, 40, 0.75),   # top-2 of 4: cap 30 of 160
    ("granite-moe-1b-a400m", 1, 64, 0.5),    # cap 16 of 128: most dropped
    ("arctic-480b", 3, 21, 1.0)])
def test_moe_block_drops_as_jax_does(arch, b, s, factor):
    """More tokens than capacity: the port's ``route`` keeps exactly the
    pairs JAX keeps (same experts, same ranks), and ``moe_block``'s output
    and aux loss equal the JAX block's."""
    jm, m, jp, tp = _moe_pair(arch, b + s, capacity_factor=factor)
    x = (np.random.default_rng(s).standard_normal((b, s, 128)) * 0.5
         ).astype(np.float32)
    want_keep, want_e, cap = _jax_keep(jnp.asarray(x.reshape(b * s, 128)),
                                       jp, jm)
    _w, top_e, slot, keep, tcap, _aux = moe.route(
        torch.from_numpy(x.reshape(b * s, 128)), tp, m)
    assert tcap == cap
    assert np.array_equal(top_e.numpy(), want_e)
    assert np.array_equal(keep.numpy(), want_keep)
    assert not want_keep.all() and want_keep.any()
    assert (slot.numpy()[~want_keep] == cap).all()
    yj, aj = j_moe.moe_block(jnp.asarray(x), jp, jm)
    yt, at = moe.moe_block(torch.from_numpy(x), tp, m)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=TOL,
                               atol=TOL)


def test_moe_block_sequence_chunks_match_jax():
    """``token_chunk`` below the tokens: 4 sequence chunks, routed and
    dropped one at a time, the aux loss averaged over them, as in JAX."""
    jm, m, jp, tp = _moe_pair("granite-moe-1b-a400m", 5, token_chunk=32)
    x = (np.random.default_rng(9).standard_normal((2, 64, 128)) * 0.5
         ).astype(np.float32)
    yj, aj = j_moe.moe_block(jnp.asarray(x), jp, jm)
    yt, at = moe.moe_block(torch.from_numpy(x), tp, m)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=TOL,
                               atol=TOL)
