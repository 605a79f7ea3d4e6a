"""repro_torch's hybrid family (zamba2-2.7b: Mamba2 layers, one shared
attention block after every ``hybrid_attn_every`` of them with one K/V
cache per group) against the JAX package on the CPU, at the smoke config
(2 layers, one group), through ``_torch_lm``'s harness, and the batcher
against the JAX batcher's tokens.  Mamba2's block and decode step alone
are in ``test_torch_mamba.py``."""

import dataclasses

import pytest

from _torch_lm import check_batcher, check_family, pair

from repro_torch.kernels import ops


def test_hybrid_family_matches_jax():
    ops.reset_launch_counts()
    check_family("zamba2-2.7b")
    assert ops.launch_counts()["flash_decode"] == 0     # CPU: plain version


def test_batcher_matches_jax_batcher_hybrid():
    check_batcher("zamba2-2.7b")


def test_hybrid_state_has_a_cache_per_group():
    """12 layers with a shared block every 6: two K/V caches, and a
    remainder of layers past the last full group gets no shared block."""
    _jm, _jp, tm, _tp = pair("zamba2-2.7b")
    cfg = dataclasses.replace(tm.cfg, n_layers=14, hybrid_attn_every=6)
    from repro_torch.models import transformer as tfm

    st = tfm.init_decode_state(cfg, 3, 16, "cpu")
    assert tuple(st["k_cache"].shape) == (2, 3, 16, cfg.attn.kv_heads,
                                          cfg.attn.head_dim)
    assert tfm._groups(cfg, 6) == [(0, 6), (6, 12), (12, 14)]
    with pytest.raises(ValueError, match="unknown family"):
        tfm.init_decode_state(dataclasses.replace(cfg, family="rnn"), 1, 4,
                              "cpu")
