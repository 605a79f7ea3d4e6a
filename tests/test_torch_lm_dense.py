"""repro_torch's dense family (qwen3-14b, gemma2-9b, phi4-mini-3.8b,
internlm2-1.8b) against the JAX package on the CPU, at the smoke configs,
through ``_torch_lm``'s harness: forward hidden states, prefill logits
and state, 8 teacher-forced decode steps (qwen3, phi4 and internlm2 on
the kernel route, whose ``flash_decode`` runs its plain version here;
gemma2 on the plain route: softcap and local windows), and the
continuous batcher against the JAX batcher's tokens."""

import pytest

from _torch_lm import check_batcher, check_family

from repro_torch.kernels import ops
from repro_torch.models import attention

DENSE = ["qwen3-14b", "gemma2-9b", "phi4-mini-3.8b", "internlm2-1.8b"]


@pytest.mark.parametrize("arch", DENSE)
def test_dense_family_matches_jax(arch):
    ops.reset_launch_counts()
    check_family(arch)
    assert ops.launch_counts()["flash_decode"] == 0     # CPU: plain version


def test_batcher_matches_jax_batcher_dense():
    check_batcher("internlm2-1.8b")


def test_decode_routes_follow_the_config():
    """gemma2-9b (softcap, local/global windows) decodes on the plain
    route at every layer; the other dense configs on the kernel route."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import _windows_for

    for arch in DENSE:
        cfg = get_config(arch)
        routes = {attention.decode_route(cfg.attn, w)
                  for w in _windows_for(cfg)}
        assert routes == ({"plain"} if arch == "gemma2-9b" else {"kernel"})
    cfg = get_config("gemma2-9b")
    assert _windows_for(cfg)[:2] == [4096, attention.BIG_WINDOW]
