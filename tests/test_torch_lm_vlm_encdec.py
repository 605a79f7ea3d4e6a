"""repro_torch's vlm (llama-3.2-vision-11b: tanh-gated cross-attention
layers over ``extra["patches"]``) and encdec (whisper-medium: encoder
over ``extra["frames"]``, decoder cross-attention) families against the
JAX package on the CPU, at the smoke configs, through ``_torch_lm``'s
harness, ``extra`` passed to both; and the launcher, which serves every
text architecture and raises for these two, naming the input the
batcher cannot pass."""

import pytest
import torch

from _torch_lm import check_family, pair

from repro_torch.configs import arch_names, get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch_serve


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-medium"])
def test_family_with_extra_matches_jax(arch):
    ops.reset_launch_counts()
    check_family(arch)
    assert ops.launch_counts()["flash_decode"] == 0     # CPU: plain version


@pytest.mark.parametrize("arch,name", [("llama-3.2-vision-11b", "patches"),
                                       ("whisper-medium", "frames")])
def test_prefill_without_extra_raises(arch, name):
    _jm, _jp, tm, tp = pair(arch)
    with pytest.raises(ValueError, match=name):
        tm.prefill(tp, torch.zeros((1, 4), dtype=torch.long), 8)


@pytest.mark.parametrize("arch", arch_names())
def test_launcher_serves_text_archs_and_names_missing_extra(arch, capsys):
    fam = get_config(arch).family
    argv = ["--mode", "lm", "--device", "cpu", "--arch", arch,
            "--requests", "3", "--max-new", "3", "--slots", "2"]
    if fam in ("vlm", "encdec"):
        with pytest.raises(ValueError, match={"vlm": "patches",
                                              "encdec": "frames"}[fam]):
            launch_serve.main(argv)
        return
    launch_serve.main(argv)
    out = capsys.readouterr().out
    assert "served 3 requests / 9 tokens" in out and "on cpu" in out


def test_cross_decode_takes_the_kernel_route():
    """The vlm and encdec cross-attentions are decode attentions over
    n_patches / enc_seq positions with no RoPE: the kernel route."""
    from repro_torch.models import attention

    for arch in ("llama-3.2-vision-11b", "whisper-medium"):
        assert attention.decode_route(get_config(arch).attn) == "kernel"
