"""The port's roofline (``repro_torch.utils.roofline``): the analytic
functions against the JAX package's for every (arch, shape) cell, the
H100's constants, the work counter's rules op by op, and the per-card
terms of an artifact."""

import math

import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.utils import roofline as jr

from repro_torch.configs import ARCHS, SHAPES, applicable_shapes, get_config
from repro_torch.utils import roofline as tr

CELLS = [(a, s) for a in ARCHS for s in applicable_shapes(get_config(a))]
IDS = [f"{a}-{s}" for a, s in CELLS]


@pytest.mark.parametrize("arch,shape", CELLS, ids=IDS)
def test_probe_depths_match_jax(arch, shape):
    assert tr.probe_depths(get_config(arch)) == jr.probe_depths(
        j_get_config(arch))


@pytest.mark.parametrize("arch,shape", CELLS, ids=IDS)
def test_model_flops_match_jax(arch, shape):
    art = {"arch": arch, "shape": shape}
    assert tr.model_flops(art) == jr.model_flops(art)


@pytest.mark.parametrize("arch,shape", CELLS, ids=IDS)
def test_flash_onchip_bytes_match_jax(arch, shape):
    """At the per-card batch equal to the JAX probe's rows a device
    (the global batch over its 16-way data axis)."""
    per_card = SHAPES[shape].global_batch / 16
    assert tr.flash_onchip_bytes(arch, shape, per_card) == \
        jr.flash_onchip_bytes(arch, shape, 256)


def test_probe_config_changes_depth_only():
    cfg = get_config("whisper-medium")
    p = tr.probe_config(cfg, 3)
    assert (p.n_layers, p.n_enc_layers) == (3, 3)
    assert (p.attn_chunk_q, p.attn_chunk_k, p.loss_chunk) == (
        cfg.attn_chunk_q, cfg.attn_chunk_k, cfg.loss_chunk)
    moe = get_config("arctic-480b")
    assert tr.probe_config(moe, 2).moe == moe.moe


def test_h100_constants():
    """NVIDIA's H100 SXM5 80GB figures at 700 W."""
    assert tr.PEAK_BF16 == 989e12 and tr.PEAK_TF32 == 494.7e12
    assert tr.PEAK_FP32 == 66.9e12 and tr.HBM_BW == 3.35e12
    assert tr.HBM_BYTES == 80e9
    assert tr.SFU_PER_S == pytest.approx(132 * 16 * 1.98e9)


# ------------------------------------------------------------ the counter
def test_views_count_nothing_and_ops_count_inputs_plus_outputs():
    x = torch.empty((64, 32), dtype=torch.bfloat16, device="meta")
    with tr.WorkCounter() as wc:
        wc.begin_step()
        v = x.view(32, 64).transpose(0, 1)
        assert wc.result()["ops"] == 0 and wc.bytes == 0
        y = x.float()                                # read bf16, write f32
    assert wc.bytes == 64 * 32 * 2 + 64 * 32 * 4
    assert v.shape == (64, 32) and y.dtype == torch.float32


def test_inplace_ops_count_bytes_but_allocate_nothing():
    x = torch.empty((1024,), device="meta")
    with tr.WorkCounter() as wc:
        wc.begin_step()
        live = wc.live
        x.add_(1.0)
    assert wc.bytes == 2 * 4096 and wc.live == live


def test_matmul_units_and_exponentials():
    a = torch.empty((8, 16), dtype=torch.bfloat16, device="meta")
    b = torch.empty((16, 4), dtype=torch.bfloat16, device="meta")
    with tr.WorkCounter() as wc:
        a @ b
        a.float() @ b.float()
        torch.exp(a.float())
        torch.softmax(a.float(), -1)
    r = wc.result()
    assert r["flops_bf16"] == r["flops_f32"] == 2 * 8 * 16 * 4
    assert r["flops_tf32"] == 0
    assert r["exps"] == 2 * 8 * 16


def test_peak_follows_live_storages():
    """A storage counts from the op that makes it until its last view
    dies; the peak is the most live at once; allocations alone move no
    bytes."""
    with tr.WorkCounter() as wc:
        a = torch.empty((1 << 20,), device="meta")       # 4 MiB
        wc.begin_step()
        assert wc.argument_bytes == 4 << 20 and wc.bytes == 0
        b = a * 2                                        # +4 MiB
        v = b[:10]
        del b
        assert wc.live == 8 << 20                        # v keeps b alive
        del v
        assert wc.live == 4 << 20
        c = a + 1
        d = c + 1
        del c, d
    r = wc.result()
    assert r["peak_bytes"] == 12 << 20
    assert r["argument_bytes"] == 4 << 20
    assert r["bytes"] == 3 * 2 * (4 << 20)


def test_kernel_work_adds_to_its_units():
    with tr.WorkCounter() as wc:
        wc.add_kernel_work("k", {"bytes": 10, "exps": 3, "flops_f32": 7})
        wc.add_kernel_work("k", {"bytes": 1, "exps": 0, "flops_f32": 0})
    r = wc.result()
    assert (r["bytes"], r["exps"], r["flops_f32"]) == (11, 3, 7)
    assert (r["k.calls"], r["k.bytes"]) == (2, 11)


# ------------------------------------------------------------ the terms
def _art(arch="qwen3-14b", shape="decode_32k", batch=8, **counts):
    row = {"flops_bf16": 2e12, "flops_tf32": 0.0, "flops_f32": 1e11,
           "bytes": 6e10, "exps": 4e9, "peak_bytes": 7e10,
           "argument_bytes": 3e10, **counts}
    return {"arch": arch, "shape": shape, "kind": SHAPES[shape].kind,
            "n_layers": get_config(arch).n_layers, "batch": batch,
            "cards": SHAPES[shape].global_batch / batch, "counts": row}


def test_analyze_artifact_terms():
    r = tr.analyze_artifact(_art())
    want_c = 2e12 / 989e12 + 1e11 / 66.9e12 + 4e9 / tr.SFU_PER_S
    assert r["compute_s"] == pytest.approx(want_c)
    assert r["compute_bf16_s"] == pytest.approx(2e12 / 989e12)
    assert r["memory_s"] == pytest.approx(6e10 / 3.35e12)
    assert r["collective_s"] == 0.0 and r["bound"] == "memory"
    assert r["step_s"] == max(r["compute_s"], r["memory_s"])
    mf = tr.model_flops(_art())
    assert r["useful_frac"] == pytest.approx(mf / (2.1e12 * 16))
    assert r["roofline_frac"] == pytest.approx(
        mf / r["step_s"] / (989e12 * 16))
    assert r["fits"] and not tr.analyze_artifact(
        _art(peak_bytes=81e9))["fits"]
    assert r["onchip_bytes"] == 0.0 and not r["corrected"]


def test_corrected_totals_fit_in_depth():
    probe = {"fixed": {"bytes": 5.0, "peak_bytes": 1.0},
             "per_layer": {"bytes": 2.0, "peak_bytes": 3.0},
             "per_layer2": {"bytes": 0.5, "peak_bytes": 0.0}}
    art = _art()
    art["n_layers"] = 10
    tot = tr.corrected_totals(art, probe)
    assert tot["bytes"] == 5 + 20 + 50 and tot["peak_bytes"] == 31
    assert tot["corrected"]
    assert tr.corrected_totals(art, None)["bytes"] == 6e10


def test_every_term_finite_and_bounded_on_a_smoke_cell(tmp_path):
    from repro_torch.launch import dryrun

    art = dryrun.dryrun_cell("internlm2-1.8b", "decode_32k", batch=4,
                             cfg=get_config("internlm2-1.8b", smoke=True),
                             out_dir=str(tmp_path))
    r = tr.analyze_artifact(art)
    for k in ("compute_s", "memory_s", "step_s", "useful_frac"):
        assert math.isfinite(r[k]) and r[k] >= 0, k
    assert r["bound"] in ("compute", "memory") and r["corrected"]
    assert np.isclose(r["step_s"], max(r["compute_s"], r["memory_s"]))


def test_gathers_and_indexed_writes_count_the_picked_rows():
    """A gather reads its indices and the rows it picks and writes them;
    an indexed write in place reads its indices and values and writes
    the values: one decode step's K/V write touches one row of its
    cache, not all of it."""
    cache = torch.empty((4, 1000, 8), device="meta")          # 128 KB
    rows = torch.empty((4,), dtype=torch.int64, device="meta")  # 32 B
    new = torch.empty((4, 8), device="meta")                  # 128 B
    bidx = torch.arange(4, device="meta")                     # 32 B
    with tr.WorkCounter() as wc:
        wc.begin_step()
        got = cache[bidx, rows]
        gather = wc.bytes
        cache[bidx, rows] = new
    assert got.shape == (4, 8)
    assert gather == (32 + 32) + 2 * 128
    assert wc.bytes - gather == 2 * (32 + 32 + 128)
