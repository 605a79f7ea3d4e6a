"""``chip_smoke.py``'s phase r fit verdict, on the CPU with fake dry-run
artifacts and a fake model: a verdict that the card contradicts fails
the smoke (predicted to fit and out of memory, or predicted not to fit
and run), and a cell out of memory as predicted records that and
measures nothing."""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402


def _art(fits, arch, shape, batch):
    return {"arch": arch, "shape": shape, "kind": shape.split("_")[0],
            "batch": batch, "cards": 16.0, "n_layers": 1, "probe": None,
            "fits": fits, "counts": {"peak_bytes": 72e9 if fits else 90e9,
                                     "bytes": 1e9, "flops_bf16": 1e9}}


def _oom(*_args, **_kwargs):
    raise torch.cuda.OutOfMemoryError("fake: out of memory")


class _Model:
    device = torch.device("cpu")
    init_decode_state = staticmethod(_oom)
    prefill = staticmethod(_oom)


class _Windows:
    def run(self, fn):
        return fn(), {}


@pytest.mark.parametrize("fits,oom,held", [
    (True, False, True), (False, True, True),
    (True, True, False), (False, False, False)],
    ids=["fits-ran", "no-fit-oom", "fits-oom", "no-fit-ran"])
def test_fit_verdict(fits, oom, held):
    art = _art(fits, "qwen3-14b", "decode_32k", 8)

    def run():
        if oom:
            _oom()
        return "measured"

    if not held:
        with pytest.raises(SystemExit, match="FAIL: r1: predicted"):
            cs.fit_verdict("r1", art, run)
    else:
        assert cs.fit_verdict("r1", art, run) == (None if oom else "measured")


CELLS = [("r1", "qwen3-14b", "decode_32k"),
         ("r2", "falcon-mamba-7b", "prefill_32k")]


@pytest.mark.parametrize("fits", [False, True], ids=["no-fit", "fits"])
@pytest.mark.parametrize("tag,arch,shape", CELLS, ids=[c[0] for c in CELLS])
def test_cell_out_of_memory(tag, arch, shape, fits):
    """r1 and r2 on a model that runs out of memory: a record of it where
    the dry run predicted that, a failed smoke where it predicted a fit."""
    art = _art(fits, arch, shape, 1)
    lm = {"model": _Model(), "params": None, "cfg": get_config(arch)}

    def cell():
        if tag == "r1":
            return cs.roofline_decode(_Windows(), lm, art, "card")
        return cs.roofline_prefill(_Windows(), lm, art, art, "card")

    if fits:
        with pytest.raises(SystemExit, match="ran out of memory"):
            cell()
        return
    out = cell()
    assert out["out_of_memory"] and out["batch"] == 1
    assert out["peak_predicted_gb"] == 90.0 and out["seconds"] >= 0


def test_r3_fails_where_t1_ran_against_the_prediction():
    """t1 has run by r3: a dry run that said its shape does not fit is
    contradicted before anything is traced."""
    art = _art(False, "internlm2-1.8b", "train_4k", 8)
    with pytest.raises(SystemExit, match="predicted not to fit"):
        cs.roofline_train(None, None, {}, art, "card")


# ------------------------------------------------------------- phase m
def test_m1_bit_equality_on_one_card():
    ref = torch.randn(8, 64)
    tok = ref.argmax(-1, keepdim=True)
    assert cs.mesh_decode_verdict(1, ref, ref.clone(), tok, tok.clone(),
                                  "m1") == 0.0
    off = ref.clone()
    off[3, 5] = torch.nextafter(off[3, 5], torch.tensor(1e9))
    with pytest.raises(SystemExit, match="bit-equal"):
        cs.mesh_decode_verdict(1, ref, off, tok, tok, "m1")
    with pytest.raises(SystemExit, match="bit-equal"):
        cs.mesh_decode_verdict(1, ref, ref, tok, (tok + 1) % 64, "m1")


def test_m1_ulp_rule_on_more_cards():
    """On more cards: within ``MESH_ULPS`` bf16 ulps of the unsharded
    route, a token flip allowed only on a near tie."""
    ref = torch.zeros(2, 16)
    ref[:, 3] = 8.0
    ref[:, 4] = 8.0 - cs.bf16_ulp(8.0)          # a near tie with 3
    tok = ref.argmax(-1, keepdim=True)
    near = ref.clone()
    near[:, 4] += 2 * cs.bf16_ulp(8.0)
    flipped = near.argmax(-1, keepdim=True)
    assert not torch.equal(flipped, tok)
    assert cs.mesh_decode_verdict(4, ref, near, tok, flipped, "m1") <= 1.0
    far = ref.clone()
    far[0, 7] += (cs.MESH_ULPS + 1) * cs.bf16_ulp(8.0)
    with pytest.raises(SystemExit, match="bf16 ulps"):
        cs.mesh_decode_verdict(4, ref, far, tok, tok, "m1")


@pytest.mark.parametrize("ratio,held", [(1.0, True), (0.96, True),
                                        (1.09, True), (0.90, False),
                                        (1.15, False)])
def test_m2_peak_ratio_bound(ratio, held):
    pred = 22e9
    if held:
        assert cs.mesh_peak_verdict("m2", ratio * pred, pred) == \
            pytest.approx(ratio)
    else:
        with pytest.raises(SystemExit, match="outside"):
            cs.mesh_peak_verdict("m2", ratio * pred, pred)


def test_mesh_launch_counts():
    cs.per_step_launches([40, 40, 40], 40, "m2")
    with pytest.raises(SystemExit, match="expected 40"):
        cs.per_step_launches([40, 39, 40], 40, "m2")


def test_m4_launch_windows():
    """m4's windows: ``mamba_scan`` once a Mamba1 layer in a prefill,
    ``flash_decode`` once an attention on the kernel route a step."""
    cs.per_step_launches([32], 32, "m4 prefill", "mamba_scan")
    with pytest.raises(SystemExit, match="mamba_scan launched"):
        cs.per_step_launches([31], 32, "m4 prefill", "mamba_scan")
    cs.per_step_launches([9, 9, 9, 9], 9, "m4 zamba2")
    with pytest.raises(SystemExit, match="expected 24 a step"):
        cs.per_step_launches([24, 24, 0, 24], 24, "m4 granite")


@pytest.mark.parametrize("counted,held", [(3.5e9, True), (3.5e9 * 1.001,
                                                          False),
                                          (3.4e9, False)])
def test_m5_collective_bytes_equal_the_dry_run(counted, held):
    if held:
        cs.collective_verdict("m5", counted, 3.5e9)
    else:
        with pytest.raises(SystemExit, match="collective bytes"):
            cs.collective_verdict("m5", counted, 3.5e9)


def test_m5_kernel_against_plain():
    want = torch.randn(4, 8, 16)
    assert cs.kernel_verdict("m5", "mamba_scan", want + 1e-6, want,
                             cs.SCAN_TOL) == pytest.approx(1e-6, rel=0.1)
    with pytest.raises(SystemExit, match="mamba_scan disagrees"):
        cs.kernel_verdict("m5", "mamba_scan", want + 1e-2, want,
                          cs.SCAN_TOL)


def test_m5_batch_follows_the_dry_run(monkeypatch):
    """Where the dry run says the rank does not fit at the JAX per-card
    batch, m5 takes the largest power of two below that does, and says
    so."""
    from repro_torch.launch import dryrun

    def fake(arch, shape_name, batch=None, cfg=None, mesh=None,
             save=True):
        b = batch or 8
        return {"batch": b, "fits": b <= 2}

    monkeypatch.setattr(dryrun, "dryrun_cell", fake)
    art, note = cs._fit_batch("arctic-480b", "decode_32k", None, None)
    assert art["batch"] == 2 and "batch 2" in note
    monkeypatch.setattr(dryrun, "dryrun_cell",
                        lambda *a, **k: {"batch": 8, "fits": True})
    art, note = cs._fit_batch("arctic-480b", "decode_32k", None, None)
    assert art["batch"] == 8 and note is None


def test_m6_losses_within_the_bound():
    a = [10.0, 9.5, 9.0, 8.7]
    assert cs.loss_verdict("m6", a, [x * (1 + 5e-5) for x in a], 4,
                           cs.RESTART_TOL) == pytest.approx(5e-5)
    with pytest.raises(SystemExit, match="not the unsharded"):
        cs.loss_verdict("m6", a, [x * (1 + 2e-4) for x in a], 4,
                        cs.RESTART_TOL)
    with pytest.raises(SystemExit, match="expected 4 each"):
        cs.loss_verdict("m6", a, a[:3], 4, cs.RESTART_TOL)


# ------------------------------------------------------ phase m, m7-m10
def test_m7_state_bit_equality_on_one_card():
    """m7's (and m4's) state verdict: every leaf, the cross caches
    among them, bit-equal on one card; on more cards the logits' ulp
    rule holds instead."""
    ref = {"cache_len": torch.tensor([130, 130], dtype=torch.int32),
           "cross_k": torch.randn(8, 2, 1601, 8, 4).to(torch.bfloat16),
           "k_cache": torch.randn(40, 2, 132, 8, 4).to(torch.bfloat16)}
    got = {k: v.clone() for k, v in ref.items()}
    cs.state_verdict(1, ref, got, "m7")
    off = dict(got)
    off["cross_k"] = got["cross_k"].clone()
    off["cross_k"][3, 1, 1600, 7, 0] += 1.0
    with pytest.raises(SystemExit, match="cross_k is not bit-equal"):
        cs.state_verdict(1, ref, off, "m7")
    with pytest.raises(SystemExit, match="leaves"):
        cs.state_verdict(1, ref, {k: got[k] for k in ("cache_len",
                                                      "k_cache")}, "m7")
    cs.state_verdict(4, ref, off, "m7")


def test_m7_m8_launch_windows_of_48():
    """48 ``flash_decode`` a decode step for each model at its full
    config (llama-3.2-vision-11b's 40 self and 8 cross attentions,
    whisper-medium's 24 and 24), none in a prefill."""
    for arch in ("llama-3.2-vision-11b", "whisper-medium"):
        assert cs.kernel_attn_per_step(get_config(arch)) == 48
    cs.per_step_launches([48, 48, 48, 48], 48, "m7 llama")
    with pytest.raises(SystemExit, match="expected 48 a step"):
        cs.per_step_launches([48, 48, 40, 48], 48, "m7 llama")
    cs.per_step_launches([0], 0, "m7 whisper prefill")
    with pytest.raises(SystemExit, match="expected 0 a step"):
        cs.per_step_launches([24], 0, "m7 whisper prefill")


@pytest.mark.parametrize("ratio,held", [(1.0, True), (0.951, True),
                                        (1.099, True), (0.94, False),
                                        (1.11, False)])
def test_m8_m9_peak_ratio(ratio, held):
    pred = 43.8e9       # about llama-3.2-vision-11b's rank: the 42.95 GB cache
    if held:
        assert cs.mesh_peak_verdict("m8", ratio * pred, pred) == \
            pytest.approx(ratio)
    else:
        with pytest.raises(SystemExit, match="outside"):
            cs.mesh_peak_verdict("m8", ratio * pred, pred)


@pytest.mark.parametrize("counted,held", [(2.5e8, True),
                                          (2.5e8 + 1e3, False)])
def test_m8_m9_collective_bytes_equal_the_dry_run(counted, held):
    if held:
        cs.collective_verdict("m8", counted, 2.5e8)
    else:
        with pytest.raises(SystemExit, match="collective bytes"):
            cs.collective_verdict("m8", counted, 2.5e8)


def test_m10_losses_within_the_bound():
    a = [12.1, 11.9, 11.6, 11.2]
    assert cs.loss_verdict("m10", a, list(a), 4, cs.RESTART_TOL) == 0.0
    with pytest.raises(SystemExit, match="not the unsharded"):
        cs.loss_verdict("m10", a, [x * (1 + 3e-4) for x in a], 4,
                        cs.RESTART_TOL)


@pytest.mark.parametrize("seconds,held", [(60.0, True), (120.0, True),
                                          (120.5, False)])
def test_m7_m10_budget(seconds, held):
    if held:
        cs.budget_verdict("m7-m10", seconds, cs.MESH2_BUDGET_S)
    else:
        with pytest.raises(SystemExit, match="past its 120.0 s budget"):
            cs.budget_verdict("m7-m10", seconds, cs.MESH2_BUDGET_S)
