"""The port's one-card dry run (``repro_torch.launch.dryrun``) and its
input surface (``models.model.input_specs``, ``decode_state_shapes``).

The input surface is held to the JAX package's for every (arch, shape)
cell.  The JAX dry-run subprocess test fails on this tree, so the
counts are held to plain oracles instead of XLA: the same counter's run
on real CPU tensors, analytic matmul FLOPs, a direct count at the
extrapolated depth, and the kernels' work functions."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.models.model import decode_state_shapes as j_state_shapes
from repro.models.model import input_specs as j_input_specs

from repro_torch.configs import (ARCHS, SHAPES, applicable_shapes,
                                 get_config)
from repro_torch.kernels import flash_decode as fd_mod
from repro_torch.kernels import mamba_scan as ms_mod
from repro_torch.launch import dryrun
from repro_torch.models.model import decode_state_shapes, input_specs
from repro_torch.utils import report
from repro_torch.utils.roofline import (WorkCounter, corrected_totals,
                                        probe_config, probe_depths)

torch.set_num_threads(1)

CELLS = [(a, s) for a in ARCHS for s in applicable_shapes(get_config(a))]
IDS = [f"{a}-{s}" for a, s in CELLS]


def _dtype_name(dt) -> str:
    if isinstance(dt, torch.dtype):
        return str(dt).removeprefix("torch.")
    return str(np.dtype(dt))


def _same_spec(got: torch.Tensor, want, what):
    assert got.device.type == "meta", what
    assert tuple(got.shape) == tuple(want.shape), (what, got.shape,
                                                   want.shape)
    assert _dtype_name(got.dtype) == _dtype_name(want.dtype), (
        what, got.dtype, want.dtype)


def test_all_32_cells():
    assert len(CELLS) == 32


@pytest.mark.parametrize("arch,shape", CELLS, ids=IDS)
def test_input_specs_match_jax(arch, shape):
    got = input_specs(get_config(arch), SHAPES[shape])
    want = j_input_specs(j_get_config(arch), J_SHAPES[shape])
    assert list(got) == list(want)
    for name, (sds, _axes) in want.items():
        _same_spec(got[name], sds, f"{arch} {shape} {name}")


@pytest.mark.parametrize("arch,shape", CELLS, ids=IDS)
def test_decode_state_shapes_match_jax(arch, shape):
    """Leaf by leaf, as ``tests/_torch_lm.py::states_close`` pairs the
    decode states, at the cell's global batch and length."""
    s = SHAPES[shape]
    got = decode_state_shapes(get_config(arch), s.global_batch, s.seq_len)
    want = j_state_shapes(j_get_config(arch), s.global_batch, s.seq_len)
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k in want:
        _same_spec(got[k], want[k], f"{arch} {shape} {k}")


def test_meta_model_allocates_nothing_and_takes_a_cpu_generator():
    """qwen3-14b's full tree on meta from a CPU generator (meta has no
    generator of its own), with the parameter count of its config."""
    from repro_torch.models.model import build_model
    from repro_torch.train.optimizer import tree_leaves

    cfg = get_config("qwen3-14b")
    model = build_model(cfg, device="meta")
    assert model.device.type == "meta"
    leaves = tree_leaves(model.init(torch.Generator().manual_seed(0)))
    assert all(t.device.type == "meta" for t in leaves)
    assert sum(t.numel() for t in leaves) > 0.99 * cfg.param_count()


# ------------------------------------------------------------ the counter
def _small(name, seq):
    return dataclasses.replace(SHAPES[name], seq_len=seq)


def _matmul_elems(cfg) -> int:
    """Elements of every weight a token's forward multiplies by, in the
    dense family (q, k, v, o and the gated MLP)."""
    a = cfg.attn
    per = cfg.d_model * (2 * a.n_heads + 2 * a.kv_heads) * a.head_dim
    return cfg.n_layers * (per + 3 * cfg.d_model * cfg.d_ff)


def _attn_pair_flops(cfg, b, l) -> int:
    """The chunk pairs' two einsums a layer (every pair, masked ones
    included: the port computes them all)."""
    a = cfg.attn
    return cfg.n_layers * 2 * 2 * b * a.n_heads * l * l * a.head_dim


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_meta_count_equals_a_real_cpu_run(kind):
    """internlm2's smoke config has no kernel route in these steps: the
    counter's FLOPs, bytes, exponentials and peak on meta equal its count
    of the same step on real CPU tensors."""
    cfg = get_config("internlm2-1.8b", smoke=True)
    shape = _small("train_4k" if kind == "train" else "prefill_32k", 256)
    meta = dryrun.count_step("internlm2-1.8b", cfg, shape, 2)
    cpu = dryrun.count_step("internlm2-1.8b", cfg, shape, 2, device="cpu")
    assert meta == cpu
    assert meta["peak_bytes"] > meta["argument_bytes"] > 0


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_matmul_flops_are_analytic(kind):
    """2 x tokens x matmul weight elements plus the chunk pairs'
    attention, exactly; the prefill's logits at the last position only;
    training three times the layers' forward (forward, two backward
    products) and four times the loss's unembedding (forward, its
    recompute in the backward, two backward products)."""
    cfg = get_config("internlm2-1.8b", smoke=True)
    b, l = 2, 256
    shape = _small("train_4k" if kind == "train" else "prefill_32k", l)
    got = dryrun.count_step("internlm2-1.8b", cfg, shape, b)
    fwd = 2 * b * l * _matmul_elems(cfg) + _attn_pair_flops(cfg, b, l)
    unembed = 2 * cfg.vocab * cfg.d_model
    want = (3 * fwd + 4 * b * l * unembed if kind == "train"
            else fwd + b * unembed)
    assert got["flops_f32"] == want
    assert got["flops_bf16"] == got["flops_tf32"] == 0


def test_bf16_products_and_f32_attention_split():
    """At bf16 the projections, MLPs and logits count against the tensor
    cores' peak and the f32 chunked attention against FP32's."""
    cfg = dataclasses.replace(get_config("internlm2-1.8b", smoke=True),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    b, l = 2, 256
    got = dryrun.count_step("internlm2-1.8b", cfg, _small("prefill_32k", l),
                            b)
    assert got["flops_bf16"] == (2 * b * l * _matmul_elems(cfg)
                                 + 2 * b * cfg.vocab * cfg.d_model)
    assert got["flops_f32"] == _attn_pair_flops(cfg, b, l)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf = dryrun.count_step("internlm2-1.8b", cfg,
                               _small("prefill_32k", l), b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert tf["flops_tf32"] == got["flops_f32"] and tf["flops_f32"] == 0


EXTRAPOLATED = [("internlm2-1.8b", "train_4k"), ("granite-moe-1b-a400m",
                                                 "prefill_32k"),
                ("falcon-mamba-7b", "prefill_32k"), ("zamba2-2.7b",
                                                     "decode_32k"),
                ("llama-3.2-vision-11b", "decode_32k"),
                ("whisper-medium", "train_4k")]


@pytest.mark.parametrize("arch,shape", EXTRAPOLATED,
                         ids=[f"{a}-{s}" for a, s in EXTRAPOLATED])
def test_depth_extrapolation_equals_a_direct_count(arch, shape,
                                                   monkeypatch):
    """Serving counts at (u, 2u) fitted affine in depth give a direct 3u
    count; training's at (u, 2u, 3u) fitted quadratic give a direct 4u
    count: FLOPs, bytes, exponentials and kernel work exactly, the peak
    within 4 KiB (which small transient is live at the peak moment
    moves with depth)."""
    monkeypatch.setitem(SHAPES, shape, _small(shape, 128))
    cfg = get_config(arch, smoke=True)
    u, _ = probe_depths(cfg)
    prb = dryrun.probe_cell(arch, shape, cfg, 2)
    train = SHAPES[shape].kind == "train"
    assert prb["depths"] == ([u, 2 * u, 3 * u] if train else [u, 2 * u])
    at = (4 if train else 3) * u
    got = corrected_totals({"n_layers": at}, prb)
    want = dryrun.count_step(arch, probe_config(cfg, at), SHAPES[shape], 2)
    assert set(want) <= set(got)
    for k, v in want.items():
        tol = 4096 if k == "peak_bytes" else 1e-6
        assert got[k] == pytest.approx(v, rel=1e-12, abs=tol), k


def test_training_bytes_grow_as_depth_squared(monkeypatch):
    """Why training takes a third probe depth: the backward of each
    layer's slice of a stacked leaf writes a whole-stack gradient, so an
    affine fit at (u, 2u) undercounts a direct 3u count's bytes (its
    FLOPs stay affine)."""
    monkeypatch.setitem(SHAPES, "train_4k", _small("train_4k", 128))
    cfg = get_config("internlm2-1.8b", smoke=True)
    rows = [dryrun.count_step("internlm2-1.8b", probe_config(cfg, n),
                              SHAPES["train_4k"], 2) for n in (1, 2, 3)]
    second = {k: rows[2][k] - 2 * rows[1][k] + rows[0][k]
              for k in ("flops_f32", "bytes")}
    assert second["flops_f32"] == 0 and second["bytes"] > 0


# ------------------------------------------------ the kernels' meta branch
def _decode_args(dev, b=3, h=8, kh=2, s=40, d=16, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(1)
    q = torch.randn(b, h, d, generator=g)
    k = torch.randn(b, s, kh, d, generator=g).to(dtype)
    v = torch.randn(b, s, kh, d, generator=g).to(dtype)
    n = torch.tensor([0, 7, s][:b], dtype=torch.int32)
    return tuple(t.to(dev) for t in (q, k, v, n))


def _scan_args(dev, b=2, l=24, di=12, n=4):
    g = torch.Generator().manual_seed(2)
    mk = lambda *s: torch.rand(*s, generator=g)  # noqa: E731
    return tuple(t.to(dev) for t in (mk(b, l, di) * 0.1, mk(b, l, di),
                                     mk(b, l, n), mk(b, l, n), mk(di, n)))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_decode_meta_counts_its_work_function(dtype):
    q, k, v, n = _decode_args("meta", dtype=dtype)
    before = fd_mod.flash_decode.launches
    with WorkCounter() as wc:
        o = fd_mod.flash_decode(q, k, v, n)
        o2 = fd_mod.flash_decode(q, k, v, n)
    assert o.device.type == "meta" and o.dtype == torch.float32
    assert tuple(o.shape) == (3, 8, 16) and o2.shape == o.shape
    assert fd_mod.flash_decode.launches == before
    want = fd_mod.decode_work(3, 8, 2, 40, 16, k.element_size())
    assert want["bytes"] == (3 * 40 * 2 * 16 * k.element_size() * 2
                             + 2 * 3 * 8 * 16 * 4)
    assert want["flops_f32"] == 4 * 3 * 8 * 40 * 16
    row = wc.kernels["flash_decode"]
    assert row["calls"] == 2
    assert {key: row[key] for key in want} == {key: 2 * x for key, x
                                               in want.items()}
    res = wc.result()
    assert res["flops_f32"] == 2 * want["flops_f32"]
    assert res["exps"] == 2 * want["exps"]


def test_mamba_scan_meta_counts_its_work_function():
    args = _scan_args("meta")
    before = ms_mod.mamba_scan.launches
    with WorkCounter() as wc:
        y = ms_mod.mamba_scan(*args)
    assert y.device.type == "meta" and tuple(y.shape) == (2, 24, 12)
    assert y.dtype == torch.float32
    assert ms_mod.mamba_scan.launches == before
    want = ms_mod.scan_work(2, 24, 12, 4)
    assert want == {"bytes": 4 * (3 * 2 * 24 * 12 + 2 * 2 * 24 * 4 + 48),
                    "exps": 2 * 24 * 12 * 4,
                    "flops_f32": 6 * 2 * 24 * 12 * 4}
    assert dict(wc.kernels["mamba_scan"]) == {"calls": 1, **want}


@pytest.mark.parametrize("kernel", ["flash_decode", "mamba_scan"])
def test_cpu_tensors_never_take_the_meta_branch(kernel):
    """On CPU tensors each wrapper runs its plain version (no kernel work
    counted, the plain version's value), under a counter or not."""
    if kernel == "flash_decode":
        args, fn, plain = (_decode_args("cpu"), fd_mod.flash_decode,
                           fd_mod.flash_decode_plain)
    else:
        args, fn, plain = (_scan_args("cpu"), ms_mod.mamba_scan,
                           ms_mod.mamba_scan_plain)
    with WorkCounter() as wc:
        got = fn(*args)
    assert not wc.kernels and wc.result()["ops"] > 0
    assert torch.equal(got, plain(*args))


def test_meta_branch_checks_its_inputs():
    q, k, v, n = _decode_args("meta")
    with pytest.raises(ValueError):
        fd_mod.flash_decode(q, k, v, n[:2])
    args = _scan_args("meta")
    with pytest.raises(ValueError):
        ms_mod.mamba_scan(args[0], args[1], args[2], args[3], args[4][:3])


# ---------------------------------------------------------- dryrun_cell
FAMILY_CELLS = [("internlm2-1.8b", "train_4k"),        # dense
                ("granite-moe-1b-a400m", "decode_32k"),  # moe
                ("falcon-mamba-7b", "prefill_32k"),      # ssm (scan kernel)
                ("zamba2-2.7b", "long_500k"),            # hybrid
                ("llama-3.2-vision-11b", "decode_32k"),  # vlm
                ("whisper-medium", "decode_32k")]        # encdec


@pytest.fixture(scope="module")
def family_artifacts(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    arts = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(SHAPES, "train_4k", _small("train_4k", 512))
        for arch, shape in FAMILY_CELLS:
            arts[arch] = dryrun.dryrun_cell(
                arch, shape, batch=2, cfg=get_config(arch, smoke=True),
                out_dir=str(out))
    return out, arts


@pytest.mark.parametrize("arch,shape", FAMILY_CELLS,
                         ids=[a for a, _ in FAMILY_CELLS])
def test_dryrun_cell_each_family(arch, shape, family_artifacts):
    out, arts = family_artifacts
    art = arts[arch]
    with open(out / f"{arch}__{shape}.json") as f:
        assert json.load(f) == json.loads(json.dumps(art))
    c = art["counts"]
    assert art["batch"] == 2 and art["cards"] == SHAPES[shape].global_batch / 2
    assert art["fits"] and 0 < c["argument_bytes"] <= c["peak_bytes"]
    assert c["bytes"] > 0 and sum(v for k, v in c.items()
                                  if k.startswith("flops_")) > 0
    assert np.all(np.isfinite([v for v in c.values()]))
    if arch == "falcon-mamba-7b":     # the scan kernel, once a layer
        assert c["mamba_scan.calls"] == art["n_layers"]
    if shape.startswith(("decode", "long")) and arch != "falcon-mamba-7b":
        assert c["flash_decode.calls"] > 0


def test_report_renders_from_artifacts(family_artifacts):
    out, arts = family_artifacts
    dt = report.dryrun_table(str(out)).splitlines()
    rt = report.roofline_table(str(out)).splitlines()
    assert len(dt) == len(rt) == 2 + len(FAMILY_CELLS)
    for arch, shape in FAMILY_CELLS:
        assert any(f"| {arch} | {shape} |" in line for line in dt)
        assert any(f"| {arch} | {shape} |" in line for line in rt)
    assert "fits 80G" in dt[0] and "roofline frac" in rt[0]


def test_batch_search_takes_the_largest_power_of_two_that_fits(
        monkeypatch):
    """With the card's bytes cut to what 5 rows need, the search over an
    affine peak takes 4 rows (8 would not fit), and its record shows the
    two probe batches and the confirming count."""
    cfg = get_config("falcon-mamba-7b", smoke=True)
    cell = ("falcon-mamba-7b", "decode_32k")
    p1 = corrected_totals({"n_layers": cfg.n_layers},
                          dryrun.probe_cell(*cell, cfg, 1))["peak_bytes"]
    p2 = corrected_totals({"n_layers": cfg.n_layers},
                          dryrun.probe_cell(*cell, cfg, 2))["peak_bytes"]
    monkeypatch.setattr(dryrun, "HBM_BYTES", p1 + 4.5 * (p2 - p1))
    art = dryrun.dryrun_cell(*cell, cfg=cfg, save=False)
    assert art["batch"] == 4 and art["fits"] and art["cards"] == 32
    assert art["batch_search"]["affine"]["batches"] == [1, 2]
    assert set(art["batch_search"]["probed"]) == {"1", "2", "4"}
    monkeypatch.setattr(dryrun, "HBM_BYTES", p1 / 2)
    art = dryrun.dryrun_cell(*cell, cfg=cfg, save=False)
    assert art["batch"] == 1 and not art["fits"]


def test_cli_counts_a_cell(tmp_path, capsys):
    dryrun.main(["--arch", "falcon-mamba-7b", "--shape", "decode_32k",
                 "--batch", "8", "--out-dir", str(tmp_path)])
    assert (tmp_path / "falcon-mamba-7b__decode_32k.json").exists()
    report.main(["dryrun", "--dir", str(tmp_path)])
    assert "| falcon-mamba-7b | decode_32k | 8 | 16 |" in capsys.readouterr().out


# ------------------------------------------------ vlm and encdec on a mesh
MESH_DECODE = ["llama-3.2-vision-11b", "whisper-medium"]


@pytest.fixture
def fake_mesh():
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh_shape

    yield lambda shape: make_mesh_shape(shape, ("data", "model"), "meta",
                                        fake=True)
    if dist.is_initialized():
        dist.destroy_process_group()


def _mesh_decode(arch, mesh, cfg=None, rows=2, seq=64):
    cfg = cfg or get_config(arch, smoke=True)
    shape = dataclasses.replace(SHAPES["decode_32k"], seq_len=seq)
    return cfg, dryrun.count_step(arch, cfg, shape, rows, mesh=mesh)


def _leaf_bytes(params, shardings, where):
    """{path: the rank's block's bytes} of the leaves ``where(path,
    spec)`` keeps."""
    from repro_torch.train.checkpoint import tree_flatten

    sh = dict(tree_flatten(shardings))
    out = {}
    for p, x in tree_flatten(params):
        if where(p, tuple(sh[p].spec)):
            out[p] = (int(np.prod(sh[p].local_shape(x.shape)))
                      * x.element_size())
    return out


@pytest.mark.parametrize("arch", MESH_DECODE)
def test_mesh_decode_holds_its_cross_caches_and_stub_inputs(fake_mesh,
                                                            arch):
    """One rank of a decode step on (2, 2): its arguments are its
    parameter blocks, its rows' self and cross caches over its kv heads
    (2 of the smoke config's 2 split over 2 ranks: one each), its
    ``cache_len`` and tokens, and its rows of the f32 ``patches`` or
    ``frames``, each counted from the config."""
    from repro_torch.models.model import build_model

    mesh = fake_mesh((2, 2))
    cfg, row = _mesh_decode(arch, mesh)
    a, rows, seq = cfg.attn, 2, 64
    model = build_model(cfg, device="meta", mesh=mesh)
    params = sum(_leaf_bytes(model.init(torch.Generator()),
                             model.plan.shardings,
                             lambda p, s: True).values())
    kvh = a.kv_heads // 2
    cache = 2 * cfg.n_layers * rows * seq * kvh * a.head_dim * 4
    if cfg.family == "vlm":
        n_cross, n = cfg.n_layers // cfg.cross_attn_every, cfg.n_patches
    else:
        n_cross, n = cfg.n_layers, cfg.enc_seq
    cross = 2 * n_cross * rows * n * kvh * a.head_dim * 4
    stub = rows * n * cfg.d_model * 4
    ints = 4 * rows + 4 * rows          # cache_len, tokens
    assert row["argument_bytes"] == params + cache + cross + stub + ints


@pytest.mark.parametrize("arch", MESH_DECODE)
def test_mesh_decode_gathers_each_fsdp_block_once_a_use(fake_mesh, arch):
    """A decode step on (2, 2) gathers every ``fsdp`` block it uses over
    ``data``, once a use: each gather of two blocks sends one, so the
    step's all-gather bytes over ``data`` are the bytes of the blocks it
    uses, whisper's tied embedding twice (the embedding and the logits),
    its encoder's none (the cross caches hold what it made)."""
    from repro_torch.models.model import build_model

    mesh = fake_mesh((2, 2))
    cfg, row = _mesh_decode(arch, mesh)
    model = build_model(cfg, device="meta", mesh=mesh)
    used = _leaf_bytes(model.init(torch.Generator()), model.plan.shardings,
                       lambda p, s: "data" in str(s)
                       and not p.startswith("enc_"))
    want = sum(used.values())
    if cfg.family == "encdec":
        want += used["embed"]
    assert row["coll.all-gather@data"] == want


def test_whisper_vocabulary_stays_whole_where_it_does_not_divide(
        fake_mesh):
    """whisper-medium's 51,865 tokens do not divide a model axis of 16:
    ``guarded_spec`` leaves the tied embedding's rows whole (its
    ``d_model`` over ``data``), and the plan computes the whole
    vocabulary on every rank.  At smoke width on (2, 2) the same holds
    for a vocabulary of 51,865 (an odd count): no logits are gathered
    over ``model``, where the smoke config's 512 gather (m - 1) / m of
    the rank's rows' f32 logits."""
    from repro_torch.models.transformer import mesh_plan

    plan = mesh_plan(get_config("whisper-medium"), fake_mesh((16, 16)))
    assert not plan.vocab and plan.heads
    assert tuple(plan.shardings["embed"].spec) == (None, "data")
    smoke = get_config("whisper-medium", smoke=True)
    odd = dataclasses.replace(smoke, vocab=51_865)
    _cfg, whole = _mesh_decode("whisper-medium", fake_mesh((2, 2)), odd)
    assert "coll.all-gather@model" not in whole
    _cfg, split = _mesh_decode("whisper-medium", fake_mesh((2, 2)), smoke)
    assert split["coll.all-gather@model"] == 0.5 * 2 * smoke.vocab * 4


def test_mesh_dryrun_counts_the_vlm_and_encdec_cells(fake_mesh, capsys):
    """``dryrun_cell`` on a mesh counts the vlm and encdec cells, and
    each artifact records what splits over ``model``."""
    mesh = fake_mesh((2, 2))
    for arch in MESH_DECODE:
        art = dryrun.dryrun_cell(
            arch, "decode_32k", batch=2, cfg=get_config(arch, smoke=True),
            mesh=mesh, save=False)
        assert art["head_split"] and not art["rows_split"]
        assert art["collective_bytes"]["total"] > 0
        assert f"[dryrun] {arch} decode_32k mesh 2x2 (heads split" \
            in capsys.readouterr().out
