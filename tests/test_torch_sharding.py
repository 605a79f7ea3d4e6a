"""The port's logical-axis sharding against the JAX package's, and the
mesh dry run's counts (CPU, no spawn).

``logical_to_spec`` and ``guarded_spec`` are held to JAX's on the fake
meshes of ``tests/test_sharding.py`` and on the (16, 16), (2, 16, 16),
(2, 2, 2) and (4, 2) meshes; every architecture's ``param_specs`` and
``decode_state_specs`` to the JAX trees leaf for leaf, and each leaf's
``guarded_spec`` on its real shape (the JAX shapes from
``jax.eval_shape``) to JAX's on those meshes.  The mesh dry run counts
one rank under a fake process group: on a (1, 1) mesh its counts are
the meshless count's, and on (2, 2, 2) internlm2-1.8b's ``train_4k``
at smoke size sends collective bytes and holds exactly its local
shards' bytes as arguments.  (JAX's own mesh dry run,
``test_small_mesh_dryrun_subprocess``, fails on jax 0.9, so no count is
held to it.)"""

import dataclasses
import itertools

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import SHAPES as J_SHAPES
from repro.configs import arch_names
from repro.configs import get_config as j_get_config
from repro.dist import sharding as js
from repro.models.model import build_model as j_build_model
from repro.models.model import decode_state_shapes as j_state_shapes
from repro.models.model import input_specs as j_input_specs

from repro_torch.configs import SHAPES, get_config
from repro_torch.dist import sharding as ts
from repro_torch.launch.dryrun import count_step
from repro_torch.launch.mesh import make_mesh_shape
from repro_torch.models.model import (build_model, decode_state_shapes,
                                      input_axes)


class _FakeMesh:
    def __init__(self, shape):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


MESHES = {
    "4x2": _FakeMesh({"data": 4, "model": 2}),
    "2x4x2": _FakeMesh({"pod": 2, "data": 4, "model": 2}),
    "16x16": _FakeMesh({"data": 16, "model": 16}),
    "2x16x16": _FakeMesh({"pod": 2, "data": 16, "model": 16}),
    "2x2x2": _FakeMesh({"pod": 2, "data": 2, "model": 2}),
    "4x2_dm": _FakeMesh({"data": 4, "model": 2}),
}
NAMES = sorted(js.LOGICAL_RULES) + [None]


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _leaves(tree[k], f"{prefix}/{k}")
        return out
    return [(prefix, tree)]


def test_rule_tables_equal():
    assert ts.LOGICAL_RULES == js.LOGICAL_RULES


@pytest.mark.parametrize("mesh", list(MESHES))
def test_logical_to_spec_equals_jax(mesh):
    m = MESHES[mesh]
    for axes in itertools.product(NAMES, repeat=2):
        assert ts.logical_to_spec(axes, m) == tuple(
            js.logical_to_spec(axes, m)), axes


@pytest.mark.parametrize("mesh", list(MESHES))
def test_guarded_spec_equals_jax(mesh):
    m = MESHES[mesh]
    dims = (1, 2, 6, 7, 8, 16, 32, 40, 96, 256, 5120)
    for axes in itertools.product(NAMES, repeat=2):
        for shape in itertools.product(dims, repeat=2):
            assert ts.guarded_spec(shape, axes, m) == tuple(
                js.guarded_spec(shape, axes, m)), (shape, axes)


def test_the_jax_tests_fake_mesh_cases():
    """``tests/test_sharding.py``'s four cases, on the port."""
    m = _FakeMesh({"data": 4, "model": 2})
    assert ts.logical_to_spec(("batch", None, "mlp"), m) == (
        "data", None, "model")
    assert ts.logical_to_spec(("batch",), _FakeMesh(
        {"pod": 2, "data": 4, "model": 2}))[0] == ("pod", "data")
    spec = ts.guarded_spec((1, 8), ("batch", "mlp"), m)
    assert spec[0] is None and spec[1] == "model"
    spec2 = ts.guarded_spec((8, 7), ("batch", "mlp"), m)
    assert spec2[0] == "data" and spec2[1] is None
    used = [a for e in ts.logical_to_spec(("batch", "fsdp"), m)
            for a in ts.spec_axes(e)]
    assert len(used) == len(set(used))


def _jax_shapes(arch):
    jm = j_build_model(j_get_config(arch))
    return jm, jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))


@pytest.mark.parametrize("arch", arch_names())
def test_param_and_state_specs_equal_jax(arch):
    jm, jshapes = _jax_shapes(arch)
    tm = build_model(get_config(arch), device="meta")
    assert _leaves(tm.param_specs()) == _leaves(jm.param_specs())
    assert _leaves(tm.decode_state_specs()) == _leaves(
        jm.decode_state_specs())
    # every leaf's guarded spec on its shape, on every mesh
    tshapes = tm.init(torch.Generator())
    jl = dict(_leaves(jax.tree.map(lambda x: tuple(x.shape), jshapes)))
    tl = {p: tuple(x.shape) for p, x in _leaves(tshapes)}
    assert tl == jl
    specs = dict(_leaves(jm.param_specs()))
    shape = J_SHAPES["decode_32k"]
    jst = dict(_leaves(jax.tree.map(
        lambda x: tuple(x.shape),
        j_state_shapes(jm.cfg, shape.global_batch, shape.seq_len))))
    tst = {p: tuple(x.shape) for p, x in _leaves(decode_state_shapes(
        tm.cfg, shape.global_batch, shape.seq_len))}
    assert tst == jst
    for name, sh in J_SHAPES.items():
        want = {k: tuple(ax) for k, (_s, ax) in j_input_specs(
            jm.cfg, sh).items()}
        assert input_axes(tm.cfg, SHAPES[name]) == want, name
    sspecs = dict(_leaves(jm.decode_state_specs()))
    for m in MESHES.values():
        for p, axes in specs.items():
            assert ts.guarded_spec(tl[p], axes, m) == tuple(
                js.guarded_spec(jl[p], axes, m)), (p, m.shape)
        for p, axes in sspecs.items():
            assert ts.guarded_spec(tst[p], axes, m) == tuple(
                js.guarded_spec(jst[p], axes, m)), (p, m.shape)


@pytest.fixture
def fake_mesh():
    meshes = []

    def make(shape, axes):
        meshes.append(make_mesh_shape(shape, axes, "meta", fake=True))
        return meshes[-1]

    yield make
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k",
                                        "decode_32k"])
def test_mesh_dryrun_on_1x1_equals_the_meshless_count(fake_mesh,
                                                      shape_name):
    cfg = get_config("internlm2-1.8b", smoke=True)
    # a shorter sequence: the count's ops grow with it, not its bytes
    shape = dataclasses.replace(SHAPES[shape_name], seq_len=1024)
    batch = 2
    plain = count_step("internlm2-1.8b", cfg, shape, batch)
    mesh = fake_mesh((1, 1), ("data", "model"))
    meshed = count_step("internlm2-1.8b", cfg, shape, batch, mesh=mesh)
    assert meshed == plain


def _local_bytes(tree, sh):
    if isinstance(tree, dict):
        return sum(_local_bytes(tree[k], sh[k]) for k in tree)
    n = int(np.prod(sh.local_shape(tree.shape)))
    return n * tree.element_size()


def test_mesh_dryrun_on_2x2x2_sends_collectives_and_holds_its_shards(
        fake_mesh):
    """The mirror of ``tests/test_sharding.py``'s (2, 2, 2) leg: one
    rank of internlm2-1.8b's ``train_4k`` (smoke size) sends collective
    bytes, and its arguments are exactly its local shards (parameters,
    AdamW ``m`` and ``v`` placed as the parameters, two i32 steps) and
    its rows of tokens and targets."""
    from repro_torch.models.transformer import mesh_plan

    cfg = get_config("internlm2-1.8b", smoke=True)
    mesh = fake_mesh((2, 2, 2), ("pod", "data", "model"))
    shape = SHAPES["train_4k"]
    rows = shape.global_batch // 4
    row = count_step("internlm2-1.8b", cfg, shape, rows, mesh=mesh)
    assert row["coll.total"] > 0
    for kind in ("all-gather@data", "reduce-scatter@data",
                 "all-reduce@pod", "all-reduce@model"):
        assert row[f"coll.{kind}"] > 0, kind
    whole = build_model(cfg, device="meta").init(torch.Generator())
    sh = mesh_plan(cfg, mesh).shardings
    params = _local_bytes(whole, sh)
    f32 = {k: v.float() for k, v in _leaves(whole)}
    moments = 2 * sum(int(np.prod(s.local_shape(f32[p].shape))) * 4
                      for p, s in _leaves(sh))
    inputs = 2 * rows * shape.seq_len * 4
    assert row["argument_bytes"] == params + moments + 2 * 4 + inputs
    assert row["peak_bytes"] >= row["argument_bytes"]


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_restore_onto_a_mesh_reads_only_the_rank_block(fake_mesh, tmp_path,
                                                        opt):
    """A whole train state saved without a mesh, restored onto rank 0 of
    a (2, 4) mesh: each leaf is the rank's block of the saved one, bit
    for bit, and the bytes read out of the checkpoint are exactly those
    of the rank's blocks (far fewer than the whole state's)."""
    from repro_torch.dist.sharding import place
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import AdafactorConfig, AdamWConfig
    from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                              state_sharding)

    cfg = get_config("internlm2-1.8b", smoke=True)
    tcfg = TrainConfig(optimizer=AdamWConfig() if opt == "adamw"
                       else AdafactorConfig(min_dim_factored=64))
    whole = init_train_state(build_model(cfg, device="cpu"),
                             torch.Generator().manual_seed(3), tcfg)
    d = str(tmp_path / "ck")
    ckpt.save(d, 5, whole)
    mesh = fake_mesh((2, 4), ("data", "model"))
    sh = state_sharding(build_model(cfg, device="cpu", mesh=mesh), whole)
    want = place(whole, sh)
    n0 = ckpt.READ_BYTES["n"]
    step, got, _extra = ckpt.restore_latest(d, want, sh)
    read = ckpt.READ_BYTES["n"] - n0
    assert step == 5
    mine = [x for _p, x in ckpt.tree_flatten(want)]
    for a, b in zip(ckpt.tree_flatten(got), mine):
        assert torch.equal(a[1], b), a[0]
    total = sum(x.numel() * x.element_size()
                for _p, x in ckpt.tree_flatten(whole))
    assert read == sum(x.numel() * x.element_size() for x in mine)
    assert read < total / 2


def test_paged_kv_cache_keeps_its_kv_heads(fake_mesh):
    from repro_torch.serve.kv_cache import PagedKVCache, PagedKVConfig

    mesh = fake_mesh((2, 4), ("data", "model"))
    kw = dict(n_pages=4, page_size=8, n_layers=2, head_dim=16,
              dtype=torch.float32)
    split = PagedKVCache(PagedKVConfig(kv_heads=8, **kw), "cpu", mesh=mesh)
    assert tuple(split.k_pool.shape) == (2, 4, 8, 2, 16)
    whole = PagedKVCache(PagedKVConfig(kv_heads=2, **kw), "cpu", mesh=mesh)
    assert tuple(whole.k_pool.shape) == (2, 4, 8, 2, 16)   # 2 of 4: kept


def test_collective_seconds_by_link():
    """An axis inside an 8-card node runs on NVLink, one across nodes on
    the NIC; the roofline's collective term is each axis's bytes over
    its link, and the report shows the mesh and the bytes."""
    from repro_torch.utils import roofline as rl

    assert rl.link_bw({"data": 16, "model": 16}, "model") == rl.NIC_BW
    assert rl.link_bw({"data": 32, "model": 8}, "model") == rl.NVLINK_BW
    assert rl.link_bw({"data": 32, "model": 8}, "data") == rl.NIC_BW
    assert rl.link_bw({"data": 2, "model": 4}, "data") == rl.NVLINK_BW
    art = {"mesh": {"data": 32, "model": 8},
           "collective_bytes": {"all-gather@model": 9e9,
                                "all-reduce@data": 5e9, "total": 14e9,
                                "n_all-gather": 3.0}}
    want = 9e9 / rl.NVLINK_BW + 5e9 / rl.NIC_BW
    assert rl.collective_seconds(art) == pytest.approx(want)
    assert rl.collective_seconds({"collective_bytes": {}}) == 0.0


def test_mesh_artifact_through_the_roofline_and_report(fake_mesh, tmp_path):
    import json

    from repro_torch.launch.dryrun import dryrun_cell
    from repro_torch.utils import report
    from repro_torch.utils.roofline import analyze_artifact

    mesh = fake_mesh((4, 2), ("data", "model"))
    cfg = get_config("internlm2-1.8b", smoke=True)
    art = dryrun_cell("internlm2-1.8b", "decode_32k", cfg=cfg, mesh=mesh,
                      out_dir=str(tmp_path))
    assert art["batch"] == SHAPES["decode_32k"].global_batch // 4
    assert art["cards"] == 8 and art["mesh"] == {"data": 4, "model": 2}
    assert art["head_split"] and art["collective_bytes"]["total"] > 0
    with open(tmp_path / "internlm2-1.8b__decode_32k__4x2.json") as f:
        assert json.load(f)["mesh"] == {"data": 4, "model": 2}
    r = analyze_artifact(art)
    assert r["collective_s"] > 0 and r["mesh"] == "4x2"
    line = [r for r in report.dryrun_table(str(tmp_path)).splitlines()
            if r.startswith("| internlm2-1.8b | decode_32k |")][0]
    assert line.endswith("| 4x2 |")
    assert "collective ms" in report.roofline_table(str(tmp_path))
    with pytest.raises(ValueError, match="falcon-mamba-7b \\(ssm\\)"):
        dryrun_cell("falcon-mamba-7b", "decode_32k", mesh=mesh, save=False,
                    cfg=get_config("falcon-mamba-7b", smoke=True))
