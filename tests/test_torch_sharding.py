"""The port's logical-axis sharding against the JAX package's, and the
mesh dry run's counts (CPU, no spawn).

``logical_to_spec`` and ``guarded_spec`` are held to JAX's on the fake
meshes of ``tests/test_sharding.py`` and on the (16, 16), (2, 16, 16),
(2, 2, 2) and (4, 2) meshes; every architecture's ``param_specs`` and
``decode_state_specs`` to the JAX trees leaf for leaf, and each leaf's
``guarded_spec`` on its real shape (the JAX shapes from
``jax.eval_shape``) to JAX's on those meshes.  The mesh dry run counts
one rank under a fake process group: on a (1, 1) mesh its counts are
the meshless count's (for the moe, ssm and hybrid families too), and on
(2, 2, 2) internlm2-1.8b's ``train_4k`` at smoke size sends collective
bytes and holds exactly its local shards' bytes as arguments; the moe,
ssm and hybrid steps there gather the expert counts and send
all-to-all, each rank holding its shards.  The all-to-all's byte rule is
``repro.utils.hlo``'s, and under a fake process group the MoE slots read
from the gathered counts stay in range.  A rank's training rows are its
block of each JAX microbatch, and ``batch_tp`` lays the Mamba rows over
``model`` with ``d_inner`` whole.  The vlm and encdec families and the
``batch_tp`` configs count on (1, 1) as without a mesh and on (2, 2, 2)
hold exactly their shards, rows and stub inputs.  (JAX's own mesh dry run,
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
    # a vlm cell counts on the same mesh, its artifact beside the other
    vlm = dryrun_cell("llama-3.2-vision-11b", "decode_32k", mesh=mesh,
                      out_dir=str(tmp_path),
                      cfg=get_config("llama-3.2-vision-11b", smoke=True))
    assert vlm["head_split"] and vlm["collective_bytes"]["total"] > 0
    assert analyze_artifact(vlm)["mesh"] == "4x2"
    assert any(r.startswith("| llama-3.2-vision-11b | decode_32k |")
               and r.endswith("| 4x2 |")
               for r in report.dryrun_table(str(tmp_path)).splitlines())


# ------------------------------------------------- moe, ssm and hybrid
FAMILY_ARCHS = ("granite-moe-1b-a400m", "falcon-mamba-7b", "zamba2-2.7b")
# the vlm and encdec families and a batch_tp config (built with
# dataclasses.replace: no architecture sets it)
EXTRA_ARCHS = ("llama-3.2-vision-11b", "whisper-medium", "falcon-mamba-7b")
W_ROWS = 4


def _extra_cfg(arch):
    return (_batch_tp(arch) if arch == "falcon-mamba-7b"
            else get_config(arch, smoke=True))


@pytest.mark.parametrize("arch,shape_name", itertools.product(
    FAMILY_ARCHS, ["train_4k", "prefill_32k", "decode_32k"]))
def test_mesh_dryrun_on_1x1_equals_the_meshless_count_families(
        fake_mesh, arch, shape_name):
    cfg = get_config(arch, smoke=True)
    shape = dataclasses.replace(SHAPES[shape_name], seq_len=256)
    plain = count_step(arch, cfg, shape, 2)
    mesh = fake_mesh((1, 1), ("data", "model"))
    assert count_step(arch, cfg, shape, 2, mesh=mesh) == plain


@pytest.mark.parametrize("arch", FAMILY_ARCHS + ("arctic-480b",))
def test_mesh_dryrun_on_2x2x2_families_send_and_hold_their_shards(
        fake_mesh, arch):
    """One rank of a smoke-size ``train_4k`` step on (2, 2, 2): an MoE
    gathers its expert counts over the batch axes and sums its experts'
    outputs over ``model``; a Mamba layer sends all-to-all over
    ``model``; the arguments are exactly the rank's shards and rows."""
    from repro_torch.models.transformer import mesh_plan

    cfg = get_config(arch, smoke=True)
    mesh = fake_mesh((2, 2, 2), ("pod", "data", "model"))
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=256)
    rows = shape.global_batch // 4
    row = count_step(arch, cfg, shape, rows, mesh=mesh)
    plan = mesh_plan(cfg, mesh)
    kinds = ["all-gather@data", "reduce-scatter@data", "all-reduce@pod",
             "all-reduce@model"]
    if cfg.moe is not None:
        assert plan.experts
        kinds.append("all-gather@pod")   # the counts' gather
    if cfg.ssm is not None:
        assert plan.ssm
        kinds.append("all-to-all@model")
    for kind in kinds:
        assert row[f"coll.{kind}"] > 0, kind
    from repro_torch.launch.dryrun import train_config
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.train.train_step import (init_train_state,
                                              state_sharding)

    # the whole state (AdamW, or arctic's Adafactor), each leaf's block
    model = build_model(cfg, device="meta", mesh=mesh)
    state = init_train_state(model, torch.Generator(),
                             train_config(arch, rows))
    sh = state_sharding(model, state)
    held = sum(int(np.prod(s.local_shape(x.shape))) * x.element_size()
               for x, s in zip(tree_leaves(state), tree_leaves(sh)))
    inputs = 2 * rows * shape.seq_len * 4
    assert row["argument_bytes"] == held + inputs


@pytest.mark.parametrize("arch,shape_name", itertools.product(
    EXTRA_ARCHS, ["train_4k", "prefill_32k", "decode_32k"]))
def test_mesh_dryrun_on_1x1_equals_the_meshless_count_vlm_encdec(
        fake_mesh, arch, shape_name):
    cfg = _extra_cfg(arch)
    shape = dataclasses.replace(SHAPES[shape_name], seq_len=256)
    plain = count_step(arch, cfg, shape, 2)
    mesh = fake_mesh((1, 1), ("data", "model"))
    assert count_step(arch, cfg, shape, 2, mesh=mesh) == plain


@pytest.mark.parametrize("arch", EXTRA_ARCHS)
def test_mesh_dryrun_on_2x2x2_vlm_encdec_hold_their_shards(fake_mesh,
                                                           arch):
    """One rank of a smoke-size ``train_4k`` step on (2, 2, 2): the
    vlm's and encdec's heads split over ``model`` (their activations'
    partial sums summed there), a ``batch_tp`` Mamba layer gathers its
    rows over ``model``; the arguments are exactly the rank's shards,
    its rows of tokens and targets, and its rows of the f32 stub
    inputs."""
    from repro_torch.launch.dryrun import train_config
    from repro_torch.models.model import input_specs
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.train.train_step import (init_train_state,
                                              state_sharding)

    cfg = _extra_cfg(arch)
    mesh = fake_mesh((2, 2, 2), ("pod", "data", "model"))
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=256)
    rows = shape.global_batch // 4
    row = count_step(arch, cfg, shape, rows, mesh=mesh)
    model = build_model(cfg, device="meta", mesh=mesh)
    kinds = ["all-gather@data", "reduce-scatter@data", "all-reduce@pod",
             "all-reduce@model"]
    if cfg.ssm is not None:
        assert model.plan.rows
        kinds.append("all-gather@model")
    else:
        assert model.plan.heads
    for kind in kinds:
        assert row[f"coll.{kind}"] > 0, kind
    state = init_train_state(model, torch.Generator(),
                             train_config(arch, rows))
    sh = state_sharding(model, state)
    held = sum(int(np.prod(s.local_shape(x.shape))) * x.element_size()
               for x, s in zip(tree_leaves(state), tree_leaves(sh)))
    ins = input_specs(cfg, dataclasses.replace(shape, global_batch=rows))
    inputs = sum(x.numel() * x.element_size() for x in ins.values())
    assert inputs > 2 * rows * shape.seq_len * 4 or cfg.ssm is not None
    assert row["argument_bytes"] == held + inputs


def test_all_to_all_bytes_follow_the_hlo_rule(fake_mesh):
    """The count of an even ``exchange`` (an all-to-all) over a 4-rank
    axis equals ``repro.utils.hlo.collective_bytes`` of the same op:
    ``(S-1)/S`` of its result."""
    from repro.utils.hlo import collective_bytes
    from repro_torch.dist import tensor_parallel as tp

    mesh = fake_mesh((2, 4), ("data", "model"))
    x = torch.empty((8, 6, 16), dtype=torch.bfloat16, device="meta")
    tp.collective_counts(reset=True)
    y = tp.exchange(x, 0, [2] * 4, [2] * 4, mesh, "model")
    assert tuple(y.shape) == (8, 6, 16)
    got = tp.collective_counts(reset=True)
    hlo = ("%a = bf16[8,6,16]{2,1,0} all-to-all(bf16[8,6,16]{2,1,0} %x), "
           "replica_groups=[2,4]<=[8], dimensions={0}")
    want = collective_bytes(hlo)
    assert got["all-to-all"] == want["all-to-all"] == 0.75 * 8 * 6 * 16 * 2
    assert got["all-to-all@model"] == got["all-to-all"]
    assert got["n_all-to-all"] == want["n_all-to-all"] == 1


def test_exchange_gradient_sends_the_pieces_back(fake_mesh):
    """An uneven ``exchange``'s backward is the exchange with ``send``
    and ``recv`` swapped: the gradient has the input's shape, and each
    direction counts the rows it sends to the other ranks."""
    from repro_torch.dist import tensor_parallel as tp

    mesh = fake_mesh((1, 2), ("data", "model"))
    x = torch.empty((4, 3), device="meta", requires_grad=True)
    tp.collective_counts(reset=True)
    y = tp.exchange(x, 0, [1, 3], [1, 2], mesh, "model")
    assert tuple(y.shape) == (3, 3)
    assert tp.collective_counts()["all-to-all"] == 3 * 3 * 4
    y.sum().backward()
    assert tuple(x.grad.shape) == (4, 3)
    got = tp.collective_counts(reset=True)
    assert got["n_all-to-all"] == 2
    assert got["all-to-all"] == (3 + 2) * 3 * 4


def test_fake_group_gather_yields_in_range_slots():
    """Under a fake process group nothing moves, and a receive buffer
    may hold whatever it held: the expert counts an MoE rank gathers
    come into a zero-filled buffer, so the slots it reads from them
    stay within its dispatch buffer; an even exchange keeps its
    shape."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.dist import tensor_parallel as tp
    from repro_torch.models import moe as moe_mod

    mesh = make_mesh_shape((4, 2), ("data", "model"), "cpu", fake=True)
    try:
        x = torch.arange(24, dtype=torch.int64).reshape(4, 6)
        assert tuple(tp.exchange(x, 0, [2, 2], [2, 2], mesh,
                                 "model").shape) == (4, 6)
        got = tp.all_gather(torch.full((1, 4), 7.0), mesh, "data", 0,
                            zeros=True)
        assert tuple(got.shape) == (4, 4)
        assert bool(((got == 0) | (got == 7)).all())
        m = MoEConfig(n_experts=4, top_k=2, d_ff_expert=8,
                      capacity_factor=1.0, token_chunk=64)
        g = torch.Generator().manual_seed(0)
        p = {"router": torch.randn((16, 4), generator=g)}
        xc = torch.randn((8, 16), generator=g)
        ctx = moe_mod.moe_mesh(mesh, True, ("data",))
        top_w, top_e, slot, keep, cap, aux = moe_mod.route(xc, p, m, ctx)
        assert cap == 16     # the global chunk: 4 ranks of 8 tokens
        assert bool(((slot >= 0) & (slot <= cap)).all())
        assert bool((keep == (slot < cap)).all())
        w = {"router": p["router"],
             "we_gate": torch.randn((2, 16, 8), generator=g),
             "we_up": torch.randn((2, 16, 8), generator=g),
             "we_down": torch.randn((2, 8, 16), generator=g)}
        y, _aux = moe_mod.moe_block(xc[None], w, m, ctx)
        assert tuple(y.shape) == (1, 8, 16)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("m", [2, 3, 4, 8, 16])
def test_mamba_pair_plan_gives_each_rank_its_channels(m):
    """``ssm.pair_plan``'s exchange, simulated over every rank of a
    ``model`` axis of m: rank j stores flat columns ``[j 2di/m, (j+1)
    2di/m)`` of ``x @ w_in``; after the exchange rank r holds its
    channels of ``xi`` and then of ``z``, block r of each."""
    from repro_torch.models.ssm import pair_plan

    di = 6 * m
    sub = di // m
    flat = np.arange(2 * di)                     # xi's di, then z's
    store = [flat[j * 2 * sub:(j + 1) * 2 * sub] for j in range(m)]
    sent = []                                    # sent[j][d]: j -> d
    for j in range(m):
        swap, send, _recv = pair_plan(m, j)
        x = store[j]
        if swap:
            x = np.concatenate([x[sub:], x[:sub]])
        cuts = np.cumsum([0] + [n * sub for n in send])
        sent.append([x[cuts[d]:cuts[d + 1]] for d in range(m)])
    for r in range(m):
        _swap, _send, recv = pair_plan(m, r)
        got = np.concatenate([sent[i][r] for i in range(m)])
        assert [len(sent[i][r]) for i in range(m)] == [n * sub
                                                       for n in recv]
        want = np.concatenate([flat[r * sub:(r + 1) * sub],
                               flat[di + r * sub:di + (r + 1) * sub]])
        assert np.array_equal(got, want), (m, r)


class _GridMesh:
    """The axes and one rank's coordinate of a mesh, all ``rank_rows``
    reads (no process group)."""

    def __init__(self, shape, names, coord):
        self.shape, self.mesh_dim_names, self.coord = shape, names, coord

    def size(self, i):
        return self.shape[i]

    def get_coordinate(self):
        return list(self.coord)


@pytest.mark.parametrize("shape,names,n,m", [
    ((2, 2), ("data", "model"), 8, 1),
    ((2, 2), ("data", "model"), 8, 2),
    ((2, 4, 1), ("pod", "data", "model"), 32, 4),
    ((1, 2), ("data", "model"), 6, 3),
])
def test_rank_rows_give_each_rank_its_block_of_each_microbatch(shape, names,
                                                               n, m):
    """The rows a rank trains on, cut by the step into ``m`` slices:
    slice i of data rank r is block r of the JAX step's global
    microbatch i (``x.reshape((m, n/m, ...))[i]``), so the data ranks'
    slices i together are that microbatch in order; every model rank of
    a data rank has the same rows, and one microbatch is the contiguous
    block."""
    from repro_torch.train.train_step import rank_rows

    jax_micro = np.arange(n).reshape(m, n // m)
    dp = int(np.prod([s for s, a in zip(shape, names) if a != "model"]))
    got = {}
    for coord in itertools.product(*(range(s) for s in shape)):
        rows = rank_rows(n, _GridMesh(shape, names, coord), m)
        assert rows.shape == (n // dp,)
        key = tuple(c for c, a in zip(coord, names) if a != "model")
        assert np.array_equal(got.setdefault(key, rows), rows)
    ranks = [got[k] for k in sorted(got)]
    for i in range(m):
        whole = np.concatenate([r.reshape(m, -1)[i] for r in ranks])
        assert np.array_equal(whole, jax_micro[i])
    if m == 1:
        assert np.array_equal(np.concatenate(ranks), np.arange(n))
    assert np.array_equal(rank_rows(n, None, m), np.arange(n))


def _batch_tp(arch):
    cfg = get_config(arch, smoke=True)
    return dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                            batch_tp=True))


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-2.7b"])
def test_batch_tp_lays_mamba_rows_over_model(fake_mesh, arch):
    """``batch_tp`` (the JAX ``"batch_model"`` rows) on a fake (2, 2)
    mesh: no Mamba weight splits over ``model`` (``d_inner`` whole, the
    ``fsdp`` rows over ``data``), the plan puts the rows over ``model``
    instead of ``d_inner``, and a prefill's Mamba layers gather each
    rank's block of rows over ``model`` (a data rank's 2 rows, one a
    rank: (m - 1) / m of the layer's whole output) and send no
    all-to-all; the decode state keeps ``d_inner`` over ``model``.  On a
    model axis of 1 nothing splits."""
    from repro_torch.models.transformer import mesh_plan, state_sharding

    cfg = _batch_tp(arch)
    mesh = fake_mesh((2, 2), ("data", "model"))
    plan = mesh_plan(cfg, mesh)
    assert plan.rows and not plan.ssm
    for k, s in plan.layer["ssm"].items():
        assert "model" not in s.spec, (k, s.spec)
    assert tuple(plan.layer["ssm"]["w_in"].spec) == ("data", None)
    st = state_sharding(cfg, mesh, W_ROWS, 64)
    assert tuple(st["ssm_conv"].spec) == (None, "data", None, "model")
    shape = dataclasses.replace(SHAPES["prefill_32k"], seq_len=64)
    row = count_step(arch, cfg, shape, 2, mesh=mesh)
    assert "coll.all-to-all" not in row
    out = 2 * shape.seq_len * cfg.d_model * 4     # one layer's rows, f32
    assert row["coll.all-gather@model"] >= cfg.n_layers * out / 2
    dist.destroy_process_group()
    one = mesh_plan(cfg, fake_mesh((2, 1), ("data", "model")))
    assert not one.rows and not one.ssm
