"""Rank bodies of ``test_torch_dist.py``'s multi-process gloo legs (a
module of their own: the spawned ranks import it without JAX)."""

import os

import numpy as np
import torch
import torch.distributed as dist

# the inputs every rank derives from the same seeds
PSUM_SHAPE = (8, 64)
B, H, D, S = 2, 4, 16, 64           # flash-decode combine: KV of S split
M, MB, W = 4, 8, 16                 # pipeline: microbatches, rows, width


def psum_input(rank):
    return torch.from_numpy(np.random.default_rng(100 + rank).normal(
        size=PSUM_SHAPE).astype(np.float32))


def decode_inputs():
    rng = np.random.default_rng(5)
    return tuple(torch.from_numpy(rng.normal(size=s).astype(np.float32))
                 for s in ((B, H, D), (B, S, H, D), (B, S, H, D)))


def pipeline_inputs(n_stages):
    rng = np.random.default_rng(9)
    w = torch.from_numpy((rng.normal(size=(n_stages, W, W)) * 0.3)
                         .astype(np.float32))
    b = torch.from_numpy((rng.normal(size=(n_stages, W)) * 0.1)
                         .astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(M, MB, W)).astype(np.float32))
    return w, b, x


def stage_fn(p, h):
    wi, bi = p
    return torch.tanh(h @ wi + bi)


def run_rank(rank, world, init_file, out_dir):
    from repro_torch.dist.collectives import (compressed_psum,
                                              flash_decode_combine,
                                              static_axis_size)
    from repro_torch.dist.pipeline import pipeline_apply
    from repro_torch.launch.mesh import make_mesh_shape, make_production_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    out = {"size": static_axis_size()}
    out["psum"] = compressed_psum(psum_input(rank))
    q, k, v = decode_inputs()
    sl = slice(rank * S // world, (rank + 1) * S // world)
    s = torch.einsum("bhd,bshd->bhs", q, k[:, sl])
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    o = torch.einsum("bhs,bshd->bhd", p, v[:, sl])
    out["combine"] = flash_decode_combine(o, m, p.sum(-1))
    w, b, x = pipeline_inputs(world)
    out["pipe"] = pipeline_apply(stage_fn, (w[rank], b[rank]), x)
    mesh = make_mesh_shape((2, world // 2), ("data", "model"), "cpu")
    out["mesh"] = (tuple(mesh.shape), tuple(mesh.mesh_dim_names))
    errors = []
    for fn in (lambda: make_mesh_shape((world, 2), ("data", "model"), "cpu"),
               lambda: make_production_mesh(device_type="cpu")):
        try:
            fn()
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    out["mesh_errors"] = errors
    dist.barrier()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


# ------------------------------------------------------------------ the mesh
# ``test_torch_mesh.py``: a dense smoke model on a (2, 2) data x model
# mesh of 4 gloo ranks.  "divides": qwen3-14b's smoke config (4 heads, 2
# kv heads: a rank computes its own heads); "replicated": 1 kv head (the
# flat kv columns still split, half a head a rank, so every rank gathers
# them and computes every head).
MESH_ARCH = "qwen3-14b"
MESH_CASES = {"divides": 2, "replicated": 1}
MESH_ROWS, MESH_LEN, MESH_S = 4, 16, 16     # global rows, positions, cache
MESH_LR = 5e-3


def mesh_cfg(kv_heads, get_config):
    """The case's config (``get_config`` of either package)."""
    import dataclasses

    cfg = get_config(MESH_ARCH, smoke=True)
    return dataclasses.replace(cfg, attn=dataclasses.replace(
        cfg.attn, kv_heads=kv_heads))


def mesh_batch(cfg, seed=21):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab, (MESH_ROWS, MESH_LEN)).astype(np.int32),
            rng.integers(0, cfg.vocab, (MESH_ROWS, MESH_LEN)).astype(np.int32))


def mesh_decode_inputs(cfg, seed=22):
    """(k_cache, v_cache, cache_len, tokens) of one decode step: random
    caches of ``MESH_S`` positions, lengths before the step."""
    rng = np.random.default_rng(seed)
    a = cfg.attn
    shape = (cfg.n_layers, MESH_ROWS, MESH_S, a.kv_heads, a.head_dim)
    kc = rng.standard_normal(shape).astype(np.float32)
    vc = rng.standard_normal(shape).astype(np.float32)
    lens = np.array([5, 9, 12, 3], np.int32)
    toks = rng.integers(0, cfg.vocab, (MESH_ROWS, 1)).astype(np.int32)
    return kc, vc, lens, toks


def flat_params(tree, prefix=""):
    """{path: array} of a nested dict (either package's tree)."""
    out = {}
    for k in sorted(tree):
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(tree[k], dict):
            out.update(flat_params(tree[k], p))
        else:
            out[p] = tree[k]
    return out


def unflat_params(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


def _rows(mesh):
    from repro_torch.dist import tensor_parallel as tp

    b = MESH_ROWS // tp.axis_size(mesh, "data")
    i = tp.axis_index(mesh, "data")
    return slice(i * b, (i + 1) * b)


def _step_rows(toks, tg, mesh, microbatches):
    """A train step's batch on this rank: its block of each microbatch
    (``rank_rows``, as the trainer feeds it)."""
    from repro_torch.train.train_step import rank_rows

    mine = torch.from_numpy(rank_rows(MESH_ROWS, mesh, microbatches))
    return {"tokens": toks[mine], "targets": tg[mine]}


def _mesh_case(cfg, params, mesh):
    import copy

    from repro_torch.dist.sharding import place
    from repro_torch.dist.tensor_parallel import gather_tree
    from repro_torch.models import transformer as tfm
    from repro_torch.models.model import build_model
    from repro_torch.train.checkpoint import tree_flatten
    from repro_torch.train import train_step as ts
    from repro_torch.train.optimizer import (AdafactorConfig, AdamWConfig,
                                             tree_unflatten)
    from repro_torch.train.schedule import ScheduleConfig

    model = build_model(cfg, "cpu", mesh=mesh)
    plan = model.plan
    psh = plan.shardings
    pm = model.place(params)
    mine = _rows(mesh)
    toks, tg = (torch.from_numpy(a) for a in mesh_batch(cfg))
    batch = {"tokens": toks[mine], "targets": tg[mine]}
    out = {"local_shapes": {p: tuple(x.shape) for p, x in
                            flat_params(pm).items()},
           "heads": plan.heads, "mlp": plan.mlp, "vocab": plan.vocab}
    with torch.no_grad():
        x, _ = tfm.forward(pm, toks[mine], cfg, plan=plan)
        out["logits"] = tfm.logits_of(pm, x, cfg, plan)
    loss, met, grads = ts.loss_and_grads(model, pm, batch)
    loss, met, grads = ts._reduce(model, psh, loss, met, grads)
    out["loss"] = loss
    out["grads"] = gather_tree(tree_unflatten(pm, grads), psh)

    sched = ScheduleConfig(peak_lr=MESH_LR, warmup_steps=1, total_steps=10)
    for name, opt in (("adamw", AdamWConfig(lr=MESH_LR)),
                      ("adafactor", AdafactorConfig(lr=MESH_LR,
                                                    min_dim_factored=64))):
        tcfg = ts.TrainConfig(optimizer=opt, schedule=sched, microbatches=2)
        whole = ts.TrainState(copy.deepcopy(params),
                              ts.make_optimizer(opt)[0](params),
                              torch.zeros((), dtype=torch.int32))
        sh = ts.state_sharding(model, whole)
        state = place(whole, sh)
        for _ in range(2):
            state, m = ts.make_train_step(model, tcfg)(
                state, _step_rows(toks, tg, mesh, 2))
        out[name] = {"state": dict(tree_flatten(gather_tree(state, sh))),
                     "metrics": {k: float(v) for k, v in m.items()}}

    kc, vc, lens, dt = mesh_decode_inputs(cfg)
    whole = {"k_cache": torch.from_numpy(kc), "v_cache": torch.from_numpy(vc),
             "cache_len": torch.from_numpy(lens)}
    ssh = tfm.state_sharding(cfg, mesh, MESH_ROWS, MESH_S)
    st = place(whole, ssh)
    out["cache_local"] = tuple(st["k_cache"].shape)
    logits, new = model.decode_step(pm, st, torch.from_numpy(dt)[mine])
    out["decode_logits"] = logits
    out["decode_state"] = gather_tree(new, ssh)
    return out


def unsharded_steps(cfg, params, opt, microbatches=2):
    """The meshless port's two steps of ``_mesh_case`` on the whole
    batch (the Adafactor reference)."""
    import copy

    from repro_torch.models.model import build_model
    from repro_torch.train import train_step as ts
    from repro_torch.train.checkpoint import tree_flatten
    from repro_torch.train.schedule import ScheduleConfig

    model = build_model(cfg, "cpu")
    sched = ScheduleConfig(peak_lr=MESH_LR, warmup_steps=1, total_steps=10)
    tcfg = ts.TrainConfig(optimizer=opt, schedule=sched,
                          microbatches=microbatches)
    state = ts.TrainState(copy.deepcopy(params),
                          ts.make_optimizer(opt)[0](params),
                          torch.zeros((), dtype=torch.int32))
    toks, tg = (torch.from_numpy(a) for a in mesh_batch(cfg))
    for _ in range(2):
        state, m = ts.make_train_step(model, tcfg)(
            state, {"tokens": toks, "targets": tg})
    return ({p: x.clone() for p, x in tree_flatten(state)},
            {k: float(v) for k, v in m.items()})


def _trainer(cfg, mesh, ckpt_dir, steps):
    from repro_torch.data.tokens import SyntheticTokens
    from repro_torch.models.model import build_model
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.schedule import ScheduleConfig
    from repro_torch.train.train_step import TrainConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    tcfg = TrainConfig(optimizer=AdamWConfig(lr=MESH_LR),
                       schedule=ScheduleConfig(peak_lr=MESH_LR,
                                               warmup_steps=1,
                                               total_steps=10))
    data = SyntheticTokens(vocab=cfg.vocab, seq=MESH_LEN,
                           local_batch=MESH_ROWS)
    t = Trainer(build_model(cfg, "cpu"),
                TrainerConfig(train=tcfg, ckpt_dir=ckpt_dir,
                              ckpt_every=100), data, mesh=mesh)
    t.run(steps)
    return t


def _whole(trainer):
    """The trainer's whole state, gathered from every rank's blocks."""
    from repro_torch.dist.tensor_parallel import gather_tree
    from repro_torch.train.checkpoint import tree_flatten

    st = (trainer.state if trainer._sh is None
          else gather_tree(trainer.state, trainer._sh))
    return st, {p: x.clone() for p, x in tree_flatten(st)}


def _nbytes(tree):
    from repro_torch.train.checkpoint import tree_flatten

    return sum(x.numel() * x.element_size() for _p, x in tree_flatten(tree))


def _checkpoint_case(cfg, mesh, out_dir):
    """Uninterrupted on (2, 2) for 4 steps; saved at step 2 on (2, 2),
    restored on (1, 2) (ranks 0-1; ranks 2-3 hold no block) and onto no
    mesh, and run on to step 4; then the saved run re-meshed onto (1, 2).
    Each restore counts the bytes it copies out of blocks beside the
    bytes of the blocks it fills."""
    from repro_torch.launch.mesh import make_mesh_shape
    from repro_torch.train import checkpoint as ckpt

    ck = os.path.join(out_dir, "mesh_ckpt")
    full = _trainer(cfg, mesh, None, 4)
    saved = _trainer(cfg, mesh, ck, 2)
    like, at2 = _whole(saved)
    sub = make_mesh_shape((1, 2), ("data", "model"), "cpu")
    out = {"uninterrupted": [m["loss"] for m in full.metrics_log],
           "saved": at2}
    n0 = ckpt.READ_BYTES["n"]
    resumed = _trainer(cfg, sub, ck, 2)    # restores step 2: no step run
    out["active"] = resumed.active
    if resumed.active:
        out["read"] = (ckpt.READ_BYTES["n"] - n0, _nbytes(resumed.state))
        out["restored"] = _whole(resumed)[1]
        n0 = ckpt.READ_BYTES["n"]
        step, tree, _extra = ckpt.restore_latest(ck, like)
        out["read_meshless"] = (ckpt.READ_BYTES["n"] - n0, _nbytes(tree))
        out["meshless"] = (step, {p: x for p, x
                                  in ckpt.tree_flatten(tree)})
        resumed.run(4)
        out["resumed"] = [m["loss"] for m in resumed.metrics_log]
    dist.barrier()
    n0 = ckpt.READ_BYTES["n"]
    saved.remesh(sub)
    out["remesh_active"] = saved.active
    if saved.active:
        out["remesh_read"] = (ckpt.READ_BYTES["n"] - n0,
                              _nbytes(saved.state))
        out["remeshed"] = _whole(saved)[1]
    dist.barrier()
    out["remesh_left"] = sorted(n for n in os.listdir(ck)
                                if n.startswith(".remesh"))
    return out


def run_mesh_rank(rank, world, init_file, out_dir):
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import make_mesh_shape
    from repro_torch.weights import model_params_from_numpy

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    mesh = make_mesh_shape((2, 2), ("data", "model"), "cpu")
    out = {}
    for case, kv in MESH_CASES.items():
        cfg = mesh_cfg(kv, get_config)
        flat = dict(np.load(os.path.join(out_dir, f"params_{case}.npz")))
        params = model_params_from_numpy(unflat_params(flat), cfg, "cpu")
        out[case] = _mesh_case(cfg, params, mesh)
    cfg = mesh_cfg(MESH_CASES["divides"], get_config)
    out["ckpt"] = _checkpoint_case(cfg, mesh, out_dir)
    t = launch_train.main(["--smoke", "--device", "cpu", "--steps", "4",
                           "--seq", "16", "--batch", "4", "--mesh",
                           "2x2:data,model", "--elastic-demo"])
    out["elastic"] = {"losses": [m["loss"] for m in t.metrics_log],
                      "mesh": None if t.mesh is None else tuple(t.mesh.shape),
                      "active": t.active}
    dist.barrier()
    torch.save(out, os.path.join(out_dir, f"mesh_rank{rank}.pt"))
    dist.destroy_process_group()


# ------------------------------------------------------- the mesh families
# ``test_torch_mesh_families.py``: the moe, ssm and hybrid smoke models on
# the same (2, 2) mesh.  Each case is (arch, config overrides); "drop"
# routes the global chunk with a low capacity over several chunks, so
# pairs are dropped across the data ranks' boundary.
FAMILY_CASES = {
    "granite": ("granite-moe-1b-a400m", {}),
    "drop": ("granite-moe-1b-a400m",
             {"moe": {"capacity_factor": 0.5, "token_chunk": 16}}),
    "arctic": ("arctic-480b", {}),
    "falcon": ("falcon-mamba-7b", {}),
    "falcon_kernel": ("falcon-mamba-7b", {"ssm": {"use_scan_kernel": True}}),
    "zamba2": ("zamba2-2.7b", {}),
}
# the cases without a backward (the scan kernel has none)
FORWARD_ONLY = ("falcon_kernel",)
# the train steps' microbatches: a rank's rows of each are its block of
# the JAX step's (``rank_rows``), so MoE routing groups the same rows
MICRO = 2
# the drop case's routing input: one global chunk of MESH_ROWS x 4 tokens
ROUTE_TOKENS = MESH_ROWS * 4


def family_cfg(case, get_config):
    """The case's config (``get_config`` of either package)."""
    import dataclasses

    arch, over = FAMILY_CASES[case]
    cfg = get_config(arch, smoke=True)
    for field, kw in over.items():
        cfg = dataclasses.replace(cfg, **{field: dataclasses.replace(
            getattr(cfg, field), **kw)})
    return cfg


def family_decode_inputs(cfg, seed=23):
    """A decode step's whole state (numpy, by key) and tokens: random
    K/V caches and recurrent state, lengths before the step."""
    from repro_torch.models.transformer import _state_leaves

    rng = np.random.default_rng(seed)
    state = {}
    for k, (shape, dt) in _state_leaves(cfg, MESH_ROWS, MESH_S).items():
        if k == "cache_len":
            state[k] = np.array([5, 9, 12, 3], np.int32)
        else:
            state[k] = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    toks = rng.integers(0, cfg.vocab, (MESH_ROWS, 1)).astype(np.int32)
    return state, toks


def route_input(cfg, seed=24):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((ROUTE_TOKENS, cfg.d_model)).astype(
        np.float32)


def _family_case(case, cfg, params, mesh):
    import copy

    from repro_torch.dist.sharding import place
    from repro_torch.dist.tensor_parallel import gather_tree
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tfm
    from repro_torch.models.model import build_model
    from repro_torch.train import train_step as ts
    from repro_torch.train.checkpoint import tree_flatten
    from repro_torch.train.optimizer import (AdafactorConfig, AdamWConfig,
                                             tree_unflatten)
    from repro_torch.train.schedule import ScheduleConfig

    model = build_model(cfg, "cpu", mesh=mesh)
    plan = model.plan
    psh = plan.shardings
    pm = model.place(params)
    mine = _rows(mesh)
    toks, tg = (torch.from_numpy(a) for a in mesh_batch(cfg))
    batch = {"tokens": toks[mine], "targets": tg[mine]}
    out = {"plan": {k: getattr(plan, k) for k in
                    ("heads", "mlp", "vocab", "experts", "ssm")},
           "local_shapes": {p: tuple(x.shape) for p, x in
                            flat_params(pm).items()}}
    with torch.no_grad():
        x, aux = tfm.forward(pm, toks[mine], cfg, plan=plan)
        out["logits"] = tfm.logits_of(pm, x, cfg, plan)
        out["aux"] = aux
    if case not in FORWARD_ONLY:
        loss, met, grads = ts.loss_and_grads(model, pm, batch)
        loss, met, grads = ts._reduce(model, psh, loss, met, grads)
        out["loss"], out["metrics"] = loss, met
        out["grads"] = gather_tree(tree_unflatten(pm, grads), psh)
        sched = ScheduleConfig(peak_lr=MESH_LR, warmup_steps=1,
                               total_steps=10)
        opts = [("adamw", AdamWConfig(lr=MESH_LR))]
        if case == "arctic":
            opts.append(("adafactor", AdafactorConfig(lr=MESH_LR,
                                                      min_dim_factored=32)))
        for name, opt in opts:
            tcfg = ts.TrainConfig(optimizer=opt, schedule=sched,
                                  microbatches=MICRO)
            whole = ts.TrainState(copy.deepcopy(params),
                                  ts.make_optimizer(opt)[0](params),
                                  torch.zeros((), dtype=torch.int32))
            sh = ts.state_sharding(model, whole)
            state = place(whole, sh)
            for _ in range(2):
                state, m = ts.make_train_step(model, tcfg)(
                    state, _step_rows(toks, tg, mesh, MICRO))
            out[name] = {"state": dict(tree_flatten(gather_tree(state, sh))),
                         "metrics": {k: float(v) for k, v in m.items()}}

    whole, dt = family_decode_inputs(cfg)
    whole = {k: torch.from_numpy(v) for k, v in whole.items()}
    ssh = tfm.state_sharding(cfg, mesh, MESH_ROWS, MESH_S)
    st = place(whole, ssh)
    out["state_local"] = {k: tuple(v.shape) for k, v in st.items()}
    with torch.no_grad():
        logits, new = model.decode_step(pm, st, torch.from_numpy(dt)[mine])
    out["decode_logits"] = logits
    out["decode_state"] = gather_tree(new, ssh)
    with torch.no_grad():
        state, pl = model.prefill(pm, toks[mine], MESH_S)
    out["prefill_logits"] = pl

    if cfg.moe is not None:
        xc = torch.from_numpy(route_input(cfg))
        n = xc.shape[0] // plan.dp
        i = mine.start // (MESH_ROWS // plan.dp)
        ctx = moe_mod.moe_mesh(mesh, plan.experts, plan.batch_axes)
        router = {"router": params["layers"]["moe"]["router"][0]}
        r = moe_mod.route(xc[i * n:(i + 1) * n], router, cfg.moe, ctx)
        out["route"] = {"slot": r[2], "keep": r[3], "cap": r[4]}
    return out


def _family_ckpt(cfg, mesh, out_dir, tag):
    """A trainer's state saved on (2, 2) at step 2, restored on (1, 2)
    (ranks 0-1) and re-meshed onto (1, 2): both bit for bit."""
    from repro_torch.launch.mesh import make_mesh_shape

    ck = os.path.join(out_dir, f"family_ckpt_{tag}")
    saved = _trainer(cfg, mesh, ck, 2)
    _like, at2 = _whole(saved)
    sub = make_mesh_shape((1, 2), ("data", "model"), "cpu")
    out = {"saved": at2}
    resumed = _trainer(cfg, sub, ck, 2)
    out["active"] = resumed.active
    if resumed.active:
        out["restored"] = _whole(resumed)[1]
    dist.barrier()
    saved.remesh(sub)
    if saved.active:
        out["remeshed"] = _whole(saved)[1]
    dist.barrier()
    return out


def run_family_rank(rank, world, init_file, out_dir,
                    cases=tuple(FAMILY_CASES), ckpt=("granite", "falcon")):
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh_shape
    from repro_torch.weights import model_params_from_numpy

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    mesh = make_mesh_shape((2, 2), ("data", "model"), "cpu")
    out = {}
    for case in cases:
        cfg = family_cfg(case, get_config)
        flat = dict(np.load(os.path.join(out_dir, f"params_{case}.npz")))
        params = model_params_from_numpy(unflat_params(flat), cfg, "cpu")
        out[case] = _family_case(case, cfg, params, mesh)
    for tag in ckpt:
        out[f"ckpt_{tag}"] = _family_ckpt(family_cfg(tag, get_config), mesh,
                                          out_dir, tag)
    dist.barrier()
    torch.save(out, os.path.join(out_dir, f"family_rank{rank}.pt"))
    dist.destroy_process_group()


# ------------------------------------------- vlm, encdec and batch_tp
# ``test_torch_mesh_vlm_encdec.py``: the vlm and encdec smoke models and
# the two Mamba families under ``batch_tp``, each case (arch, config
# overrides, mesh shape).  "vlm" splits its 2 kv heads over a model axis
# of 2; "vlm_unsplit" runs on (1, 4), where 2 kv heads do not divide 4
# (the branch llama-3.2-vision-11b's 8 kv heads take at model 16).
VLM_CASES = {
    "vlm": ("llama-3.2-vision-11b", {}, (2, 2)),
    "vlm_unsplit": ("llama-3.2-vision-11b", {}, (1, 4)),
    "whisper": ("whisper-medium", {}, (2, 2)),
    "falcon_tp": ("falcon-mamba-7b", {"ssm": {"batch_tp": True}}, (2, 2)),
    "zamba2_tp": ("zamba2-2.7b", {"ssm": {"batch_tp": True}}, (2, 2)),
}
VLM_CKPT = ("vlm", "whisper")


def vlm_cfg(case, get_config):
    """The case's config (``get_config`` of either package)."""
    import dataclasses

    arch, over, _shape = VLM_CASES[case]
    cfg = get_config(arch, smoke=True)
    for field, kw in over.items():
        cfg = dataclasses.replace(cfg, **{field: dataclasses.replace(
            getattr(cfg, field), **kw)})
    return cfg


def stub_inputs(cfg, rows=MESH_ROWS, seed=25):
    """{name: array} of the vlm ``patches`` or encdec ``frames`` of
    ``rows`` rows (empty for the text families)."""
    names = {"vlm": ("patches", cfg.n_patches),
             "encdec": ("frames", cfg.enc_seq)}
    if cfg.family not in names:
        return {}
    name, n = names[cfg.family]
    rng = np.random.default_rng(seed)
    return {name: (rng.standard_normal((rows, n, cfg.d_model)) * 0.5)
            .astype(np.float32)}


class StubData:
    """A token source whose batches also carry seeded vlm ``patches`` or
    encdec ``frames`` (one draw per step), its state the token
    source's."""

    def __init__(self, cfg, data):
        self.cfg, self.data = cfg, data

    def state_dict(self):
        return self.data.state_dict()

    def load_state_dict(self, st):
        self.data.load_state_dict(st)

    def next_batch(self):
        import types

        b = self.data.next_batch()
        extra = stub_inputs(self.cfg, b.tokens.shape[0], 1000 + b.step)
        return types.SimpleNamespace(tokens=b.tokens, targets=b.targets,
                                     step=b.step, **extra)


def _vlm_hidden(cfg, pm, toks, extra, plan):
    """The final hidden states of the rank's rows (encdec: the decoder's
    over the encoder output)."""
    from repro_torch.models import encdec as ed
    from repro_torch.models import transformer as tfm

    if cfg.family == "encdec":
        enc = ed.encode(pm, extra["frames"], cfg, plan)
        return ed._decode_forward(pm, toks, enc, cfg, plan)
    return tfm.forward(pm, toks, cfg, extra=extra or None, plan=plan)[0]


def _vlm_case(cfg, params, mesh):
    import copy

    from repro_torch.dist.sharding import place
    from repro_torch.dist.tensor_parallel import gather_tree
    from repro_torch.models import transformer as tfm
    from repro_torch.models.model import build_model
    from repro_torch.train import train_step as ts
    from repro_torch.train.checkpoint import tree_flatten
    from repro_torch.train.optimizer import AdamWConfig, tree_unflatten
    from repro_torch.train.schedule import ScheduleConfig

    model = build_model(cfg, "cpu", mesh=mesh)
    plan = model.plan
    psh = plan.shardings
    pm = model.place(params)
    mine = _rows(mesh)
    toks, tg = (torch.from_numpy(a) for a in mesh_batch(cfg))
    extra = {k: torch.from_numpy(v) for k, v in stub_inputs(cfg).items()}
    mine_x = {k: v[mine] for k, v in extra.items()}
    out = {"plan": {k: getattr(plan, k) for k in
                    ("heads", "mlp", "vocab", "ssm", "rows")},
           "local_shapes": {p: tuple(x.shape) for p, x in
                            flat_params(pm).items()}}
    with torch.no_grad():
        x = _vlm_hidden(cfg, pm, toks[mine], mine_x, plan)
        out["logits"] = tfm.logits_of(pm, x, cfg, plan)
    batch = {"tokens": toks[mine], "targets": tg[mine], **mine_x}
    loss, met, grads = ts.loss_and_grads(model, pm, batch)
    loss, met, grads = ts._reduce(model, psh, loss, met, grads)
    out["loss"] = loss
    out["grads"] = gather_tree(tree_unflatten(pm, grads), psh)

    opt = AdamWConfig(lr=MESH_LR)
    tcfg = ts.TrainConfig(optimizer=opt, schedule=ScheduleConfig(
        peak_lr=MESH_LR, warmup_steps=1, total_steps=10),
        microbatches=MICRO)
    whole = ts.TrainState(copy.deepcopy(params),
                          ts.make_optimizer(opt)[0](params),
                          torch.zeros((), dtype=torch.int32))
    sh = ts.state_sharding(model, whole)
    state = place(whole, sh)
    rows = torch.from_numpy(ts.rank_rows(MESH_ROWS, mesh, MICRO))
    step_batch = {"tokens": toks[rows], "targets": tg[rows],
                  **{k: v[rows] for k, v in extra.items()}}
    for _ in range(2):
        state, m = ts.make_train_step(model, tcfg)(state, step_batch)
    out["adamw"] = {"state": dict(tree_flatten(gather_tree(state, sh))),
                    "metrics": {k: float(v) for k, v in m.items()}}

    whole, dt = family_decode_inputs(cfg)
    whole = {k: torch.from_numpy(v) for k, v in whole.items()}
    ssh = tfm.state_sharding(cfg, mesh, MESH_ROWS, MESH_S)
    st = place(whole, ssh)
    out["state_local"] = {k: tuple(v.shape) for k, v in st.items()}
    with torch.no_grad():
        logits, new = model.decode_step(pm, st, torch.from_numpy(dt)[mine])
        out["decode_logits"] = logits
        out["decode_state"] = gather_tree(new, ssh)
        pst, pl = model.prefill(pm, toks[mine], MESH_S, extra=mine_x or None)
    out["prefill_logits"] = pl
    out["prefill_state"] = gather_tree(pst, ssh)
    return out


def _vlm_trainer(cfg, mesh, ckpt_dir, steps):
    from repro_torch.data.tokens import SyntheticTokens
    from repro_torch.models.model import build_model
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.schedule import ScheduleConfig
    from repro_torch.train.train_step import TrainConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    tcfg = TrainConfig(optimizer=AdamWConfig(lr=MESH_LR),
                       schedule=ScheduleConfig(peak_lr=MESH_LR,
                                               warmup_steps=1,
                                               total_steps=10))
    data = StubData(cfg, SyntheticTokens(vocab=cfg.vocab, seq=MESH_LEN,
                                         local_batch=MESH_ROWS))
    t = Trainer(build_model(cfg, "cpu"),
                TrainerConfig(train=tcfg, ckpt_dir=ckpt_dir,
                              ckpt_every=100), data, mesh=mesh)
    t.run(steps)
    return t


def _vlm_ckpt(cfg, mesh, out_dir, tag):
    """A trainer's state (its batches carrying the stub inputs) saved on
    (2, 2) at step 2, restored on (1, 2) (ranks 0-1) and re-meshed onto
    (1, 2): both bit for bit."""
    from repro_torch.launch.mesh import make_mesh_shape

    ck = os.path.join(out_dir, f"vlm_ckpt_{tag}")
    saved = _vlm_trainer(cfg, mesh, ck, 2)
    out = {"saved": _whole(saved)[1],
           "losses": [m["loss"] for m in saved.metrics_log]}
    sub = make_mesh_shape((1, 2), ("data", "model"), "cpu")
    resumed = _vlm_trainer(cfg, sub, ck, 2)
    out["active"] = resumed.active
    if resumed.active:
        out["restored"] = _whole(resumed)[1]
    dist.barrier()
    saved.remesh(sub)
    if saved.active:
        out["remeshed"] = _whole(saved)[1]
    dist.barrier()
    return out


def run_vlm_rank(rank, world, init_file, out_dir, cases=tuple(VLM_CASES),
                 ckpt=VLM_CKPT):
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh_shape
    from repro_torch.weights import model_params_from_numpy

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    meshes = {}
    out = {}
    for case in cases:
        shape = VLM_CASES[case][2]
        if shape not in meshes:
            meshes[shape] = make_mesh_shape(shape, ("data", "model"), "cpu")
        cfg = vlm_cfg(case, get_config)
        flat = dict(np.load(os.path.join(out_dir, f"params_{case}.npz")))
        params = model_params_from_numpy(unflat_params(flat), cfg, "cpu")
        out[case] = _vlm_case(cfg, params, meshes[shape])
    for tag in ckpt:
        out[f"ckpt_{tag}"] = _vlm_ckpt(vlm_cfg(tag, get_config),
                                       meshes[(2, 2)], out_dir, tag)
    dist.barrier()
    torch.save(out, os.path.join(out_dir, f"vlm_rank{rank}.pt"))
    dist.destroy_process_group()
