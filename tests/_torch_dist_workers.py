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
