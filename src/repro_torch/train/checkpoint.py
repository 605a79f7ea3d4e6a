"""Fault-tolerant checkpointing of a train state (or any tree of tensors).

Port of ``repro.train.checkpoint``, with the same guarantees and an
on-disk format of the port's own (the JAX package writes msgpack and
npz; the card's machine has neither ``msgpack`` nor ``ml_dtypes``, and
npz cannot hold bf16).  Layout per step::

  <dir>/step_<n>/
      manifest.json   format, step, every leaf's path, shape and dtype,
                      and ``extra`` (the data pipeline's state)
      shard_<host>.pt ``torch.save`` of {"leaf_<i>": CPU tensor}, bf16
                      kept bit for bit
      COMMIT          written last; a step without it is ignored

* **atomicity**: a save writes into ``step_<n>.tmp.<id>`` (a fresh id per
  save, so two saves of one step never share a staging dir), writes
  ``COMMIT`` last and ``os.replace``-s the dir to its final name; a crash
  mid-save never corrupts the restore path;
* **async**: ``save_async`` copies the leaves to host memory now and
  writes them on a background thread; ``wait_pending`` joins it;
* **multi-host**: each process writes ``shard_<rank>.pt`` (rank 0 on one
  process); restore merges whatever shard files exist;
* **topology-free on a mesh**: with ``shardings`` (the state's
  ``NamedSharding`` tree) each rank writes the blocks it holds, each
  with its offsets in the whole leaf, and only the ranks at coordinate 0
  of every axis a leaf is replicated over write it; the ranks stage into
  one directory (``step_<n>.tmp.mesh``), meet at a barrier over every
  mesh axis, and rank 0 writes ``manifest.json`` (each leaf's whole
  shape) and ``COMMIT``.  ``restore_latest`` fills each leaf's target
  region (with ``shardings``, this rank's block on the new mesh; without,
  the whole leaf) from the parts of the blocks that overlap it, whatever
  mesh wrote them, bit for bit.  Each shard file is memory-mapped, so a
  rank reads the bytes of its own region and the files' small indexes,
  not the whole checkpoint; ``READ_BYTES`` counts the bytes copied out
  of blocks;
* **retention**: the newest ``keep`` committed steps stay, older ones go.

Leaves are flattened in the JAX order: dict keys sorted, lists and
tuples (NamedTuples, a ``TrainState`` among them, field by field) in
order; ``tree_flatten`` names each by its path.  ``restore_latest``
returns CPU tensors in the structure of ``tree_like``, each cast to its
leaf's dtype; the caller places them on a device, so the format is
topology-free.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import uuid
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.train.optimizer import tree_unflatten

__all__ = ["save", "save_async", "restore_latest", "latest_step",
           "wait_pending", "tree_flatten", "tree_unflatten", "READ_BYTES"]

FORMAT = "repro_torch-checkpoint-1"
_pending: Dict[str, threading.Thread] = {}
# bytes ``restore_latest`` has copied out of checkpoint blocks
READ_BYTES = {"n": 0}


def _children(tree) -> Optional[List[Tuple[str, Any]]]:
    """(name, child) pairs of an inner node; None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return [(str(i), x) for i, x in enumerate(tree)]
    return None


def tree_flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs of ``tree`` in the JAX flattening order."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    return [pl for name, child in kids
            for pl in tree_flatten(child, f"{prefix}/{name}" if prefix
                                   else name)]


def _to_host(x) -> torch.Tensor:
    """A CPU tensor owning exactly its elements (a view is copied, so
    ``torch.save`` never writes a larger storage)."""
    t = torch.as_tensor(x).detach().to("cpu", copy=True)
    return t.contiguous()


def _host_index() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        return dist.get_rank()
    return 0


def _mesh_barrier(mesh) -> None:
    """Every rank of the mesh has reached this call once each has
    returned from it (a barrier over each axis in turn)."""
    dist = torch.distributed
    for name in mesh.mesh_dim_names:
        if mesh.size(mesh.mesh_dim_names.index(name)) > 1:
            dist.barrier(group=mesh.get_group(name))


def _writes(sh, ndim: int) -> bool:
    """Whether this rank writes its block: coordinate 0 on every axis
    the leaf is replicated over."""
    coord = sh.coordinate()
    return all(coord[a] == 0 for a in sh.replicated_over(ndim))


def _save_mesh(ckpt_dir, step, tree, extra, keep, shardings) -> str:
    mesh = tree_flatten(shardings)[0][1].mesh
    rank0 = all(c == 0 for c in (mesh.get_coordinate() or (1,)))
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if os.path.exists(os.path.join(final, "COMMIT")):
        return final  # every rank sees the committed step alike
    tmp = final + ".tmp.mesh"
    if rank0:
        os.makedirs(ckpt_dir, exist_ok=True)
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
    _mesh_barrier(mesh)
    flat = tree_flatten(tree)
    shs = [sh for _p, sh in tree_flatten(shardings)]
    blocks, offsets, shapes = {}, {}, []
    for i, ((_p, x), sh) in enumerate(zip(flat, shs)):
        whole = sh.whole_shape(x.shape)
        shapes.append(whole)
        if _writes(sh, x.dim()):
            blocks[f"leaf_{i}"] = _to_host(x)
            offsets[f"leaf_{i}"] = list(sh.offsets(whole))
    rank = torch.distributed.get_rank()
    torch.save({"blocks": blocks, "offsets": offsets},
               os.path.join(tmp, f"shard_{rank}.pt"))
    _mesh_barrier(mesh)
    if rank0:
        manifest = {
            "format": FORMAT, "step": step, "n_leaves": len(flat),
            "mesh": dict(zip(mesh.mesh_dim_names,
                             (int(n) for n in mesh.shape))),
            "leaves": [{"path": p, "shape": shapes[i],
                        "dtype": str(x.dtype).replace("torch.", "")}
                       for i, (p, x) in enumerate(flat)],
            "extra": extra or {},
        }
        _commit(tmp, final, manifest)
        _gc(ckpt_dir, keep)
    _mesh_barrier(mesh)
    return final


def _commit(tmp: str, final: str, manifest: Dict) -> None:
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "COMMIT"), "w") as f:
        f.write("ok")
    if os.path.exists(os.path.join(final, "COMMIT")):
        shutil.rmtree(tmp, ignore_errors=True)
        return
    try:
        os.replace(tmp, final)
    except OSError:
        # a concurrent save won the rename race for this step; theirs is
        # equally valid: drop ours
        shutil.rmtree(tmp, ignore_errors=True)


def save(ckpt_dir: str, step: int, tree: Any,
         extra: Optional[Dict[str, Any]] = None, keep: int = 3,
         shardings: Any = None) -> str:
    """Write ``tree`` as step ``step``; with ``shardings`` (its leaves'
    ``NamedSharding``), every rank of the mesh calls it with its local
    shards."""
    if shardings is not None:
        return _save_mesh(ckpt_dir, step, tree, extra, keep, shardings)
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if os.path.exists(os.path.join(final, "COMMIT")):
        return final  # an identical step is already committed
    tmp = final + f".tmp.{uuid.uuid4().hex[:8]}"
    os.makedirs(tmp)
    flat = tree_flatten(tree)
    leaves = {f"leaf_{i}": _to_host(x) for i, (_p, x) in enumerate(flat)}
    torch.save(leaves, os.path.join(tmp, f"shard_{_host_index()}.pt"))
    manifest = {
        "format": FORMAT,
        "step": step,
        "n_leaves": len(flat),
        "leaves": [{"path": p, "shape": list(leaves[f"leaf_{i}"].shape),
                    "dtype": str(leaves[f"leaf_{i}"].dtype)}
                   for i, (p, _x) in enumerate(flat)],
        "extra": extra or {},
    }
    _commit(tmp, final, manifest)
    _gc(ckpt_dir, keep)
    return final


def save_async(ckpt_dir: str, step: int, tree: Any,
               extra: Optional[Dict[str, Any]] = None, keep: int = 3,
               shardings: Any = None) -> None:
    """Snapshot to host memory now, write in the background (after the
    directory's previous background save has finished).  On a mesh
    (``shardings``) the save meets every rank at barriers, which a
    background thread must not interleave with the training's
    collectives: it is written now."""
    if shardings is not None:
        save(ckpt_dir, step, tree, extra, keep, shardings)
        return
    wait_pending(ckpt_dir)
    snapshot = tree_unflatten(tree, [_to_host(x)
                                     for _p, x in tree_flatten(tree)])
    t = threading.Thread(
        target=save, args=(ckpt_dir, step, snapshot, extra, keep),
        daemon=True)
    _pending[ckpt_dir] = t
    t.start()


def wait_pending(ckpt_dir: Optional[str] = None) -> None:
    if ckpt_dir is not None:
        t = _pending.pop(ckpt_dir, None)
        if t:
            t.join()
        return
    for d in list(_pending):
        wait_pending(d)


def _committed(ckpt_dir: str) -> List[int]:
    return sorted(
        int(n.split("_")[1]) for n in os.listdir(ckpt_dir)
        if n.startswith("step_") and ".tmp" not in n
        and os.path.exists(os.path.join(ckpt_dir, n, "COMMIT")))


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _committed(ckpt_dir)
    return steps[-1] if steps else None


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name.replace("torch.", ""))


def _overlap(o, n, to, tn):
    """(source, destination) index tuples of the overlap of a block at
    offsets ``o`` of shape ``n`` with a region at ``to`` of shape ``tn``,
    or None where they do not meet."""
    lo = [max(a, b) for a, b in zip(o, to)]
    hi = [min(a + x, b + y) for a, x, b, y in zip(o, n, to, tn)]
    if any(h <= l for l, h in zip(lo, hi)):
        return None
    return (tuple(slice(l - a, h - a) for l, h, a in zip(lo, hi, o)),
            tuple(slice(l - b, h - b) for l, h, b in zip(lo, hi, to)))


def _read_regions(path: str, manifest: Dict, regions) -> List[torch.Tensor]:
    """Leaf ``i``'s region ``regions[i]`` (offsets, shape) filled from the
    overlapping parts of the blocks of every shard file: a mesh's blocks
    at their offsets, a plain file's leaves whole (a region two files
    hold is read from the first)."""
    out = [torch.empty(shape, dtype=_dtype(manifest["leaves"][i]["dtype"]))
           for i, (_o, shape) in enumerate(regions)]
    filled = [0] * len(out)
    seen = set()
    for name in sorted(os.listdir(path)):
        if not (name.startswith("shard_") and name.endswith(".pt")):
            continue
        got = torch.load(os.path.join(path, name), map_location="cpu",
                         weights_only=True, mmap=True)
        blocks = got.get("blocks", got)
        offsets = got.get("offsets", {})
        for key, block in blocks.items():
            i = int(key.split("_")[1])
            o = tuple(offsets.get(key, (0,) * block.dim()))
            if (i, o) in seen:
                continue
            seen.add((i, o))
            cut = _overlap(o, block.shape, *regions[i])
            if cut is None:
                continue
            part = block[cut[0]]
            out[i][cut[1]] = part
            filled[i] += part.numel()
            READ_BYTES["n"] += part.numel() * part.element_size()
        del got, blocks
    for i, x in enumerate(out):
        if filled[i] != x.numel():
            raise ValueError(f"{path}: the blocks of "
                             f"{manifest['leaves'][i]['path']} cover "
                             f"{filled[i]} of the {x.numel()} elements "
                             "asked for")
    return out


def restore_latest(ckpt_dir: str, tree_like: Any, shardings: Any = None
                   ) -> Optional[Tuple[int, Any, Dict]]:
    """Restore the newest committed checkpoint into the structure of
    ``tree_like`` -> (step, tree of CPU tensors, extra), or None.  With
    ``shardings`` (``tree_like``'s leaves are local shards on a mesh)
    each leaf is this rank's block of the whole one, read from the
    blocks that overlap it."""
    step = latest_step(ckpt_dir)
    if step is None:
        return None
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest.get("format") != FORMAT:
        raise ValueError(f"{path}: not a {FORMAT} checkpoint")
    like = tree_flatten(tree_like)
    if len(like) != manifest["n_leaves"]:
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, "
                         f"the tree expects {len(like)}")
    shs = ([sh for _p, sh in tree_flatten(shardings)] if shardings
           is not None else [None] * len(like))
    regions = []
    for (p, x), sh, meta in zip(like, shs, manifest["leaves"]):
        whole = tuple(meta["shape"])
        region = ((sh.offsets(whole), sh.local_shape(whole)) if sh is not None
                  else ((0,) * len(whole), whole))
        if tuple(region[1]) != tuple(x.shape):
            raise ValueError(f"{p}: checkpoint shape {tuple(region[1])}, "
                             f"the tree expects {tuple(x.shape)}")
        regions.append(region)
    got = _read_regions(path, manifest, regions)
    leaves = [g.to(x.dtype) for g, (_p, x) in zip(got, like)]
    return step, tree_unflatten(tree_like, leaves), manifest.get("extra", {})


def _gc(ckpt_dir: str, keep: int) -> None:
    for s in _committed(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
