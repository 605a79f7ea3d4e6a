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
* **retention**: the newest ``keep`` committed steps stay, older ones go.

Leaves are flattened in the JAX order: dict keys sorted, lists and
tuples (NamedTuples, a ``TrainState`` among them, field by field) in
order; ``tree_flatten`` names each by its path.  ``restore_latest`` returns CPU tensors in the
structure of ``tree_like``, each cast to its leaf's dtype; the caller
places them on a device, so the format is topology-free.
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
           "wait_pending", "tree_flatten", "tree_unflatten"]

FORMAT = "repro_torch-checkpoint-1"
_pending: Dict[str, threading.Thread] = {}


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


def save(ckpt_dir: str, step: int, tree: Any,
         extra: Optional[Dict[str, Any]] = None, keep: int = 3) -> str:
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
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "COMMIT"), "w") as f:
        f.write("ok")
    try:
        os.replace(tmp, final)
    except OSError:
        # a concurrent save won the rename race for this step; theirs is
        # equally valid: drop ours
        shutil.rmtree(tmp, ignore_errors=True)
    _gc(ckpt_dir, keep)
    return final


def save_async(ckpt_dir: str, step: int, tree: Any,
               extra: Optional[Dict[str, Any]] = None, keep: int = 3) -> None:
    """Snapshot to host memory now, write in the background (after the
    directory's previous background save has finished)."""
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


def restore_latest(ckpt_dir: str, tree_like: Any
                   ) -> Optional[Tuple[int, Any, Dict]]:
    """Restore the newest committed checkpoint into the structure of
    ``tree_like`` -> (step, tree of CPU tensors, extra), or None."""
    step = latest_step(ckpt_dir)
    if step is None:
        return None
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest.get("format") != FORMAT:
        raise ValueError(f"{path}: not a {FORMAT} checkpoint")
    flat: Dict[str, torch.Tensor] = {}
    for name in sorted(os.listdir(path)):
        if name.startswith("shard_") and name.endswith(".pt"):
            flat.update(torch.load(os.path.join(path, name),
                                   map_location="cpu", weights_only=True))
    like = tree_flatten(tree_like)
    if len(like) != manifest["n_leaves"]:
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, "
                         f"the tree expects {len(like)}")
    leaves = []
    for i, (p, x) in enumerate(like):
        got = flat[f"leaf_{i}"]
        if tuple(got.shape) != tuple(x.shape):
            raise ValueError(f"{p}: checkpoint shape {tuple(got.shape)}, "
                             f"the tree expects {tuple(x.shape)}")
        leaves.append(got.to(x.dtype))
    return step, tree_unflatten(tree_like, leaves), manifest.get("extra", {})


def _gc(ckpt_dir: str, keep: int) -> None:
    for s in _committed(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
