"""Training loop with checkpoint/restart, a straggler watchdog, graceful
preemption and re-placement.

Port of ``repro.train.trainer``:

* checkpoint/restart: every ``ckpt_every`` steps an async checkpoint
  (params, optimizer state, step, and the data pipeline's state); on
  startup the trainer restores the newest committed step, so a killed job
  resumes where it left off;
* straggler watchdog: an EMA of the step time and its variance; a step
  more than ``straggler_z`` sigmas slower is logged and counted;
* graceful preemption: SIGTERM/SIGINT stop the loop after the current
  step, and one final sync checkpoint is written;
* no torn checkpoint: the step updates the state in place, so a step
  that raises partway may leave it half updated; then ``run`` writes no
  final checkpoint and re-raises, and a restart resumes from the last
  one committed;
* placement on a mesh: ``Trainer(..., mesh=mesh)`` runs the model built
  on ``mesh`` (``build_model(..., mesh=...)``): ``_place`` keeps each
  rank's block of the parameters and the optimizer state
  (``train_step.state_sharding``: AdamW ``m``/``v`` as the parameters,
  Adafactor ``vr``/``vc`` by the JAX dry run's rule), every rank draws
  the data's whole batch and trains on its rows (its block over the
  batch axes of each microbatch, ``train_step.rank_rows``; a batch's
  vlm ``patches`` or encdec ``frames``, where the data source gives
  them, are cut with its tokens), and
  checkpoints are written block by block and restore
  onto any mesh (``train.checkpoint``);
* re-placement: ``remesh(mesh)`` moves the state onto another mesh, a
  smaller one included (a rank past it keeps no state and stops), or
  onto no mesh (the model's device), block by block: every rank of the
  old mesh writes its blocks into a staging checkpoint (a fresh
  directory in ``ckpt_dir``, or in the temporary directory: either must
  be one file system for every rank) and every rank reads back only
  the parts that overlap its new blocks, so no rank holds more than
  its own blocks of the old and the new layout.

The step updates the state in place, as the JAX trainer donates it.
The step time is taken after the step's metrics are read back to the
host, so it is the device's time.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import signal
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.train import checkpoint as ckpt
from repro_torch.train.train_step import (TrainConfig, TrainState,
                                          init_train_state, make_train_step,
                                          rank_rows, state_sharding)

__all__ = ["TrainerConfig", "Trainer"]


@dataclasses.dataclass
class TrainerConfig:
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    keep: int = 3
    straggler_z: float = 3.0
    log_every: int = 10
    seed: int = 0


def _mesh_device(mesh, default: torch.device) -> torch.device:
    """The device a ``DeviceMesh`` places this process's shard on."""
    if mesh is None:
        return default
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


_EXTRA = ("patches", "frames")


def _arrays(b) -> Dict[str, np.ndarray]:
    """A data batch's arrays: ``tokens`` and ``targets``, and the stub
    frontends' ``patches`` (vlm) or ``frames`` (encdec) where it has
    them."""
    out = {"tokens": b.tokens, "targets": b.targets}
    for k in _EXTRA:
        if getattr(b, k, None) is not None:
            out[k] = getattr(b, k)
    return out


class Trainer:
    def __init__(self, model, cfg: TrainerConfig, data, mesh=None):
        self.cfg = cfg
        self.data = data
        self.metrics_log: List[Dict[str, float]] = []
        self.straggler_events: List[Dict[str, float]] = []
        self._step_time_ema = None
        self._step_time_var = 0.0
        self._stop = False
        self.state: Optional[TrainState] = None
        self._sh = None
        self._set_mesh(model, mesh)

    def _set_mesh(self, model, mesh) -> None:
        if model.mesh is not mesh:
            from repro_torch.models.model import build_model

            model = build_model(model.cfg, device=_mesh_device(
                mesh, model.device), mesh=mesh)
        self.model = model
        self.mesh = mesh
        self.device = _mesh_device(mesh, model.device)
        self._train_step = make_train_step(model, self.cfg.train)

    @property
    def active(self) -> bool:
        """Whether this rank holds a block of the mesh (always without
        one)."""
        return self.mesh is None or self.mesh.get_coordinate() is not None

    def _shardings(self, state):
        return None if self.mesh is None else state_sharding(self.model,
                                                             state)

    def _rows(self, x: np.ndarray) -> np.ndarray:
        """This rank's rows of a whole batch (``train_step.rank_rows``:
        its block of each microbatch)."""
        return x[rank_rows(x.shape[0], self.mesh,
                           self.cfg.train.microbatches)]

    # ------------------------------------------------------------ lifecycle
    def initialize(self) -> int:
        """Init or restore. Returns the starting step."""
        gen = torch.Generator(device=self.model.device)
        gen.manual_seed(self.cfg.seed)
        state = self._place(init_train_state(self.model, gen,
                                             self.cfg.train))
        start = 0
        if self.cfg.ckpt_dir:
            restored = ckpt.restore_latest(self.cfg.ckpt_dir, state,
                                           self._sh)
            if restored is not None:
                start, tree, extra = restored
                # into the fresh state's tensors: no second copy on the card
                with torch.no_grad():
                    for (_p, dst), (_q, src) in zip(ckpt.tree_flatten(state),
                                                    ckpt.tree_flatten(tree)):
                        dst.copy_(src)
                if "data" in extra and hasattr(self.data, "load_state_dict"):
                    self.data.load_state_dict(extra["data"])
        self.state = state
        return start

    def _place(self, state):
        """The whole ``state`` -> this rank's blocks on its device."""
        from repro_torch.dist.sharding import place

        self._sh = self._shardings(state)
        if self._sh is not None:
            state = place(state, self._sh)
        return ckpt.tree_unflatten(state, [
            x.to(self.device) for _p, x in ckpt.tree_flatten(state)])

    def _staging_dir(self) -> str:
        """A fresh directory, the same on every rank of the world."""
        import tempfile

        dist = torch.distributed
        many = dist.is_initialized() and dist.get_world_size() > 1
        name = [None]
        if not many or dist.get_rank() == 0:
            if self.cfg.ckpt_dir:
                os.makedirs(self.cfg.ckpt_dir, exist_ok=True)
            name[0] = tempfile.mkdtemp(prefix=".remesh_",
                                       dir=self.cfg.ckpt_dir or None)
        if many:
            dist.broadcast_object_list(name, src=0)
        return name[0]

    def remesh(self, new_mesh) -> None:
        """Elastic scale: move the state onto another mesh (a rank past
        a smaller mesh keeps none and stops training).  Every rank of
        the world calls it; see the module docstring."""
        from repro_torch.dist.sharding import place

        state, old = self.state, self._sh
        self.state = None
        if old is None:    # the whole state is here: place it at once
            self._set_mesh(self.model, new_mesh)
            self.state = self._place(state) if self.active else None
            return
        # the whole state's shapes, on meta: no storage
        whole = ckpt.tree_unflatten(state, [
            torch.empty(sh.whole_shape(x.shape), dtype=x.dtype,
                        device="meta")
            for (_p, x), (_q, sh) in zip(ckpt.tree_flatten(state),
                                         ckpt.tree_flatten(old))])
        stage = self._staging_dir()
        ckpt.save(stage, int(state.step), state, shardings=old)
        del state
        self._set_mesh(self.model, new_mesh)
        self._sh = None
        if self.active:
            self._sh = self._shardings(whole)
            like = whole if self._sh is None else place(whole, self._sh)
            _step, tree, _extra = ckpt.restore_latest(stage, like, self._sh)
            self.state = ckpt.tree_unflatten(tree, [
                x.to(self.device) for _p, x in ckpt.tree_flatten(tree)])
        dist = torch.distributed
        if dist.is_initialized() and dist.get_world_size() > 1:
            dist.barrier()
        if not dist.is_initialized() or dist.get_rank() == 0:
            shutil.rmtree(stage, ignore_errors=True)

    # ----------------------------------------------------------------- run
    def run(self, n_steps: int) -> Dict[str, Any]:
        if self.state is None and not self.active:
            return {"final_step": None, "final_loss": None,
                    "stragglers": 0}
        start = (self.initialize() if self.state is None
                 else int(self.state.step))
        prev_handlers = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                prev_handlers[sig] = signal.signal(sig, self._on_signal)
            except ValueError:
                pass  # not the main thread
        torn = False   # a step raised partway through its in-place update
        try:
            for step in range(start, n_steps):
                if self._stop:
                    break
                b = self.data.next_batch()
                batch = {k: torch.from_numpy(self._rows(v)).to(self.device)
                         for k, v in _arrays(b).items()}
                t0 = time.perf_counter()
                torn = True
                self.state, metrics = self._train_step(self.state, batch)
                # one read-back of every metric: the step's device time
                # (and the first sight of an error the card raised in it)
                vals = torch.stack([v.detach().float().reshape(())
                                    for v in metrics.values()]).tolist()
                torn = False
                metrics = dict(zip(metrics, vals))
                dt = time.perf_counter() - t0
                self._watchdog(step, dt)
                metrics.update(step=step, step_time_s=dt)
                self.metrics_log.append(metrics)
                if self.cfg.ckpt_dir and (step + 1) % self.cfg.ckpt_every == 0:
                    self._checkpoint(step + 1, sync=False)
        finally:
            if self.cfg.ckpt_dir and not torn:
                self._checkpoint(int(self.state.step), sync=True)
            ckpt.wait_pending()
            for sig, h in prev_handlers.items():
                signal.signal(sig, h)
        return {
            "final_step": int(self.state.step),
            "final_loss": (self.metrics_log[-1]["loss"] if self.metrics_log
                           else None),
            "stragglers": len(self.straggler_events),
        }

    # ------------------------------------------------------------- helpers
    def _checkpoint(self, step: int, sync: bool) -> None:
        extra = {}
        if hasattr(self.data, "state_dict"):
            extra["data"] = self.data.state_dict()
        fn = ckpt.save if sync else ckpt.save_async
        fn(self.cfg.ckpt_dir, step, self.state, extra=extra,
           keep=self.cfg.keep, shardings=self._sh)

    def _watchdog(self, step: int, dt: float) -> None:
        """EMA z-score straggler detection (the first step seeds it)."""
        if self._step_time_ema is None:
            self._step_time_ema = dt
            return
        mu = self._step_time_ema
        var = self._step_time_var
        sd = max(np.sqrt(var), 1e-4)
        z = (dt - mu) / sd
        if z > self.cfg.straggler_z and step > 2:
            self.straggler_events.append({"step": step, "dt": dt, "z": z})
        a = 0.1
        self._step_time_ema = (1 - a) * mu + a * dt
        self._step_time_var = (1 - a) * var + a * (dt - mu) ** 2

    def _on_signal(self, signum, frame) -> None:
        self._stop = True
