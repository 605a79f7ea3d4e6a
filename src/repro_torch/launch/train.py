"""Training launcher.

Port of ``repro.launch.train``, with the same arguments plus
``--layers`` (a depth cut) and ``--device``: the card by default
(raising without one), ``--device cpu`` for the plain PyTorch path.
``--mesh dxm:data,model`` builds a ``DeviceMesh`` over the launched
world (``launch.mesh``: one process a card and NCCL, gloo with
``--device cpu``; a launcher such as ``torchrun`` sets the world), and
the trainer runs the dense, moe, ssm or hybrid model on it
(every rank draws the whole batch and trains on its rows).
``--elastic-demo`` trains half the steps, re-meshes through
``Trainer.remesh`` onto the mesh halved along its first axis of even
size (a simulated node loss: the ranks past it stop), or onto the same
mesh where no axis halves (1x1), and continues.

Examples:
  python -m repro_torch.launch.train --arch internlm2-1.8b --steps 5 \\
      --seq 4096 --batch 8 --microbatches 2
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --steps 20 --ckpt-dir <dir>
  torchrun --nproc-per-node 4 -m repro_torch.launch.train --smoke \\
      --device cpu --mesh 2x2:data,model --elastic-demo
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Optional, Sequence

import torch

from repro_torch.configs import arch_names, get_config
from repro_torch.data.tokens import SyntheticTokens
from repro_torch.models.model import build_model
from repro_torch.train.optimizer import AdafactorConfig, AdamWConfig
from repro_torch.train.schedule import ScheduleConfig
from repro_torch.train.train_step import TrainConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def halved_mesh(shape, axes, device_type):
    """The mesh of ``shape`` halved along its first axis of even size
    (the same shape where none is), over the first ranks of the world."""
    from repro_torch.launch.mesh import make_mesh_shape

    shape = list(shape)
    for i, n in enumerate(shape):
        if n % 2 == 0:
            shape[i] = n // 2
            break
    return make_mesh_shape(tuple(shape), axes, device_type)


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b", choices=arch_names())
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--layers", type=int, default=None,
                    help="depth cut (default: the config's depth)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adafactor"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--mesh", default=None,
                    help="e.g. '1x1:data,model' to run on a device mesh")
    ap.add_argument("--elastic-demo", action="store_true",
                    help="re-mesh mid-run and continue (re-placement path)")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    model = build_model(cfg, device=args.device)
    if cfg.family in ("vlm", "encdec"):
        ap.error(f"{args.arch} ({cfg.family}) trains on patches or frames, "
                 "which the token pipeline does not make")
    data = SyntheticTokens(vocab=cfg.vocab, seq=args.seq,
                           local_batch=args.batch)
    opt = (AdafactorConfig(lr=args.lr) if args.optimizer == "adafactor"
           else AdamWConfig(lr=args.lr))
    mesh = axes = None
    if args.mesh:
        from repro_torch.launch.mesh import make_mesh_shape

        shape_s, axes_s = args.mesh.split(":")
        shape = tuple(int(x) for x in shape_s.split("x"))
        axes = tuple(axes_s.split(","))
        if model.device.type == "cuda":
            # one process a card: a launcher's LOCAL_RANK picks it
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        mesh = make_mesh_shape(shape, axes, model.device.type)

    trainer = Trainer(
        model,
        TrainerConfig(
            train=TrainConfig(optimizer=opt,
                              schedule=ScheduleConfig(
                                  peak_lr=args.lr, warmup_steps=10,
                                  total_steps=args.steps),
                              microbatches=args.microbatches),
            ckpt_dir=args.ckpt_dir,
            ckpt_every=args.ckpt_every,
        ),
        data,
        mesh=mesh,
    )
    if args.elastic_demo:
        out = trainer.run(args.steps // 2)
        new = mesh
        if mesh is not None:
            new = halved_mesh(shape, axes, model.device.type)
        print(f"[elastic] step {out['final_step']}: re-meshing "
              f"{'' if mesh is None else tuple(mesh.shape)} -> "
              f"{'' if new is None else tuple(new.shape)} (simulated node "
              f"loss) and continuing")
        trainer.remesh(new)
        out = trainer.run(args.steps)
    else:
        out = trainer.run(args.steps)
    print("train summary:", out)
    losses = [m["loss"] for m in trainer.metrics_log]
    if losses:
        print(f"loss: first={losses[0]:.4f} last={losses[-1]:.4f}")
    return trainer


if __name__ == "__main__":
    main()
