"""Training launcher.

Port of ``repro.launch.train``, with the same arguments plus
``--device``: the card by default (raising without one), ``--device
cpu`` for the plain PyTorch path.  ``--mesh 1x1:data,model`` builds a
``DeviceMesh`` over the launched world (``launch.mesh``; the shape's
product must be the world's size), and ``--elastic-demo`` trains half
the steps, re-places the state through ``Trainer.remesh`` (onto the same
mesh: one card has no smaller mesh to fall back to) and continues.

Examples:
  python -m repro_torch.launch.train --arch internlm2-1.8b --steps 5 \\
      --seq 4096 --batch 8 --microbatches 2
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --steps 20 --ckpt-dir <dir>
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from repro_torch.configs import arch_names, get_config
from repro_torch.data.tokens import SyntheticTokens
from repro_torch.models.model import build_model
from repro_torch.train.optimizer import AdafactorConfig, AdamWConfig
from repro_torch.train.schedule import ScheduleConfig
from repro_torch.train.train_step import TrainConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b", choices=arch_names())
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
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
    model = build_model(cfg, device=args.device)
    if cfg.family in ("vlm", "encdec"):
        ap.error(f"{args.arch} ({cfg.family}) trains on patches or frames, "
                 "which the token pipeline does not make")
    data = SyntheticTokens(vocab=cfg.vocab, seq=args.seq,
                           local_batch=args.batch)
    opt = (AdafactorConfig(lr=args.lr) if args.optimizer == "adafactor"
           else AdamWConfig(lr=args.lr))
    mesh = None
    if args.mesh:
        from repro_torch.launch.mesh import make_mesh_shape

        shape_s, axes_s = args.mesh.split(":")
        shape = tuple(int(x) for x in shape_s.split("x"))
        mesh = make_mesh_shape(shape, tuple(axes_s.split(",")),
                               model.device.type)

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
        print(f"[elastic] step {out['final_step']}: re-meshing "
              f"(simulated node loss) and continuing")
        trainer.remesh(mesh)
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
