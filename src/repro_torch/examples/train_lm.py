"""End-to-end example: train a ~40M-parameter LM for a few hundred steps.

    python -m repro_torch.examples.train_lm               # on the card
    python -m repro_torch.examples.train_lm --device cpu  # plain PyTorch

Port of ``examples/train_lm.py``: the internlm2 family at 8 layers of
d_model 512 (vocab 4,096, f32, no remat), the synthetic Markov corpus
(learnable n-gram structure), AdamW with a cosine schedule, a checkpoint
every 50 steps.  The loss must drop by more than 1 nat between the mean
of the first 5 steps and that of the last 5.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import tempfile
from typing import Optional, Sequence

from repro_torch.configs import get_config
from repro_torch.configs.base import AttnConfig
from repro_torch.data.tokens import SyntheticTokens
from repro_torch.models.model import build_model
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.schedule import ScheduleConfig
from repro_torch.train.train_step import TrainConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def lm_100m():
    base = get_config("internlm2-1.8b")
    return dataclasses.replace(
        base,
        n_layers=8,
        d_model=512,
        d_ff=2048,
        vocab=4096,
        attn=AttnConfig(n_heads=8, kv_heads=4, head_dim=64),
        param_dtype="float32",
        compute_dtype="float32",
        loss_chunk=64,
        remat="none",
        tie_embeddings=False,
    )  # ~34M backbone + embeddings ~8.4M


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--resume", action="store_true",
                    help="keep an existing checkpoint dir (default: fresh)")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    if not args.resume:
        shutil.rmtree(args.ckpt_dir, ignore_errors=True)

    cfg = lm_100m()
    model = build_model(cfg, device=args.device)
    print(f"params: {cfg.param_count() / 1e6:.1f}M")
    # near-deterministic latent chain: ~3.5 nats of learnable headroom
    # between the unigram floor and the band-conditional entropy
    data = SyntheticTokens(vocab=cfg.vocab, seq=args.seq,
                           local_batch=args.batch, seed=42,
                           n_states=32, alpha=0.03)
    trainer = Trainer(
        model,
        TrainerConfig(
            train=TrainConfig(
                optimizer=AdamWConfig(lr=3e-3, weight_decay=0.0),
                schedule=ScheduleConfig(peak_lr=3e-3, warmup_steps=30,
                                        total_steps=args.steps,
                                        min_ratio=0.5),
            ),
            ckpt_dir=args.ckpt_dir,
            ckpt_every=50,
        ),
        data,
    )
    out = trainer.run(args.steps)
    losses = [m["loss"] for m in trainer.metrics_log]
    first = sum(losses[:5]) / max(len(losses[:5]), 1)
    last = sum(losses[-5:]) / max(len(losses[-5:]), 1)
    print(f"steps={out['final_step']} loss first={first:.3f} "
          f"last={last:.3f} stragglers={out['stragglers']}")
    assert last < first - 1.0, f"model did not learn ({first:.2f}->{last:.2f})"
    print(f"OK: loss dropped by {first - last:.2f} nats (structure learned)")
    return {**out, "first": first, "last": last,
            "step_times_s": [m["step_time_s"] for m in trainer.metrics_log]}


if __name__ == "__main__":
    main()
