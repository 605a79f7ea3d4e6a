"""Serving launcher of the port: continuous-batching LM generation.

    python -m repro_torch.launch.serve --mode lm --arch falcon-mamba-7b
    python -m repro_torch.launch.serve --mode lm --device cpu   # no card

Port of ``repro.launch.serve``'s ``--mode lm``: loads a model at smoke
scale with random weights from ``--seed``, runs ``--requests`` generation
requests through the continuous batcher, and reports throughput.  Runs on
the card unless ``--device cpu``.  The ssm family's prefill goes through
the selective-scan kernel (``use_scan_kernel``; its plain version on the
CPU), not the chunked path the JAX launcher defaults to.  ``--mode index`` (the SLO front end
over the NFL index) ports with ROADMAP A12 and raises here.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch


def run_lm(args) -> None:
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.serve.scheduler import (ContinuousBatcher, Request,
                                             ServeConfig)

    cfg = get_config(args.arch, smoke=True)
    if cfg.ssm is not None:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, use_scan_kernel=True))
    model = build_model(cfg, device=args.device)
    gen = torch.Generator(device=model.device).manual_seed(args.seed)
    params = model.init(gen)
    batcher = ContinuousBatcher(model, params,
                                ServeConfig(batch_slots=args.slots,
                                            max_len=128))
    rng = np.random.default_rng(args.seed)
    reqs = []
    for rid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab, rng.integers(2, 12)).astype(np.int32)
        req = Request(rid=rid, prompt=prompt, max_new_tokens=args.max_new)
        reqs.append(req)
        batcher.submit(req)
    t0 = time.perf_counter()
    batcher.run_until_drained()
    dt = time.perf_counter() - t0
    total_tokens = sum(len(r.output) for r in reqs)
    print(f"served {len(reqs)} requests / {total_tokens} tokens "
          f"in {dt:.2f}s ({total_tokens / dt:.1f} tok/s, "
          f"{batcher.steps} decode steps) on {model.device}")
    for r in reqs[:3]:
        print(f"  req {r.rid}: prompt={r.prompt.tolist()} -> {r.output}")


def main(argv: Optional[Sequence[str]] = None) -> None:
    from repro_torch.configs import arch_names

    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="lm", choices=("lm", "index"),
                    help="lm: continuous-batching generation demo; "
                         "index: not ported yet (ROADMAP A12)")
    ap.add_argument("--arch", default="falcon-mamba-7b",
                    choices=arch_names())
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    if args.mode == "index":
        raise NotImplementedError(
            "--mode index (the SLO front end over the NFL index) is not "
            "ported to repro_torch yet (ROADMAP A12)")
    run_lm(args)


if __name__ == "__main__":
    main()
