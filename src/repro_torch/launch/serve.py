"""Serving launcher of the port: continuous-batching LM generation, and
the SLO front end over the NFL index.

    python -m repro_torch.launch.serve --mode lm --arch qwen3-14b
    python -m repro_torch.launch.serve --mode lm --device cpu   # no card
    python -m repro_torch.launch.serve --mode index [--fault errors]
    python -m repro_torch.launch.serve --mode index --device cpu

Port of ``repro.launch.serve``.  ``--mode lm`` loads a model at smoke
scale with random weights from ``--seed``, runs ``--requests`` generation
requests through the continuous batcher, and reports throughput; every
text architecture serves (default ``internlm2-1.8b``, as in JAX).  The
vlm and encdec families need ``patches``/``frames`` in their prefill,
which the batcher never passes (nor does the JAX batcher, whose
launcher fails on them), so for those two the launcher raises a
``ValueError`` naming the missing input.  The Mamba1 prefill goes
through the selective-scan kernel (``use_scan_kernel``; its plain
version on the CPU), not the chunked path the JAX launcher defaults to;
the other families' decode attention goes through ``ops.flash_decode``
where its route is the kernel's (``models.attention``).  ``--mode index`` bulk-loads an NFL index
(flat backend, flow off, ``--shards``) and replays an open-loop Poisson
trace of point lookups with per-request deadlines through the SLO front
end, reporting goodput, shed and expired counts and latency percentiles;
``--fault`` replays it under an injected fault.  Both run on the card
unless ``--device cpu``, and raise without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch


# families whose prefill reads ``extra``: the input each needs
NEEDS_EXTRA = {"vlm": "patches", "encdec": "frames"}


def run_lm(args) -> None:
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.serve.scheduler import (ContinuousBatcher, Request,
                                             ServeConfig)

    cfg = get_config(args.arch, smoke=True)
    if cfg.family in NEEDS_EXTRA:
        raise ValueError(
            f"--mode lm cannot serve {args.arch}: the {cfg.family} family's "
            f"prefill needs extra['{NEEDS_EXTRA[cfg.family]}'], which the "
            "continuous batcher does not pass")
    if cfg.ssm is not None and cfg.ssm.version == 1:
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


def run_index(args) -> None:
    from repro_torch.core.nfl import NFL, NFLConfig
    from repro_torch.serve import faults
    from repro_torch.serve.frontend import (FrontEnd, FrontEndConfig,
                                            ServiceRequest)

    rng = np.random.default_rng(args.seed)
    keys = np.unique(rng.uniform(0.0, 1e6, 3 * args.n_keys))[:args.n_keys]
    nfl = NFL(NFLConfig(backend="flat", force_flow=False,
                        shards=args.shards), device=args.device)
    nfl.bulkload(keys, np.arange(keys.shape[0], dtype=np.int64))
    # warm the read path (the kernels' first launches, the pinned
    # buffers) so the trace measures serving
    for _ in range(3):
        nfl.lookup_batch(rng.choice(keys, args.batch, replace=False))

    fe = FrontEnd(nfl, FrontEndConfig(max_batch=args.batch,
                                      batch_timeout_s=args.timeout_ms / 1e3))
    qk = rng.choice(keys, args.requests)
    reqs = [ServiceRequest(i, "point", float(qk[i]),
                           deadline_s=args.slo_ms / 1e3)
            for i in range(args.requests)]
    arrivals = np.cumsum(rng.exponential(1.0 / args.rate, args.requests))

    plan = faults.FaultPlan(
        device_stall_s=1e-3 if args.fault == "stall" else 0.0,
        stall_every=4,
        dispatch_error_every=5 if args.fault == "errors" else 0)
    with faults.inject(plan):
        dur = fe.run_trace(reqs, arrivals)
    s = fe.stats()
    good = s["completed"] - s["completed_late"]
    print(f"replayed {len(reqs)} requests in {dur:.2f}s "
          f"(offered {args.rate:.0f} rps, slo {args.slo_ms:.1f}ms"
          f"{', fault=' + args.fault if args.fault else ''}) "
          f"on {nfl.device}")
    print(f"  goodput {good}/{len(reqs)} ({good / len(reqs):.1%})  "
          f"shed={s['shed']} expired={s['expired']} "
          f"late={s['completed_late']} retries={s['retries']}")
    lat = s["latency_ontime"]
    print(f"  on-time latency p50={lat['p50_ns'] / 1e6:.2f}ms "
          f"p99={lat['p99_ns'] / 1e6:.2f}ms "
          f"p999={lat['p999_ns'] / 1e6:.2f}ms")


def main(argv: Optional[Sequence[str]] = None) -> None:
    from repro_torch.configs import arch_names

    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="lm", choices=("lm", "index"),
                    help="lm: continuous-batching generation demo; "
                         "index: §16 SLO front end over the NFL index")
    ap.add_argument("--arch", default="internlm2-1.8b",
                    choices=arch_names())
    ap.add_argument("--requests", type=int, default=None)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    # --mode index knobs
    ap.add_argument("--n-keys", type=int, default=16_384)
    ap.add_argument("--shards", type=int, default=1)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--rate", type=float, default=2_000.0,
                    help="offered Poisson arrival rate (requests/s)")
    ap.add_argument("--slo-ms", type=float, default=50.0)
    ap.add_argument("--timeout-ms", type=float, default=2.0,
                    help="fill-or-timeout batch window")
    ap.add_argument("--fault", default="",
                    choices=("", "stall", "errors"),
                    help="replay the trace under an injected fault")
    args = ap.parse_args(argv)
    if args.requests is None:
        args.requests = 12 if args.mode == "lm" else 2_000
    if args.mode == "lm":
        run_lm(args)
    else:
        run_index(args)


if __name__ == "__main__":
    main()
