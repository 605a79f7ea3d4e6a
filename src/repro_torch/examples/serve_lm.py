"""Serve a small model with batched requests: continuous batching, a
paged KV cache and the NFL page table (the paper's technique in the
serving data plane).

    python -m repro_torch.examples.serve_lm               # on the card
    python -m repro_torch.examples.serve_lm --device cpu  # plain versions

Port of ``examples/serve_lm.py``: qwen3-14b's smoke config with random
weights, 10 requests through ``ContinuousBatcher`` with 4 slots (its
decode attention through ``ops.flash_decode``), then a ``PagedKVCache``
over ``NFLPageTable`` with three sequences of 20 tokens, one gathered
back and one sequence's pages probed in one batched lookup.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models.model import build_model
from repro_torch.serve.kv_cache import PagedKVCache, PagedKVConfig
from repro_torch.serve.scheduler import ContinuousBatcher, Request, ServeConfig


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    cfg = get_config("qwen3-14b", smoke=True)
    model = build_model(cfg, device=args.device)
    dev = model.device
    params = model.init(torch.Generator(device=dev).manual_seed(0))

    # --- continuous batching over 10 concurrent requests
    batcher = ContinuousBatcher(model, params,
                                ServeConfig(batch_slots=4, max_len=96))
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab, 6).astype(np.int32),
                    max_new_tokens=12)
            for i in range(10)]
    for r in reqs:
        batcher.submit(r)
    t0 = time.perf_counter()
    batcher.run_until_drained()
    dt = time.perf_counter() - t0
    tok = sum(len(r.output) for r in reqs)
    print(f"continuous batching: {tok} tokens in {dt:.2f}s "
          f"({tok / dt:.0f} tok/s, {batcher.steps} steps) on {dev}")

    # --- paged KV cache backed by the NFL page table
    a = cfg.attn
    kv = PagedKVCache(PagedKVConfig(
        n_pages=256, page_size=8, n_layers=cfg.n_layers,
        kv_heads=a.kv_heads, head_dim=a.head_dim), device=dev)
    for sid in (101, 202, 303):
        kv.register_sequence(sid)
        g = torch.Generator(device=dev).manual_seed(sid)
        for _ in range(20):
            k = torch.randn((cfg.n_layers, a.kv_heads, a.head_dim),
                            generator=g, device=dev)
            kv.append(sid, k, k)
    k, v, n = kv.gather_kv(202)
    print(f"paged KV: gathered [{tuple(k.shape)}] for seq 202 (len={n})")
    print("NFL page-table stats:", kv.stats()["table"])
    # batched page-table probe: one vectorized lookup for 3 blocks
    pages = kv.lookup_pages(101, 3)
    print("pages of seq 101:", pages.tolist())


if __name__ == "__main__":
    main()
