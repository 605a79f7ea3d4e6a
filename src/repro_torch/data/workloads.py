"""Workload generation (paper §4.1.1), numpy.

Own copy of ``repro.data.workloads``: bulk-load 50% of the dataset, then
run a request stream with a given query/insert mix.  Queried keys follow
a Zipfian distribution over the loaded keys; inserted keys come from the
not-yet-loaded half.  Requests are delivered in batches (paper §3.1).
Every mix runs on the port; the generator draws exactly as the JAX
package does.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

__all__ = ["WorkloadConfig", "Workload", "make_workload", "MIXES"]

MIXES = {
    "read_only": (1.0, 0.0),
    "read_heavy": (0.8, 0.2),
    "write_heavy": (0.2, 0.8),
    "write_only": (0.0, 1.0),
}


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    mix: str = "read_only"
    n_ops: int = 200_000
    batch_size: int = 256
    zipf_s: float = 0.99       # YCSB-style zipfian skew
    seed: int = 0


@dataclasses.dataclass
class Workload:
    load_keys: np.ndarray
    load_payloads: np.ndarray
    # request stream: op (0 read, 1 insert), key, payload per batch
    batches: List[Tuple[np.ndarray, np.ndarray, np.ndarray]]
    cfg: WorkloadConfig


def _zipf_indices(rng: np.random.Generator, n_items: int, size: int,
                  s: float) -> np.ndarray:
    """Zipfian ranks over [0, n_items) via inverse-CDF on a truncated zeta."""
    ranks = np.arange(1, n_items + 1, dtype=np.float64)
    w = ranks ** (-s)
    w /= w.sum()
    cdf = np.cumsum(w)
    u = rng.uniform(0, 1, size)
    idx = np.searchsorted(cdf, u, side="left")
    # scatter ranks over the key space deterministically (hot keys anywhere)
    perm = rng.permutation(n_items)
    return perm[np.clip(idx, 0, n_items - 1)]


def make_workload(keys: np.ndarray, cfg: WorkloadConfig) -> Workload:
    keys = np.asarray(keys, dtype=np.float64)
    n = keys.shape[0]
    rng = np.random.default_rng(cfg.seed)
    perm = rng.permutation(n)
    half = n // 2
    load_idx = np.sort(perm[:half])
    insert_idx = perm[half:]
    load_keys = keys[load_idx]
    load_payloads = load_idx.astype(np.int64)

    read_frac, _ = MIXES[cfg.mix]
    n_ops = cfg.n_ops
    ops = (rng.uniform(0, 1, n_ops) >= read_frac).astype(np.int8)  # 1=insert
    n_inserts = int(ops.sum())
    if n_inserts > insert_idx.shape[0]:
        reps = int(np.ceil(n_inserts / insert_idx.shape[0]))
        insert_idx = np.tile(insert_idx, reps)
    ins_order = insert_idx[:n_inserts]

    zipf = _zipf_indices(rng, load_idx.shape[0], n_ops - n_inserts, cfg.zipf_s)
    read_keys = load_keys[zipf]
    read_payloads = load_payloads[zipf]

    batches = []
    ri = ii = 0
    for start in range(0, n_ops, cfg.batch_size):
        cnt = min(cfg.batch_size, n_ops - start)
        op = ops[start : start + cnt]
        kbuf = np.empty(cnt, np.float64)
        pbuf = np.empty(cnt, np.int64)
        nr = int((op == 0).sum())
        ni = cnt - nr
        kbuf[op == 0] = read_keys[ri : ri + nr]
        pbuf[op == 0] = read_payloads[ri : ri + nr]
        kbuf[op == 1] = keys[ins_order[ii : ii + ni]]
        pbuf[op == 1] = ins_order[ii : ii + ni]
        ri += nr
        ii += ni
        batches.append((op, kbuf, pbuf))
    return Workload(load_keys, load_payloads, batches, cfg)
