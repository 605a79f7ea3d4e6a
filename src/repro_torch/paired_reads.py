"""Paired end-to-end read throughput of two checkouts of the port.

    python3 src/repro_torch/paired_reads.py OLD NEW [--pairs 10] [--shift 2]

``OLD`` and ``NEW`` are roots of two checkouts (each with ``src/
repro_torch``).  Each side runs in a process of its own: it bulk-loads
``longlat`` (2^23 >> shift keys, flow forced on) and ``lognormal``
(2^22 >> shift keys, flow off), half of each loaded, and times the
paper's read-only workload (64 batches of 65,536 zipf-0.99 reads through
``NFL.lookup_batch``) five times, checking every payload.  Pairs run in
turns, the side that goes first alternating, so a drift of the machine
over the run falls on both sides alike.  Prints one JSON line per side
(``AB {...}``) and a summary per dataset: each side's median of its
per-process medians, their interquartile range, and how many pairs the
new side won.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

BATCH = 65536
N_BATCHES = 64
PASSES = 5


def run_side(root: str, shift: int) -> dict:
    sys.path.insert(0, root + "/src")
    import torch
    from repro_torch.core.nfl import NFL, NFLConfig
    from repro_torch.data.datasets import make_dataset
    from repro_torch.data.workloads import WorkloadConfig, make_workload

    out = {"root": root}
    for name, n, force in (("longlat", (1 << 23) >> shift, True),
                           ("lognormal", (1 << 22) >> shift, False)):
        keys = make_dataset(name, n)
        wl = make_workload(keys, WorkloadConfig(
            mix="read_only", n_ops=N_BATCHES * BATCH, batch_size=BATCH,
            zipf_s=0.99, seed=0))
        nfl = NFL(NFLConfig(backend="flat", force_flow=force))
        t = time.perf_counter()
        nfl.bulkload(wl.load_keys, wl.load_payloads)
        torch.cuda.synchronize()
        bulk = time.perf_counter() - t
        rates = []
        for _ in range(PASSES):
            wrong = 0
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _op, k, p in wl.batches:
                wrong += int((nfl.lookup_batch(k) != p).sum())
            rates.append(N_BATCHES * BATCH / (time.perf_counter() - t))
            if wrong:
                raise SystemExit(f"{root} {name}: {wrong} wrong payloads")
        out[name] = {"bulk_s": bulk, "lookups_per_s": rates,
                     "median": statistics.median(rates)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("old")
    ap.add_argument("new", nargs="?")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--shift", type=int, default=2)
    ap.add_argument("--side", action="store_true",
                    help="run one side (OLD) in this process")
    args = ap.parse_args()
    if args.side:
        print("AB " + json.dumps(run_side(args.old, args.shift)), flush=True)
        return 0
    sides = {"old": [], "new": []}
    wins = {"longlat": 0, "lognormal": 0}
    for i in range(args.pairs):
        order = ("old", "new") if i % 2 == 0 else ("new", "old")
        got = {}
        for tag in order:
            root = args.old if tag == "old" else args.new
            r = subprocess.run(
                [sys.executable, __file__, root, "--side", "--shift",
                 str(args.shift)], capture_output=True, text=True, check=True)
            line = next(ln for ln in r.stdout.splitlines()
                        if ln.startswith("AB "))
            print(line, flush=True)
            got[tag] = json.loads(line[3:])
            sides[tag].append(got[tag])
        for ds in wins:
            wins[ds] += got["new"][ds]["median"] > got["old"][ds]["median"]
    for ds in wins:
        summary = {}
        for tag, runs in sides.items():
            med = [r[ds]["median"] for r in runs]
            q = statistics.quantiles(med, n=4) if len(med) > 1 else [0, 0, 0]
            summary[tag] = {"median": statistics.median(med),
                            "iqr": q[2] - q[0]}
        print(json.dumps({"dataset": ds, **summary,
                          "new_wins": wins[ds], "pairs": args.pairs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
