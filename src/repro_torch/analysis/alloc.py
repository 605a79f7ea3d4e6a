"""Contract 2 — the allocation budget over the capacity lattice
(DESIGN.md §15).

Port of ``repro.analysis.retrace``.  The card compiles nothing per shape
(``core/serving_state.py:25-28``), so the budget that can leak is not a
jit cache but device reallocation and rebuild work.  ``drive_lattice``
drives a flow-off ``FlatAFLI`` through the JAX drive's lattice
(``retrace.py:49-126``): every ``SERVE_BATCHES`` and ``SCAN_BATCHES``
size, tiers turning on, delta -> run merges, and a fold's trigger and
swap, with each read sweep served on both rungs.  It counts:

* ``DeviceTier._alloc`` per tier: at most one per capacity bucket that
  ``preallocate`` and growth declare (the running maximum of
  ``max(pow2_bucket(n + 1), min_capacity)`` over refreshes and
  preallocations: a capacity only grows, one allocation a bucket);
* router builds: at most one per ``(uploads, capacity)`` of the scan
  pool;
* ``build`` compiles and loads: at most one per source in the process.

A count over its budget is an ``alloc-budget`` finding at the call site
that allocated (``file.py:line``).  ``drive_lattice(tier_factory=...)``
swaps a broken tier in (``fixtures.RungReallocDeviceTier``).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from repro_torch.analysis.findings import Finding, Report

__all__ = ["SERVE_BATCHES", "SCAN_BATCHES", "drive_lattice",
           "run_alloc_checks", "check_rung_realloc_fixture"]

SERVE_BATCHES = (1, 33, 64, 65, 130, 200, 256, 400)
SCAN_BATCHES = (4, 64, 100)
SLOTS = ("run", "delta", "scan")
# the lattice's seed, the keys it builds and the delta tier's capacity
# (the JAX drive's)
LATTICE_SEED = 11
LATTICE_KEYS = 512
LATTICE_DELTA_CAP = 64


def _caller_site() -> str:
    from repro_torch.analysis.contracts import package_site

    return package_site() or "-"


@contextlib.contextmanager
def _spies(serving, record):
    """Patch ``DeviceTier._alloc``/``refresh``, ``ServingState
    .preallocate`` and ``build_router`` to record allocations, declared
    buckets and router builds of ``serving``'s tiers."""
    from repro_torch.core import serving_state as ss
    from repro_torch.kernels import streamed_lookup as sl

    slot_of = {id(getattr(serving, s)): s for s in SLOTS}
    real = (ss.DeviceTier._alloc, ss.DeviceTier.refresh,
            ss.ServingState.preallocate, sl.build_router)

    def declare(tier, need):
        s = slot_of.get(id(tier))
        if s is not None:
            cur = record["bucket"][s]
            if need > cur:
                record["bucket"][s] = need
                record["declared"][s].append(need)

    def alloc(self, cap):
        s = slot_of.get(id(self))
        if s is not None:
            record["allocs"][s].append((int(cap), _caller_site()))
        return real[0](self, cap)

    def refresh(self, pk, hi, lo, pv, window):
        declare(self, max(ss.pow2_bucket(int(pk.shape[0]) + 1),
                          self.min_capacity))
        return real[1](self, pk, hi, lo, pv, window)

    def preallocate(self, **floors):
        out = real[2](self, **floors)
        if self is serving:
            for s in SLOTS:
                declare(getattr(self, s), getattr(self, s).min_capacity)
        return out

    def build_router(pk):
        scan = serving.scan
        record["routers"].append(((scan.uploads, scan.capacity),
                                  _caller_site()))
        return real[3](pk)

    ss.DeviceTier._alloc, ss.DeviceTier.refresh = alloc, refresh
    ss.ServingState.preallocate = preallocate
    sl.build_router = build_router
    try:
        yield
    finally:
        (ss.DeviceTier._alloc, ss.DeviceTier.refresh,
         ss.ServingState.preallocate, sl.build_router) = real


def drive_lattice(*, device="cpu", tier_factory=None) -> dict:
    """Run the scripted lattice workload on ``device``; returns
    ``{"allocs": {slot: [(capacity, site), ...]}, "declared": {slot:
    [bucket, ...]}, "routers": [((uploads, capacity), site), ...],
    "index": the driven FlatAFLI}``.  ``tier_factory(device)`` makes the
    tiers (default: the real ``DeviceTier``)."""
    from repro_torch.core.flat_afli import FlatAFLI, FlatAFLIConfig

    delta_cap, n_build = LATTICE_DELTA_CAP, LATTICE_KEYS
    idx = FlatAFLI(FlatAFLIConfig(delta_cap=delta_cap), device=device)
    if tier_factory is not None:
        for slot in SLOTS:
            setattr(idx._serving, slot, tier_factory(idx.device))
    record = {"allocs": {s: [] for s in SLOTS},
              "declared": {s: [] for s in SLOTS},
              "bucket": {s: 0 for s in SLOTS}, "routers": []}
    fused_cfg = idx.cfg
    streamed_cfg = dataclasses.replace(idx.cfg, pool_budget=0)
    with _spies(idx._serving, record):
        rng = np.random.default_rng(LATTICE_SEED)
        keys = np.unique(rng.uniform(0.0, 1e6, 4 * n_build))[:n_build]
        pay = np.arange(keys.shape[0], dtype=np.int64)
        idx.build(keys, pay)

        def serve_sweep():
            for cfg in (fused_cfg, streamed_cfg):
                idx.cfg = cfg
                for n in SERVE_BATCHES:
                    idx.lookup_batch(keys[np.arange(n) % keys.shape[0]])
            idx.cfg = fused_cfg
            for n in SCAN_BATCHES:
                lo = keys[np.arange(n) % keys.shape[0]]
                idx.scan_batch(lo, lo + 1.0)

        # phase A: tiers empty
        serve_sweep()
        # phase B: writes walk the tier lattice — the delta fills, merges
        # into the run at delta_cap, and the fold trigger is crossed so
        # a fold starts, ticks and swaps mid-workload
        fresh = np.unique(rng.uniform(2e6, 3e6, 8 * delta_cap))
        step = max(delta_cap // 2, 1)
        for i in range(0, fresh.shape[0], step):
            batch = fresh[i:i + step]
            idx.insert_batch(batch,
                             np.arange(batch.shape[0], dtype=np.int64) + 50_000)
            idx.lookup_batch(batch[: min(8, batch.shape[0])])
        serve_sweep()
        # phase C: steady state after the fold
        idx.delete_batch(keys[:8])
        serve_sweep()
    record["index"] = idx
    del record["bucket"]
    return record


def _check_record(report: Report, record: dict, entry_prefix: str) -> None:
    for s in SLOTS:
        allocs, declared = record["allocs"][s], record["declared"][s]
        budget = len(set(declared))
        entry = f"{entry_prefix}[{s}]"
        if len(allocs) > budget:
            by_site = collections.Counter(site for _cap, site in allocs)
            for site, n in by_site.items():
                report.add(Finding(
                    contract="alloc-budget", entry=entry, location=site,
                    message=(f"over budget: {len(allocs)} allocations of the "
                             f"{s} tier against {budget} declared capacity "
                             f"buckets {sorted(set(declared))}; {n} from "
                             "this site — something other than the "
                             "declared buckets sizes the buffers (the "
                             "rung-crossing class)"),
                    details={"allocs": [c for c, _ in allocs],
                             "declared": declared, "at_site": n}))
        else:
            report.note_pass(entry, "alloc-budget")
    per_key = collections.Counter(k for k, _ in record["routers"])
    over = {k: n for k, n in per_key.items() if n > 1}
    if over:
        sites = collections.Counter(site for k, site in record["routers"]
                                    if k in over)
        for site, n in sites.items():
            report.add(Finding(
                contract="alloc-budget", entry=f"{entry_prefix}[router]",
                location=site,
                message=(f"router rebuilt for an unchanged scan pool: "
                         f"{dict(over)} builds per (uploads, capacity)"),
                details={"over": {str(k): v for k, v in over.items()}}))
    else:
        report.note_pass(f"{entry_prefix}[router]", "alloc-budget")


def check_loads(report: Report) -> Dict[str, Dict[str, int]]:
    """At most one compile and one load of each kernel library in this
    process (``build.load_counts``)."""
    from repro_torch.kernels import build

    counts = build.load_counts()
    bad = {k: {n: c for n, c in v.items() if c > 1}
           for k, v in counts.items()}
    for kind, names in bad.items():
        for name, c in names.items():
            report.add(Finding(
                contract="alloc-budget", entry=f"build.{kind}",
                location=f"{Path(build.__file__)}:1",
                message=(f"{name}: {c} times in one process (budget 1)"),
                details={"count": c}))
    if not any(bad.values()):
        report.note_pass("build.load", "alloc-budget")
    return counts


def run_alloc_checks(report: Optional[Report] = None, *,
                     device="cpu") -> dict:
    """Drive the lattice on ``device`` and hold every count to its
    budget; returns the counts."""
    report = report if report is not None else Report()
    record = drive_lattice(device=device)
    _check_record(report, record, "DeviceTier")
    loads = check_loads(report)
    st = record["index"].stats()["serving"]
    return {"allocs": {s: [c for c, _ in record["allocs"][s]]
                       for s in SLOTS},
            "declared": record["declared"],
            "router_builds": len(record["routers"]),
            "router_keys": len({k for k, _ in record["routers"]}),
            "stream_reuses": st["stream_reuses"], "loads": loads}


def check_rung_realloc_fixture(report: Report, device) -> None:
    """The lattice with ``RungReallocDeviceTier`` swapped in for every
    tier; its allocations must blow the declared budget."""
    from repro_torch.analysis.fixtures import RungReallocDeviceTier

    record = drive_lattice(device=device, tier_factory=RungReallocDeviceTier)
    _check_record(report, record, "fixture:rung-realloc")
