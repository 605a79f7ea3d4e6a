"""The serving entry-point registry and the host-sync and launch-fact
contracts (DESIGN.md §15).

Port of ``repro.analysis.contracts``.  The registry names every serving
entry of the port with its declared host-sync budget and query extent.
Rather than reconstructing their signatures, the checker *captures* real
calls: it patches each registered binding with a transparent recorder
and drives a miniature serving world through the public API
(``exercise_serving_world``: a flow-off index with build, reads,
inserts, scans and deletes; the streamed rung forced by
``pool_budget``; a flow-on ``NFL(shards=2)`` with the reshard telemetry
on, inserts, async reads, scans and one boundary migration; a flow-on
``NFL`` with the re-flow on, driven through one drift episode to its
swap, single and sharded; the SLO front end's point, range, insert and
delete requests over the sharded ``NFL``).  An entry the world never dispatches is a
finding.

**Host sync.**  For the span of each entry call, the recorder patches the
calls that block the host on the card: ``Tensor.cpu``, ``.item``,
``.tolist``, ``.numpy``, ``.to`` and ``.copy_`` across the host without
``non_blocking``, ``Tensor.__bool__``, ``__int__`` and ``__float__``,
``torch.tensor`` and ``torch.as_tensor`` of host data on a named device
(the sync debug mode found these in ``flow.materialize_weights`` on
the card), and ``torch.cuda.synchronize``, ``Event.synchronize`` and
``Stream.synchronize``.  Each sync is charged to every entry call on the
stack at the first frame inside ``repro_torch`` (``file.py:line``).  On
the card a call counts when it crosses between host and card; on the CPU
(``device="cpu"``) the same call sites count, so the contract runs in
tier-1: an explicit ``.to(device)``, every ``.cpu()``, and a ``.numpy()``
of a tensor not fetched by ``.cpu()`` (the CPU's stand-in for a finisher's
wait).  The kernels' plain versions are the CPU's stand-ins for device
work, so on the CPU nothing inside a ``*_plain`` function counts.  A
call that goes over its entry's budget is a finding at each of its sync
sites: 0 for a dispatch (and ``DeviceTier.refresh``), 1 for a finish.  On the card each
entry also runs under ``torch.cuda.set_sync_debug_mode("warn")``; a sync
the debug mode reports where the recorder counted fewer is a finding at
the warning's location.

**Launch facts** (card only).  The world runs under ``torch.profiler``
with CUDA activity, each entry call in a ``record_function`` range.
Every launch of one of the repo's kernels is mapped to the entry call
that issued it (the launch's correlation id, the runtime event's time),
with its grid, block, shared memory and registers per thread.
``lint:batch-loop`` (B10's class): an entry's declared query extent over
the threads launched above the trip budget of 256 (``TRIP_BUDGET``, the
JAX ``EntryPoint.trip_budget``'s default), reported at the kernel's
``__global__`` line.  A profiled drive with no kernel event fails the contract.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import importlib
import inspect
import json
import sys
import warnings
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis.findings import Finding, Report

__all__ = ["EntryPoint", "ENTRY_POINTS", "HostSyncRecorder",
           "capture_entry_calls", "exercise_serving_world",
           "run_host_sync_checks", "parse_launch_facts", "check_launches",
           "check_host_fetch_fixture", "check_batch_loop_fixture",
           "kernel_lines", "package_file", "package_site", "trace_events"]

TRIP_BUDGET = 256
# the serving world: its seed, the keys of each index it builds (the JAX
# world's sizes) and the flow-on NFL's shards
WORLD_SEED = 7
WORLD_KEYS = 512
WORLD_SHARDS = 2
_PKG = Path(__file__).resolve().parents[1]
_SELF = str(Path(__file__).resolve())
# the checker's own modules: no sync or allocation is charged to them
_CHECKER = {_SELF, str(Path(__file__).resolve().with_name("alloc.py"))}
_WHERE: Dict[str, Optional[str]] = {}


def package_file(filename: str) -> Optional[str]:
    """The resolved path of a code object's file when it lies inside
    ``repro_torch`` (imported through any path spelling), else None."""
    hit = _WHERE.get(filename, "")
    if hit == "":
        path = Path(filename).resolve()
        hit = str(path) if _PKG in path.parents else None
        _WHERE[filename] = hit
    return hit


def package_site(skip_plain: bool = False) -> Optional[str]:
    """``file.py:line`` of the innermost frame of the caller's stack
    inside ``repro_torch`` and outside the checker's own modules, or
    None if there is none.  With ``skip_plain``, also None when the call
    sits inside a kernel's plain version (on the CPU, the stand-in for
    device work)."""
    f = sys._getframe(1)
    site = None
    while f is not None:
        fn = package_file(f.f_code.co_filename)
        if fn is not None and fn not in _CHECKER:
            if site is None:
                site = f"{fn}:{f.f_lineno}"
                if not skip_plain:
                    return site
            if f.f_code.co_name.endswith("_plain"):
                return None
        f = f.f_back
    return site


def _arg(i: int) -> Callable:
    """Query extent: the length of positional argument ``i``."""
    def extent(args, kwargs):
        return int(len(args[i])) if len(args) > i else None
    return extent


@dataclasses.dataclass(frozen=True)
class EntryPoint:
    """One registered serving entry.  ``attr`` may name a method
    (``"FlatAFLI.lookup_batch"``); ``bindings`` lists every other
    ``(module, attr)`` where the function is bound at call time (a
    ``from x import f`` in a caller).  ``budget``: host syncs allowed per
    call; ``finish_budget``: the returned finisher is an entry too
    (``name + ":finish"``) with that budget.  ``select`` picks the calls
    of a shared binding that this entry covers."""

    name: str
    module: str
    attr: str
    budget: int
    extent: Optional[Callable] = None
    select: Optional[Callable] = None
    finish_budget: Optional[int] = None
    bindings: Tuple[Tuple[str, str], ...] = ()

    def _owner_and_name(self, module: str, attr: str):
        obj = importlib.import_module(module)
        *path, name = attr.split(".")
        for p in path:
            obj = getattr(obj, p)
        return obj, name

    def target(self) -> Callable:
        owner, name = self._owner_and_name(self.module, self.attr)
        return getattr(owner, name)

    def location(self) -> str:
        fn = inspect.unwrap(self.target())
        try:
            return (f"{inspect.getsourcefile(fn)}:"
                    f"{inspect.getsourcelines(fn)[1]}")
        except (TypeError, OSError):
            return f"{self.module}.{self.attr}"


_FL, _SD = "repro_torch.core.flat_afli", "repro_torch.core.sharded_nfl"
_OPS = "repro_torch.kernels.ops"
_DRIFT = "repro_torch.core.drift"

ENTRY_POINTS: Tuple[EntryPoint, ...] = (
    EntryPoint("ops.fused_lookup[fused]", _OPS, "fused_lookup", budget=0,
               extent=_arg(1),
               select=lambda a, k: k.get("stream") is None),
    EntryPoint("ops.fused_lookup[streamed]", _OPS, "fused_lookup", budget=0,
               extent=_arg(1),
               select=lambda a, k: k.get("stream") is not None),
    EntryPoint("ops.fused_range_scan", _OPS, "fused_range_scan", budget=0,
               extent=_arg(2)),
    EntryPoint("shard_dispatch.route_flow", "repro_torch.kernels.shard_dispatch",
               "route_flow", budget=1, extent=_arg(0),
               bindings=((_SD, "route_flow"),)),
    EntryPoint("DeviceTier.refresh", "repro_torch.core.serving_state",
               "DeviceTier.refresh", budget=0, extent=_arg(1)),
    EntryPoint("ops.nf_transform_keys", _OPS, "nf_transform_keys", budget=1,
               extent=_arg(2)),
    EntryPoint("FlatAFLI.lookup_batch", _FL, "FlatAFLI.lookup_batch",
               budget=1, extent=_arg(1)),
    EntryPoint("FlatAFLI.lookup_batch_async", _FL,
               "FlatAFLI.lookup_batch_async", budget=0, finish_budget=1,
               extent=_arg(1)),
    EntryPoint("FlatAFLI.scan_batch", _FL, "FlatAFLI.scan_batch", budget=1,
               extent=_arg(1)),
    EntryPoint("FlatAFLI.insert_batch", _FL, "FlatAFLI.insert_batch",
               budget=0, extent=_arg(1)),
    EntryPoint("FlatAFLI.delete_batch", _FL, "FlatAFLI.delete_batch",
               budget=0, extent=_arg(1)),
    EntryPoint("ShardedFlatAFLI._fanout_points_async", _SD,
               "ShardedFlatAFLI._fanout_points_async", budget=0,
               finish_budget=1, extent=_arg(1)),
    EntryPoint("ShardedFlatAFLI._fanout_scan", _SD,
               "ShardedFlatAFLI._fanout_scan", budget=1, extent=_arg(1)),
    # the re-flow (DESIGN.md §14): a re-key brings the re-keyed z back
    # once, a drift tick the sample's z once
    EntryPoint("FlatAFLI.start_reflow", _FL, "FlatAFLI.start_reflow",
               budget=1),
    EntryPoint("ReflowManager.tick", _DRIFT, "ReflowManager.tick",
               budget=1),
    # the sharded episodes (DESIGN.md §14, §18): a cross-shard re-key
    # brings the re-keyed z back once; a migration's freeze and its
    # boundary splice bring nothing back (the splice uploads P-1 floats
    # without a sync), nor does a reshard tick
    EntryPoint("ShardedFlatAFLI.start_reflow", _SD,
               "ShardedFlatAFLI.start_reflow", budget=1),
    EntryPoint("ShardedFlatAFLI.start_reshard", _SD,
               "ShardedFlatAFLI.start_reshard", budget=0),
    EntryPoint("ShardedFlatAFLI._refresh_boundaries", _SD,
               "ShardedFlatAFLI._refresh_boundaries", budget=0),
    EntryPoint("ReshardManager.tick", _DRIFT, "ReshardManager.tick",
               budget=0),
    # the SLO front end (DESIGN.md §16): gathering the oldest read batch
    # in flight calls its finisher, whose one wait is the copy's event
    EntryPoint("FrontEnd._gather_oldest", "repro_torch.serve.frontend",
               "FrontEnd._gather_oldest", budget=1),
)


# ------------------------------------------------------ host-sync recorder
class _Call:
    """One entry call in flight: its syncs by site, as the recorder and
    as the debug mode saw them."""

    def __init__(self, entry: EntryPoint, name: str, budget: int, extent):
        self.entry, self.name, self.budget = entry, name, budget
        self.extent = extent
        self.syncs: collections.Counter = collections.Counter()
        self.warned: collections.Counter = collections.Counter()


class HostSyncRecorder:
    """Counts host syncs per entry call (see the module docstring) and
    keeps, per entry, the calls, syncs and debug-mode warnings seen.
    ``install()`` patches torch for the recorder's life (a context
    manager); ``debug=True`` also turns on the card's sync debug mode."""

    def __init__(self, device: torch.device, debug: bool = False):
        self.world = torch.device(device).type
        self.debug = debug
        self.stack: List[_Call] = []       # entry calls in flight
        self.stats: Dict[str, dict] = {}
        self.calls: List[_Call] = []

    def _charge(self, kind: str) -> None:
        if not self.stack:
            return
        # a plain version stands in for device work only on the CPU: on
        # the card a sync under one counts, and so does every warning
        site = package_site(skip_plain=self.world == "cpu")
        if site is None:
            return
        for call in self.stack:
            getattr(call, kind)[site] += 1

    def _crosses(self, src: torch.device, dst) -> bool:
        dst = torch.device(dst)
        if self.world == "cpu":
            return True
        return {src.type, dst.type} == {"cpu", "cuda"}

    @contextlib.contextmanager
    def install(self):
        rec = self
        T = torch.Tensor
        saved = {n: getattr(T, n) for n in (
            "cpu", "item", "tolist", "numpy", "to", "copy_", "__bool__",
            "__int__", "__float__")}
        own = {n for n in saved if n in T.__dict__}
        saved_cuda = (torch.cuda.synchronize, torch.cuda.Event.synchronize,
                      torch.cuda.Stream.synchronize)
        saved_new = (torch.tensor, torch.as_tensor)

        def on_world(t):
            return t.device.type == rec.world

        def cpu(self, *a, **k):
            if rec.world == "cpu" or self.device.type == "cuda":
                rec._charge("syncs")
                if rec.world == "cpu":
                    self._host_fetched = True
            return saved["cpu"](self, *a, **k)

        def numpy(self, *a, **k):
            if rec.world == "cpu" and not getattr(self, "_host_fetched",
                                                  False):
                rec._charge("syncs")
            return saved["numpy"](self, *a, **k)

        def scalar(name):
            def fn(self, *a, **k):
                if on_world(self):
                    rec._charge("syncs")
                return saved[name](self, *a, **k)
            return fn

        def to(self, *a, **k):
            dev = k.get("device")
            for x in a:
                if isinstance(x, (torch.device, str)):
                    dev = x
                elif isinstance(x, torch.Tensor):
                    dev = x.device
            blocking = not (k.get("non_blocking", False)
                            or any(x is True for x in a))
            if dev is not None and blocking and rec._crosses(self.device, dev):
                rec._charge("syncs")
            return saved["to"](self, *a, **k)

        def copy_(self, src, non_blocking=False):
            if (rec.world == "cuda" and not non_blocking
                    and {self.device.type, src.device.type}
                    == {"cpu", "cuda"}):
                rec._charge("syncs")
            return saved["copy_"](self, src, non_blocking)

        def new(real):
            # a tensor made from host data on a named device: a copy to
            # the card that waits for it
            def fn(data, *a, **k):
                dev = k.get("device")
                src = (data.device if isinstance(data, torch.Tensor)
                       else torch.device("cpu"))
                if dev is not None and rec._crosses(src, dev):
                    rec._charge("syncs")
                return real(data, *a, **k)
            return fn

        def wait(real):
            def fn(*a, **k):
                rec._charge("syncs")
                return real(*a, **k)
            return fn

        patches = {"cpu": cpu, "numpy": numpy, "to": to, "copy_": copy_,
                   **{n: scalar(n) for n in ("item", "tolist", "__bool__",
                                             "__int__", "__float__")}}
        for n, fn in patches.items():
            setattr(T, n, fn)
        torch.cuda.synchronize = wait(saved_cuda[0])
        torch.cuda.Event.synchronize = wait(saved_cuda[1])
        torch.cuda.Stream.synchronize = wait(saved_cuda[2])
        torch.tensor, torch.as_tensor = (new(f) for f in saved_new)
        old_show = warnings.showwarning
        try:
            with warnings.catch_warnings():
                warnings.filterwarnings(
                    "always", message=".*synchronizing CUDA operation")
                if self.debug:
                    warnings.showwarning = self._on_warning
                    torch.cuda.set_sync_debug_mode("warn")
                yield self
        finally:
            if self.debug:
                torch.cuda.set_sync_debug_mode(0)
            warnings.showwarning = old_show
            for n, fn in saved.items():
                if n in own:
                    setattr(T, n, fn)
                else:
                    delattr(T, n)
            (torch.cuda.synchronize, torch.cuda.Event.synchronize,
             torch.cuda.Stream.synchronize) = saved_cuda
            torch.tensor, torch.as_tensor = saved_new

    def _on_warning(self, message, category, filename, lineno, file=None,
                    line=None):
        if "synchronizing CUDA operation" in str(message):
            self._charge("warned")

    # -- entry calls
    def enter(self, entry: EntryPoint, name: str, budget: int, extent):
        call = _Call(entry, name, budget, extent)
        self.stack.append(call)
        self.calls.append(call)
        return call

    def leave(self, call: _Call, report: Report) -> None:
        self.stack.pop()
        st = self.stats.setdefault(call.name, {
            "calls": 0, "budget": call.budget, "syncs": 0, "debug_syncs": 0,
            "max_per_call": 0})
        n, w = sum(call.syncs.values()), sum(call.warned.values())
        st["calls"] += 1
        st["syncs"] += n
        st["debug_syncs"] += w
        st["max_per_call"] = max(st["max_per_call"], n)
        if n > call.budget:
            for site, c in call.syncs.items():
                report.add(Finding(
                    contract="host-sync", entry=call.name, location=site,
                    message=(f"over budget: {n} host syncs in one call "
                             f"against a budget of {call.budget}; {c} at "
                             "this site"),
                    details={"syncs": n, "budget": call.budget,
                             "at_site": c}))
        for site, c in call.warned.items():
            if c > call.syncs.get(site, 0):
                report.add(Finding(
                    contract="host-sync", entry=call.name, location=site,
                    message=("missed by the recorder: the sync debug mode "
                             f"reports {c} syncs here, the recorder "
                             f"{call.syncs.get(site, 0)}"),
                    details={"debug": c,
                             "recorder": call.syncs.get(site, 0)}))


# ------------------------------------------------------------- capture
@contextlib.contextmanager
def capture_entry_calls(entries, recorder: HostSyncRecorder, report: Report,
                        profile: bool = False):
    """Patch every registered binding with a transparent recorder for the
    block's span; yields ``{entry name: calls}``.  Each call is an entry
    call on ``recorder``'s stack (and, with ``profile``, a
    ``record_function`` range named ``entry:<name>#<call index>``)."""
    counts = collections.Counter()
    groups: Dict[Tuple[str, str], List[EntryPoint]] = collections.OrderedDict()
    for e in entries:
        groups.setdefault((e.module, e.attr), []).append(e)
    originals = []

    def run_call(entry, name, budget, extent, real, args, kwargs):
        call = recorder.enter(entry, name, budget, extent)
        counts[name] += 1
        ctx = contextlib.nullcontext()
        if profile:
            from torch.profiler import record_function

            ctx = record_function(f"entry:{name}#{len(recorder.calls) - 1}")
        try:
            with ctx:
                out = real(*args, **kwargs)
        finally:
            recorder.leave(call, report)
        if entry.finish_budget is not None and callable(out):
            fin = out

            def finish():
                return run_call(entry, f"{entry.name}:finish",
                                entry.finish_budget, extent, fin, (), {})
            return finish
        return out

    try:
        for (module, attr), group in groups.items():
            real = group[0].target()

            def wrapper(*args, _group=group, _real=real, **kwargs):
                for e in _group:
                    if e.select is None or e.select(args, kwargs):
                        ext = e.extent(args, kwargs) if e.extent else None
                        return run_call(e, e.name, e.budget, ext, _real,
                                        args, kwargs)
                return _real(*args, **kwargs)

            # the function's attributes (launch and truncation counters)
            # stay one dict while it is patched
            if not isinstance(real, type) and hasattr(real, "__dict__"):
                wrapper.__dict__ = real.__dict__
            for mod, at in ((module, attr), *group[0].bindings):
                owner, name = group[0]._owner_and_name(mod, at)
                originals.append((owner, name, owner.__dict__[name]
                                  if isinstance(owner, type)
                                  else getattr(owner, name)))
                setattr(owner, name, wrapper)
        yield counts
    finally:
        for owner, name, real in reversed(originals):
            setattr(owner, name, real)


def exercise_serving_world(device):
    """Drive a miniature serving world through the public API so every
    registered entry dispatches (the JAX world's sizes,
    ``repro/analysis/contracts.py:157-256``): a flow-off index (build,
    reads, inserts, a scan batch, deletes); a larger flow-off index read
    on the streamed rung, forced by ``pool_budget=0``, before and after
    inserts; then a flow-on ``NFL(shards=2)`` with inserts, async reads
    and scans, its reshard manager ticking (telemetry only: the
    migration is started by hand), then the JAX world's migration step
    (``start_reshard(0, shards - 1)``, ``rebuild()``, a read); then one
    re-flow episode on a single index and one on ``shards=2``
    (``reflow_episode``).  Between the two, the JAX world's front-end
    leg: point, range, insert and delete requests through ``FrontEnd``
    over the flow-on ``NFL(shards=2)``.  The JAX world's oracle index has
    no counterpart (not ported, by design)."""
    from repro_torch.core.drift import ReshardConfig
    from repro_torch.core.flat_afli import FlatAFLI, FlatAFLIConfig
    from repro_torch.core.nfl import NFL, NFLConfig
    from repro_torch.core.train_flow import FlowTrainConfig

    n_build = WORLD_KEYS
    rng = np.random.default_rng(WORLD_SEED)
    keys = np.unique(rng.uniform(0.0, 1e6, 4 * n_build))[:n_build]
    pay = np.arange(keys.shape[0], dtype=np.int64)
    idx = FlatAFLI(FlatAFLIConfig(), device=device)
    idx.build(keys, pay)
    idx.lookup_batch(keys[:100])
    new = np.unique(rng.uniform(2e6, 3e6, 96))
    idx.insert_batch(new, np.arange(new.shape[0], dtype=np.int64) + 10_000)
    idx.lookup_batch(np.concatenate([keys[:50], new[:20]]))
    idx.scan_batch(keys[:16], keys[16:32])
    idx.delete_batch(keys[:4])
    idx.lookup_batch(keys[:8])

    keys4 = np.unique(rng.uniform(0.0, 1e6, 4 * 4096))[:4096]
    sidx = FlatAFLI(FlatAFLIConfig(delta_cap=64), device=device)
    sidx.build(keys4, np.arange(keys4.shape[0], dtype=np.int64))
    sidx.lookup_batch(keys4[:64])
    sidx.cfg = dataclasses.replace(sidx.cfg, pool_budget=0)
    sidx.lookup_batch(keys4[:64])
    if sidx.last_dispatch.get("path") != "streamed":
        raise RuntimeError(f"the streamed rung did not serve: "
                           f"{sidx.last_dispatch}")
    snew = np.unique(rng.uniform(4e6, 5e6, 48))
    sidx.insert_batch(snew, np.arange(snew.shape[0], dtype=np.int64) + 40_000)
    sidx.lookup_batch(np.concatenate([keys4[:24], snew[:8]]))

    nfl = NFL(NFLConfig(backend="flat", shards=WORLD_SHARDS, force_flow=True,
                        flow_train=FlowTrainConfig(epochs=2),
                        reshard=ReshardConfig(enabled=True, migrate=False)),
              device=device)
    keys2 = np.unique(rng.normal(5e5, 1e5, 2 * n_build))[:n_build]
    nfl.bulkload(keys2, np.arange(keys2.shape[0], dtype=np.int64))
    nfl.lookup_batch(keys2[:128])
    new2 = np.unique(rng.normal(8e5, 1e4, 64))
    nfl.insert_batch(new2, np.arange(new2.shape[0], dtype=np.int64) + 20_000)
    finish = nfl.lookup_batch_async(np.concatenate([keys2[:32], new2[:16]]))
    finish()
    nfl.scan_batch(keys2[:8], keys2[8:16])
    # the migration: the swap's boundary splice runs between two serving
    # batches; rebuild() drives the window's folds to the swap
    if not nfl.index.start_reshard(0, WORLD_SHARDS - 1, on_swap=lambda: None):
        raise RuntimeError("the world's migration did not start")
    nfl.index.rebuild()
    if nfl.index.n_reshards != 1:
        raise RuntimeError("the world's migration did not swap")
    nfl.lookup_batch(keys2[:32])
    frontend_leg(nfl, keys2, rng)
    reflow_episode(device, rng)
    reflow_episode(device, rng, shards=WORLD_SHARDS)
    return idx, nfl


def frontend_leg(nfl, keys, rng) -> None:
    """The JAX world's front-end leg (``repro/analysis/contracts.py:
    228-254``): point, range, insert and delete requests through the SLO
    front end over ``nfl``, so the checker sees the batch shapes the
    continuous loop forms, not only the hand-batched calls."""
    from repro_torch.serve.frontend import (FrontEnd, FrontEndConfig,
                                            ServiceRequest)

    fe = FrontEnd(nfl, FrontEndConfig(max_batch=32, batch_timeout_s=1e-4,
                                      admission=False, expire_queued=False))
    spare = np.unique(rng.normal(9e5, 1e3, 24))
    rid = 0
    for i in range(0, 64, 16):
        for k in keys[i:i + 16]:
            fe.submit(ServiceRequest(rid, "point", float(k),
                                     deadline_s=60.0))
            rid += 1
        lo = float(keys[i])
        fe.submit(ServiceRequest(rid, "range", lo, hi=lo * (1 + 1e-4),
                                 deadline_s=60.0))
        rid += 1
    for j, k in enumerate(spare):
        fe.submit(ServiceRequest(rid, "insert", float(k),
                                 payload=30_000 + j, deadline_s=60.0))
        rid += 1
    fe.submit(ServiceRequest(rid, "delete", float(keys[0]),
                             deadline_s=60.0))
    fe.drain()


def reflow_episode(device, rng, shards: int = 1):
    """One drift episode on a flow-on ``NFL`` with the re-flow on, driven
    through the public API to its swap: inserts in tight micro-clusters
    at high quantiles of the loaded keys (``bench_drift.py``'s traffic),
    which the stale flow packs into a few slots and a flow retrained on
    the reservoir spreads; no threshold, so the first check triggers.
    With ``shards > 1`` the episode is the cross-shard re-key.  Returns
    the NFL."""
    from repro_torch.core.drift import DriftConfig
    from repro_torch.core.flat_afli import FlatAFLIConfig
    from repro_torch.core.nfl import NFL, NFLConfig
    from repro_torch.core.train_flow import FlowTrainConfig

    nfl = NFL(NFLConfig(
        backend="flat", shards=shards, force_flow=True,
        flow_train=FlowTrainConfig(epochs=1),
        flat_index=FlatAFLIConfig(fold_step_keys=256),
        drift=DriftConfig(reflow=True, threshold=0.0, min_tail=0,
                          check_every=512, sample_size=512,
                          window_keys=1024, cooldown_keys=512,
                          train_epochs=1, train_batch=128,
                          steps_per_tick=8, conflicts_decay=0.0)),
              device=device)
    keys = np.unique(rng.lognormal(0.0, 2.0, 2 * WORLD_KEYS))[:WORLD_KEYS]
    nfl.bulkload(keys, np.arange(keys.shape[0], dtype=np.int64))
    centers = np.quantile(keys, np.linspace(0.80, 0.999, 16))
    for b in range(64):
        new = np.unique(np.repeat(centers, 16)
                        * (1 + rng.uniform(0, 1e-4, 256)))
        nfl.insert_batch(new, np.arange(new.shape[0], dtype=np.int64)
                         + 50_000 + 1_000 * b)
        if nfl._reflow.reflows_completed:
            break
    if not nfl._reflow.reflows_completed:
        raise RuntimeError(f"the re-flow episode did not swap: "
                           f"{nfl._reflow.stats()}")
    nfl.lookup_batch(keys[:64])
    return nfl


# --------------------------------------------------------- launch facts
def kernel_lines() -> Dict[str, str]:
    """``{kernel name: "file.cu:line" of its __global__}`` over every
    source of the build (serving kernels and fixtures)."""
    from repro_torch.kernels.build import EXTRA_SOURCES, SOURCES, source_path
    from repro_torch.utils.ptx import global_lines

    out: Dict[str, str] = {}
    for name in (*SOURCES, *EXTRA_SOURCES):
        out.update(global_lines(source_path(name)))
    return out


def parse_launch_facts(events: List[dict], kernels) -> List[dict]:
    """Launches of the named kernels in a chrome trace (Kineto's JSON
    events), in launch order: ``{"kernel", "symbol", "call" (the
    innermost ``entry:<name>#<i>`` range around the launch, or None),
    "grid", "block", "smem", "regs"}``.  A kernel event is tied to its
    launch by its correlation id, the launch to a range by time."""
    from repro_torch.utils.ptx import kernel_base_name

    launch_ts = {}
    for e in events:
        args = e.get("args") or {}
        if e.get("cat") == "cuda_runtime" and "correlation" in args:
            launch_ts.setdefault(args["correlation"], e.get("ts"))
    ranges = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                     e["name"]) for e in events
                    if e.get("cat") == "user_annotation"
                    and str(e.get("name", "")).startswith("entry:"))
    facts = []
    for e in events:
        if e.get("cat") != "kernel":
            continue
        base = kernel_base_name(e.get("name", ""))
        if base not in kernels:
            continue
        args = e.get("args") or {}
        ts = launch_ts.get(args.get("correlation"))
        call = None
        if ts is not None:
            inside = [r for r in ranges if r[0] <= float(ts) <= r[1]]
            if inside:
                call = max(inside)[2]
        facts.append({"kernel": base, "symbol": e.get("name"), "call": call,
                      "correlation": args.get("correlation"),
                      "grid": list(args.get("grid", [])),
                      "block": list(args.get("block", [])),
                      "smem": args.get("shared memory"),
                      "regs": args.get("registers per thread")})
    facts.sort(key=lambda f: (f["correlation"] is None, f["correlation"]))
    return facts


def trace_events(prof) -> List[dict]:
    from repro_torch.kernels.build import build_dir

    path = build_dir() / "analysis" / "trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    data = json.loads(path.read_text())
    return data["traceEvents"] if isinstance(data, dict) else data


def check_launches(report: Report, facts: List[dict],
                   calls: List[_Call]) -> None:
    """``lint:batch-loop`` over launch facts: the entry call's declared
    extent over the launch's threads above the entry's trip budget."""
    lines = kernel_lines()
    if not facts:
        report.add(Finding(
            contract="lint:batch-loop", entry="profiler", location=_SELF,
            message=("profiler recorded no kernel event: launch facts "
                     "cannot be checked"), details={}))
        return
    for f in facts:
        if f["call"] is None:
            continue
        name, _, i = f["call"][len("entry:"):].rpartition("#")
        call = calls[int(i)]
        threads = int(np.prod(f["grid"] or [0])) * int(np.prod(
            f["block"] or [0]))
        f["entry"], f["extent"], f["threads"] = name, call.extent, threads
        budget = TRIP_BUDGET
        if call.extent and threads and call.extent / threads > budget:
            report.add(Finding(
                contract="lint:batch-loop", entry=name,
                location=lines.get(f["kernel"], f["kernel"]),
                message=(f"batch-length loop: `{f['kernel']}` launched "
                         f"{threads} threads for {call.extent} queries, "
                         f"{call.extent / threads:.0f} a thread against "
                         f"the {budget}-trip budget (B10's class): a loop "
                         "over the batch runs in series what a grid runs "
                         "in parallel"),
                details={"grid": f["grid"], "block": f["block"],
                         "extent": call.extent, "threads": threads,
                         "budget": budget}))
        else:
            report.note_pass(name, "lint:batch-loop")


# ------------------------------------------------------------- runs
def run_host_sync_checks(report: Report, device, *, entries=ENTRY_POINTS,
                         world: Optional[Callable] = None,
                         profile: Optional[bool] = None) -> dict:
    """Drive the serving world under the recorder (and, on the card, the
    sync debug mode and the profiler); add the host-sync findings, an
    undispatched-entry finding per registered entry the world never
    reached, and on the card the launch facts' ``lint:batch-loop``.
    Returns ``{"syncs": per-entry stats, "launches": launch facts}``."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    profile = on_card if profile is None else profile
    rec = HostSyncRecorder(device, debug=on_card)
    world = world or (lambda: exercise_serving_world(device))
    prof_ctx = contextlib.nullcontext()
    if profile:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as _profile

        prof_ctx = _profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
    with prof_ctx as prof:
        with rec.install(), capture_entry_calls(entries, rec, report,
                                                profile=profile) as counts:
            world()
        if on_card:
            torch.cuda.synchronize()
    for e in entries:
        if not counts.get(e.name):
            report.add(Finding(
                contract="host-sync", entry=e.name, location=e.location(),
                message=(f"entry `{e.module}.{e.attr}` was never dispatched "
                         "by the serving world: the registry and the "
                         "serving path have drifted apart — fix the world "
                         "or retire the entry"), details={"calls": 0}))
        elif rec.stats.get(e.name, {}).get("max_per_call", 0) <= e.budget:
            report.note_pass(e.name, "host-sync")
    facts: List[dict] = []
    if profile:
        facts = parse_launch_facts(trace_events(prof), set(kernel_lines()))
        check_launches(report, facts, rec.calls)
    return {"syncs": rec.stats, "launches": facts}


# ------------------------------------------------------------- fixtures
def check_host_fetch_fixture(report: Report, device) -> None:
    """The host-fetch fixture as a registered dispatch (budget 0), run
    once on ``device``."""
    from repro_torch.analysis import fixtures

    entry = EntryPoint("fixture:host-fetch", "repro_torch.analysis.fixtures",
                       "host_fetch_serve", budget=0, extent=_arg(0))
    dev = torch.device(device)

    def world():
        fixtures.host_fetch_serve(torch.arange(64, dtype=torch.float32,
                                               device=dev))

    run_host_sync_checks(report, dev, entries=(entry,), world=world,
                         profile=False)


def check_batch_loop_fixture(report: Report, device) -> List[dict]:
    """The batch-loop fixture's kernel launched once under the profiler,
    as a registered entry whose extent is its 4,096-query batch; returns
    the launch facts."""
    from repro_torch.analysis import fixtures

    dev = torch.device(device)
    if dev.type != "cuda":
        raise RuntimeError("the batch-loop fixture needs the card")
    entry = EntryPoint("fixture:batch-loop", "repro_torch.analysis.fixtures",
                       "batch_loop", budget=0, extent=_arg(0))
    q, pool = fixtures.fixture_inputs("fixture:batch-loop", dev)
    torch.cuda.synchronize()

    def world():
        fixtures.batch_loop(q, pool)

    return run_host_sync_checks(report, dev, entries=(entry,), world=world,
                                profile=True)["launches"]
