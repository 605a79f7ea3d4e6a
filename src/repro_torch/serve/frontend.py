"""SLO-aware serving front end for the learned index (DESIGN.md §16).

Port of ``repro.serve.frontend``: the same loop, batching rule, service
model, admission, retry and accounting.  Production traffic is a stream
of small, mixed point/range/insert/delete requests with per-request
deadlines; this module is the layer between that stream and the batched
``NFL`` calls.  A continuous loop that

* coalesces queued requests into dynamically sized batches
  (**fill-or-timeout**: dispatch when ``max_batch`` requests of one op
  are waiting, or when the head of the queue has waited
  ``batch_timeout_s`` — small batches under light load for latency,
  full batches under heavy load for throughput);
* routes each batch through ``NFL`` — single or sharded, flow on or
  off — using the async dispatch API (``lookup_batch_async``: the
  kernel and a copy of its payloads into pinned host memory in flight,
  and a finisher that waits for the copy's event), so up to
  ``max_inflight`` read batches overlap host-side batching with device
  execution (**double-buffered dispatch**);
* enforces **per-request deadlines with admission control**: at
  dispatch time the loop predicts each request's completion from EWMA
  service-time estimates plus the in-flight backlog and *sheds*
  requests that would miss their deadline anyway — shedding early is
  what keeps the latency tail of everything actually served bounded
  under overload;
* retries **transient dispatch failures** with bounded exponential
  backoff (``ops.TransientDispatchError`` is raised before anything is
  uploaded or launched, so a retry is side-effect free); a batch that
  exhausts its retry budget resolves as shed with ``reason="error"`` —
  never a silent drop.

Terminal accounting is exact by construction: every submitted request
ends in exactly one of ``completed`` / ``shed`` / ``expired``, and
``admitted == completed + shed + expired`` once the loop drains.

* ``completed`` — served; for reads this additionally means the result
  came back within the deadline.  A *write* that dispatched is always
  ``completed`` even when late (its effect is physically in the index;
  calling it anything else would lie about state), with
  ``reason="late"`` recording the SLO miss.
* ``shed`` — never dispatched: admission control predicted a deadline
  miss (``reason="admission"``), or dispatch failed past the retry
  budget (``reason="error"``).
* ``expired`` — the deadline passed while the request was still queued
  (``reason="queued"``), or a read came back too late
  (``reason="late"``; the result is still correct, it is just useless
  to the caller).

Reads are dispatched against the index state at dispatch time (the
kernels read the pools and tiers as they are when launched, and a later
write is ordered after them), and batches are formed as contiguous
same-op prefixes of a FIFO queue, so results are dict-oracle exact
under concurrent writes: a read observes exactly the writes that
dispatched before it, which is exactly the order the
``on_batch_dispatched`` hook exposes to oracles and tests.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.kernels.ops import TransientDispatchError

__all__ = ["COMPLETED", "SHED", "EXPIRED", "FrontEnd", "FrontEndConfig",
           "ServiceRequest"]

COMPLETED, SHED, EXPIRED = "completed", "shed", "expired"
_TERMINAL = (COMPLETED, SHED, EXPIRED)
_OPS = ("point", "range", "insert", "delete")


@dataclasses.dataclass
class ServiceRequest:
    """One streamed request with its SLO.

    ``key`` is the point/insert/delete key, or the range lower bound
    (``hi`` the exclusive upper bound); ``deadline_s`` is the SLO
    budget relative to submission."""

    rid: int
    op: str                       # point | range | insert | delete
    key: float
    hi: float = 0.0               # range upper bound
    payload: int = 0              # insert payload
    deadline_s: float = 0.05
    # filled by the front end
    t_submit: float = 0.0
    t_done: float = -1.0
    state: str = "queued"         # queued -> completed | shed | expired
    reason: str = ""              # admission | error | queued | late | ""
    result: Any = None

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_submit


@dataclasses.dataclass(frozen=True)
class FrontEndConfig:
    max_batch: int = 256          # fill target per dispatched batch
    batch_timeout_s: float = 0.002  # max head-of-line wait before flush
    max_inflight: int = 2         # read batches in flight (double buffer)
    admission: bool = True        # shed on predicted deadline miss
    expire_queued: bool = True    # expire requests already past deadline
    slo_margin: float = 1.2       # safety factor on predicted service
    ewma_alpha: float = 0.25      # service-time estimator step
    max_retries: int = 3          # transient-dispatch retry budget
    retry_backoff_s: float = 0.002  # initial backoff (doubles per retry)


class FrontEnd:
    """Continuous batching loop over one ``NFL`` instance.

    Drive it either open-loop (``run_trace`` with pre-computed arrival
    times) or manually (``submit`` + ``step`` / ``drain``).  Not
    thread-safe by design: one owner thread runs the loop, which is the
    deployment shape of ``ContinuousBatcher`` as well; the telemetry it
    reads (``NFL.dispatch_stats``, the ops counters) *is* safe against
    a reader on another thread (``kernels.counters``).  ``clock`` is the
    loop's time source (a step clock makes a run reproducible).
    """

    def __init__(self, nfl, cfg: FrontEndConfig | None = None,
                 clock: Callable[[], float] = time.perf_counter):
        self.nfl = nfl
        self.cfg = cfg or FrontEndConfig()
        self.clock = clock
        self.queue: Deque[ServiceRequest] = deque()
        # in-flight read batches: (op, requests, t_dispatch, finisher)
        self.inflight: Deque[Tuple[str, List[ServiceRequest], float,
                                   Callable[[], np.ndarray]]] = deque()
        self.counters: Dict[str, int] = {
            "admitted": 0, "completed": 0, "shed": 0, "expired": 0,
            "completed_late": 0, "batches": 0, "dispatched_requests": 0,
            "retries": 0, "retry_giveups": 0,
        }
        self.reasons: Dict[str, int] = {
            "shed-admission": 0, "shed-error": 0,
            "expired-queued": 0, "expired-late": 0,
        }
        # EWMA service model per op: base (per-batch overhead incl. the
        # dispatch itself) — seeded pessimistically, corrected fast
        self._svc_batch_s: Dict[str, float] = {op: 5e-3 for op in _OPS}
        # latency of every request that was actually served (reads that
        # came back + writes that executed), late or not
        self._served_lat: List[float] = []
        self._ontime_lat: List[float] = []
        # test/oracle seam: called once per dispatched batch, in
        # dispatch order, right at the dispatch point
        self.on_batch_dispatched: Optional[
            Callable[[str, List[ServiceRequest]], None]] = None

    # ------------------------------------------------------------ intake
    def submit(self, req: ServiceRequest) -> None:
        if req.op not in _OPS:
            raise ValueError(f"unknown op {req.op!r}")
        req.t_submit = self.clock()
        req.state = "queued"
        self.counters["admitted"] += 1
        self.queue.append(req)

    # -------------------------------------------------------- accounting
    def _resolve(self, req: ServiceRequest, state: str, now: float,
                 reason: str = "") -> None:
        assert req.state not in _TERMINAL, \
            f"request {req.rid} resolved twice ({req.state} -> {state})"
        req.state = state
        req.reason = reason
        req.t_done = now
        self.counters[state] += 1
        if reason:
            self.reasons[f"{state}-{reason}"] = (
                self.reasons.get(f"{state}-{reason}", 0) + 1)

    # ------------------------------------------------------- service model
    def _predict_s(self, op: str, n: int) -> float:
        # batch cost is dominated by the per-dispatch constant (kernel
        # launch + transfer); the model keeps one EWMA per op at the
        # configured fill size and scales sublinearly below it
        return self._svc_batch_s[op] * max(0.25, n / self.cfg.max_batch)

    def _observe_s(self, op: str, n: int, svc: float) -> None:
        a = self.cfg.ewma_alpha
        scaled = svc / max(0.25, n / self.cfg.max_batch)
        self._svc_batch_s[op] = (1 - a) * self._svc_batch_s[op] + a * scaled

    def _backlog_s(self) -> float:
        return sum(self._predict_s(op, len(reqs))
                   for op, reqs, _, _ in self.inflight)

    # ---------------------------------------------------------- batching
    def _flush_due(self, now: float, drain: bool) -> bool:
        if not self.queue:
            return False
        if drain or len(self.queue) >= self.cfg.max_batch:
            return True
        return now - self.queue[0].t_submit >= self.cfg.batch_timeout_s

    def _form_batch(self, now: float) -> List[ServiceRequest]:
        """Pop a contiguous same-op prefix, resolving head-of-line
        requests that expired in queue or that admission control sheds
        (predicted completion past deadline)."""
        batch: List[ServiceRequest] = []
        op = None
        backlog = self._backlog_s()
        while self.queue and len(batch) < self.cfg.max_batch:
            req = self.queue[0]
            if op is not None and req.op != op:
                break
            self.queue.popleft()
            if (self.cfg.expire_queued
                    and now > req.t_submit + req.deadline_s):
                self._resolve(req, EXPIRED, now, reason="queued")
                continue
            if self.cfg.admission:
                pred = backlog + self._predict_s(req.op, len(batch) + 1)
                if (now + self.cfg.slo_margin * pred
                        > req.t_submit + req.deadline_s):
                    self._resolve(req, SHED, now, reason="admission")
                    continue
            op = req.op
            batch.append(req)
        return batch

    # ---------------------------------------------------------- dispatch
    def _with_retry(self, fn: Callable[[], Any]) -> Any:
        """Bounded retry with exponential backoff for transient dispatch
        faults.  Non-transient errors propagate immediately — they are
        bugs, not weather."""
        delay = self.cfg.retry_backoff_s
        for attempt in range(self.cfg.max_retries + 1):
            try:
                return fn()
            except TransientDispatchError:
                if attempt == self.cfg.max_retries:
                    raise
                self.counters["retries"] += 1
                time.sleep(delay)
                delay *= 2.0

    def _dispatch(self, batch: List[ServiceRequest]) -> None:
        op = batch[0].op
        self.counters["batches"] += 1
        self.counters["dispatched_requests"] += len(batch)
        t0 = self.clock()
        try:
            if op == "point":
                keys = np.array([r.key for r in batch], np.float64)
                fin = self._with_retry(
                    lambda: self.nfl.lookup_batch_async(keys))
                self._hook(op, batch)
                self.inflight.append((op, batch, t0, fin))
                return
            if op == "range":
                lo = np.array([r.key for r in batch], np.float64)
                hi = np.array([r.hi for r in batch], np.float64)
                pv, cnt, tot = self._with_retry(
                    lambda: self.nfl.scan_batch(lo, hi))
                self._hook(op, batch)
                now = self.clock()
                self._observe_s(op, len(batch), now - t0)
                for i, r in enumerate(batch):
                    r.result = (pv[i, :cnt[i]].tolist(), int(tot[i]))
                    self._finish_read(r, now)
                return
            if op == "insert":
                keys = np.array([r.key for r in batch], np.float64)
                pv = np.array([r.payload for r in batch], np.int64)
                self._with_retry(lambda: self.nfl.insert_batch(keys, pv))
                self._hook(op, batch)
                self._finish_writes(batch, t0, ok=None)
                return
            # delete
            keys = np.array([r.key for r in batch], np.float64)
            ok = self._with_retry(lambda: self.nfl.delete_batch(keys))
            self._hook(op, batch)
            self._finish_writes(batch, t0, ok=ok)
        except TransientDispatchError:
            # retry budget exhausted: the batch never dispatched, so no
            # state changed — resolve every request as shed("error")
            now = self.clock()
            self.counters["retry_giveups"] += 1
            for r in batch:
                self._resolve(r, SHED, now, reason="error")

    def _hook(self, op: str, batch: List[ServiceRequest]) -> None:
        if self.on_batch_dispatched is not None:
            self.on_batch_dispatched(op, batch)

    def _finish_writes(self, batch: List[ServiceRequest], t0: float,
                       ok) -> None:
        now = self.clock()
        self._observe_s(batch[0].op, len(batch), now - t0)
        for i, r in enumerate(batch):
            r.result = True if ok is None else bool(ok[i])
            late = now > r.t_submit + r.deadline_s
            # a dispatched write always completes — its effect is in the
            # index — but a late one is an SLO miss, not goodput
            self._resolve(r, COMPLETED, now, reason="late" if late else "")
            self.counters["completed_late"] += int(late)
            self._served_lat.append(r.latency_s)
            if not late:
                self._ontime_lat.append(r.latency_s)

    def _finish_read(self, r: ServiceRequest, now: float) -> None:
        self._served_lat.append(now - r.t_submit)
        if now > r.t_submit + r.deadline_s:
            self._resolve(r, EXPIRED, now, reason="late")
        else:
            self._resolve(r, COMPLETED, now)
            self._ontime_lat.append(r.latency_s)

    def _gather_oldest(self) -> None:
        op, batch, t0, fin = self.inflight.popleft()
        res = fin()
        now = self.clock()
        self._observe_s(op, len(batch), now - t0)
        for i, r in enumerate(batch):
            r.result = int(res[i])
            self._finish_read(r, now)

    # --------------------------------------------------------- main loop
    def step(self, drain: bool = False) -> bool:
        """One pump of the loop; returns False when there was nothing
        to do (caller may sleep until the next arrival)."""
        now = self.clock()
        progressed = False
        # free the pipeline before dispatching more
        while self.inflight and (len(self.inflight)
                                 >= max(self.cfg.max_inflight, 1)):
            self._gather_oldest()
            progressed = True
        if self._flush_due(now, drain):
            batch = self._form_batch(now)
            progressed = True
            if batch:
                self._dispatch(batch)
        elif self.inflight and (drain or not self.queue):
            # nothing to launch: collect what is in flight
            self._gather_oldest()
            progressed = True
        return progressed

    def drain(self) -> None:
        """Pump until every submitted request reached a terminal state."""
        while self.queue or self.inflight:
            self.step(drain=True)
        self.assert_accounting()

    def run_trace(self, requests: List[ServiceRequest],
                  arrivals: np.ndarray) -> float:
        """Open-loop replay: request ``i`` is submitted at
        ``arrivals[i]`` seconds (relative), regardless of completions —
        the arrival process never slows down for a backed-up server,
        which is what makes overload measurements honest.  Returns the
        wall-clock duration of the replay (submit of first request to
        full drain)."""
        order = np.argsort(np.asarray(arrivals), kind="stable")
        t0 = self.clock()
        i = 0
        n = len(requests)
        while i < n or self.queue or self.inflight:
            now = self.clock() - t0
            while i < n and arrivals[order[i]] <= now:
                self.submit(requests[order[i]])
                i += 1
            busy = self.step(drain=(i >= n))
            if not busy and i < n:
                # idle until the next arrival (bounded nap: stay
                # responsive to the batch timeout)
                wait = min(float(arrivals[order[i]]) - (self.clock() - t0),
                           self.cfg.batch_timeout_s)
                if wait > 0:
                    time.sleep(wait)
        self.assert_accounting()
        return self.clock() - t0

    # --------------------------------------------------------- telemetry
    def assert_accounting(self) -> None:
        c = self.counters
        resolved = c["completed"] + c["shed"] + c["expired"]
        if c["admitted"] != resolved or self.queue or self.inflight:
            raise AssertionError(
                f"accounting violation: admitted={c['admitted']} != "
                f"completed+shed+expired={resolved} "
                f"(queued={len(self.queue)}, inflight={len(self.inflight)})")

    def latency_percentiles(self, which: str = "served") -> Dict[str, float]:
        """p50/p99/p999/max (ns) over ``served`` (every request that got
        a result, late or not) or ``ontime`` (goodput) latencies."""
        lat = self._served_lat if which == "served" else self._ontime_lat
        if not lat:
            return {"p50_ns": 0.0, "p99_ns": 0.0, "p999_ns": 0.0,
                    "max_ns": 0.0}
        a = np.asarray(lat) * 1e9
        return {"p50_ns": float(np.percentile(a, 50)),
                "p99_ns": float(np.percentile(a, 99)),
                "p999_ns": float(np.percentile(a, 99.9)),
                "max_ns": float(a.max())}

    def stats(self) -> Dict[str, Any]:
        c = dict(self.counters)
        c["pending"] = (c["admitted"] - c["completed"] - c["shed"]
                        - c["expired"])
        c["reasons"] = dict(self.reasons)
        c["svc_batch_s"] = {k: float(v)
                            for k, v in self._svc_batch_s.items()}
        c["latency_served"] = self.latency_percentiles("served")
        c["latency_ontime"] = self.latency_percentiles("ontime")
        return c
