"""Fault injection for the serving front end (DESIGN.md §16).

Port of ``repro.serve.faults``.  A ``FaultPlan`` names one adversarial
condition per knob; ``inject`` installs it for the duration of a
``with`` block and guarantees cleanup on every exit path.  The raw
injection state lives in ``repro_torch.kernels.ops`` (the one module
every dispatch route crosses); this module is the structured front door
the smoke and the tests use.

The injectable faults and where they bite:

==================  =====================================================
knob                failure it models
==================  =====================================================
force_oracle        has no counterpart: the JAX package's forced
                    oracle rung.  The port has no oracle rung, and no
                    kernel gives way to its plain version on the card,
                    so ``inject`` refuses the knob.
device_stall_s      a slow or contended card: every ``stall_every``-th
                    dispatch sleeps before launching.
dispatch_error_     transient dispatch failures (a preempted device, a
every               flaky transport): every Nth dispatch raises
                    ``ops.TransientDispatchError`` before the launch,
                    with no change to index state, so it is safe to
                    retry.
fold_stall_s        a slow incremental fold: every fold tick on the
                    write path sleeps, stretching the window in which
                    reads ride the delta and run tiers.
retrain_failure     a poisoned §14 re-flow: the background trainer
                    raises, so the drift machinery must back off and
                    keep serving on the incumbent transform.
fail_reshard        a poisoned §18 boundary migration.  ``"snapshot"``:
                    the window freeze raises mid-snapshot (the partial
                    freeze rolled back); ``"fold"``: the candidate fold
                    raises mid-flight (the episode aborted in place);
                    ``"contention"``: ``start_reshard`` reports busy, as
                    if a concurrent re-flow held the swap window.  All
                    three must leave boundaries and serving untouched
                    and back off with the doubling cooldown.
==================  =====================================================

A forced retrain failure patches ``nfl._reflow.train_factory``, and a
forced reshard failure arms the sharded index's ``_reshard_fault`` seam
(or wraps ``start_reshard`` for contention), so both need the ``NFL``
handle; everything else is process-wide ``ops`` state.  A plan that
cannot be installed raises before anything is installed.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator

from repro_torch.kernels import ops

__all__ = ["FaultPlan", "inject", "injection_stats"]


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """One declarative bundle of injected faults (all off by default)."""

    force_oracle: bool = False       # refused by ``inject`` (no oracle)
    device_stall_s: float = 0.0      # sleep before dispatch
    stall_every: int = 1             # ...on every Nth dispatch
    dispatch_error_every: int = 0    # TransientDispatchError on every Nth
    fold_stall_s: float = 0.0        # sleep per incremental-fold tick
    retrain_failure: bool = False    # background re-flow trainer raises
    fail_reshard: str = ""           # §18 migration failure mode:
                                     # "snapshot" | "fold" | "contention"

    def any_active(self) -> bool:
        return (self.force_oracle or self.device_stall_s > 0
                or self.dispatch_error_every > 0 or self.fold_stall_s > 0
                or self.retrain_failure or bool(self.fail_reshard))


def _failing_train_factory(sample, attempt):
    raise RuntimeError("injected retrain failure (FaultPlan)")


@contextlib.contextmanager
def inject(plan: FaultPlan, nfl=None) -> Iterator[FaultPlan]:
    """Install ``plan`` for the duration of the block.

    ``nfl`` is required only for ``retrain_failure`` (the trainer seam
    lives on the instance) and ``fail_reshard`` (the sharded index's
    seam); a plan that needs it without an ``NFL`` that has the
    machinery raises rather than silently injecting nothing.
    """
    if plan.force_oracle:
        raise ValueError(
            "FaultPlan(force_oracle=True) has no counterpart in the port: "
            "it has no oracle rung, and a kernel never gives way to its "
            "plain version on the card")
    reflow = getattr(nfl, "_reflow", None) if nfl is not None else None
    index = getattr(nfl, "index", None) if nfl is not None else None
    if plan.retrain_failure and reflow is None:
        raise ValueError(
            "FaultPlan(retrain_failure=True) needs an NFL with the "
            "§14 re-flow machinery enabled (DriftConfig.reflow)")
    if plan.fail_reshard:
        if plan.fail_reshard not in ("snapshot", "fold", "contention"):
            raise ValueError(
                f"unknown fail_reshard mode {plan.fail_reshard!r}: "
                "expected 'snapshot', 'fold', or 'contention'")
        if index is None or not hasattr(index, "start_reshard"):
            raise ValueError(
                "FaultPlan(fail_reshard=...) needs an NFL on the "
                "sharded flat backend (the §18 migration machinery)")
    ops.set_fault_plan(
        stall_s=float(plan.device_stall_s),
        stall_every=max(int(plan.stall_every), 1),
        fold_stall_s=float(plan.fold_stall_s),
        error_every=max(int(plan.dispatch_error_every), 0),
    )
    saved_factory = None
    if plan.retrain_failure:
        saved_factory = reflow.train_factory
        reflow.train_factory = _failing_train_factory
    saved_start = None
    if plan.fail_reshard == "contention":
        # a concurrent re-flow owning the swap window: the index reports
        # busy, exactly as start_reshard does while another structural
        # episode is in flight
        saved_start = index.start_reshard
        index.start_reshard = (
            lambda *a, **kw: False)  # noqa: ARG005 - seam stub
    elif plan.fail_reshard:
        index._reshard_fault = plan.fail_reshard
    try:
        yield plan
    finally:
        ops.clear_fault_plan()
        if saved_factory is not None:
            reflow.train_factory = saved_factory
        if saved_start is not None:
            index.start_reshard = saved_start
        elif plan.fail_reshard:
            index._reshard_fault = None


def injection_stats(reset: bool = False) -> Dict[str, int]:
    """Cumulative injected-fault event counts (see ``ops``)."""
    return ops.fault_injection_stats(reset)
