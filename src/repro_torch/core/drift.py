"""Drift telemetry and background re-flow control (DESIGN.md §14).

Port of ``repro.core.drift`` (the single-index half, ROADMAP A11a).  The
flow is fitted once at bulkload, so sustained insert traffic whose key
distribution drifts away from the build sample erodes the
transformation: tail conflicts climb and the serving path walks back
toward the no-flow pathology.  ``DriftMonitor`` keeps a *decayed
reservoir sample* of recently inserted keys; ``ReflowManager``
periodically re-measures the tail conflict degree of the serving
transform on that sample (paper Defs 3.1/3.2, via ``core.conflict``)
and, when the drift score crosses a threshold, drives a background
retrain + re-key episode through a small state machine:

    idle --(score >= threshold)--> training --(trainer done)--> pending
      ^                               |  (validate + margin gate)  |
      |        fail / reject          v                            |
      +---- cooldown w/ backoff <-----+<------ apply refused ------+
                                               (fold in flight; retry)

Every transition is driven from ``tick()``, which the owner calls once
per insert batch on the serving path; the work per tick is bounded (at
most ``steps_per_tick`` optimizer minibatches of a ``FlowTrainer``).
The manager is pure control flow and numpy: measuring the serving tail,
building a trainer, scoring a candidate and applying it are injected
callables (``NFL`` runs the first two and the re-key through the NF
kernel), which is also the fault-injection surface the tests use.

Degradation ladder: a retrain that raises, produces non-finite z, or
fails the ``accept_candidate`` margin leaves serving untouched and
backs off — the cooldown span doubles after ``max_attempts``
consecutive failures, so a workload the flow cannot fit degrades to
plain (correct, slower) serving instead of retraining in a hot loop.
The identity transform competes in every validation round: if the
drifted distribution is already near-uniform, flow -> identity wins and
the re-key drops the flow.

The monitor's random stream, the state names, the counters and the
``stats()`` keys are the JAX package's, so both managers take the same
transitions on the same inputs.

The reshard half (DESIGN.md §18): ``ReshardManager`` watches the sharded
router's decayed per-shard load gauges and, when one shard takes more
than ``hot_frac / P`` of the load, starts a boundary migration of the
window of shards around it.  It shares one ``ExclusionLock`` with the
``ReflowManager``, so a migration and a cross-shard re-key never
interleave.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Optional, Tuple

import numpy as np

from repro_torch.core.conflict import accept_candidate, dataset_tail_conflict

__all__ = ["DriftConfig", "DriftMonitor", "ExclusionLock",
           "LockDisciplineError", "ReflowManager", "ReshardConfig",
           "ReshardManager"]


class LockDisciplineError(RuntimeError):
    """The ReflowManager's single-owner discipline was violated.

    The manager is not thread-safe by design: one owner drives
    ``tick()`` from the serving path and reads ``stats()`` between
    transitions.  Two calls can still interleave incorrectly from a
    single thread — an injected callable (``apply``, ``evaluate``,
    ``train_factory``, ``serving_tail``) calling back into ``tick()``,
    or ``stats()`` reading counters mid-transition — and those bugs
    corrupt the episode bookkeeping silently.  This error makes the
    violation loud.  It is a programming error, never a data-dependent
    failure, so the state machine's ``except Exception`` degradation
    ladder deliberately re-raises it instead of counting it as a failed
    retrain episode.
    """


class ExclusionLock:
    """One mutual-exclusion token for *structural* episodes (§14/§18).

    A re-flow re-derives every shard boundary; a reshard moves a window
    of them.  Running both concurrently would race on the shard list and
    the boundary vector, so the two managers share a single token: a
    manager acquires it before starting its episode and releases it at
    swap or failure.  Non-blocking and single-threaded by design (both
    managers tick from the serving path) — ``acquire`` returning False
    means "the other manager owns a structural episode, retry/back off",
    never "wait".  Re-acquisition by the current owner is idempotent,
    and releasing a token you do not own is a no-op (the failure paths
    release unconditionally).
    """

    def __init__(self):
        self.owner: Optional[str] = None

    def acquire(self, owner: str) -> bool:
        if self.owner is None or self.owner == owner:
            self.owner = owner
            return True
        return False

    def release(self, owner: str) -> None:
        if self.owner == owner:
            self.owner = None


@dataclasses.dataclass(frozen=True)
class DriftConfig:
    """Knobs for the drift monitor and the background re-flow loop."""

    enabled: bool = True          # maintain the reservoir + drift score
    sample_size: int = 1024       # reservoir capacity (keys)
    window_keys: int = 8192       # decay time constant: a reservoir slot
    #                               survives ~window_keys inserts in
    #                               expectation before being replaced
    check_every: int = 2048       # recompute the tail every N observed keys
    threshold: float = 2.0        # drift score (tail / baseline) trigger
    min_tail: int = 4             # ignore drift while the tail is tiny
    reflow: bool = False          # opt-in: actually retrain + re-key
    conflicts_decay: float = 0.1  # accept_candidate margin
    gamma: float = 0.99           # tail percentile for all measurements
    max_attempts: int = 3         # failed episodes before backoff doubles
    cooldown_keys: int = 8192     # base cooldown span after a failure
    steps_per_tick: int = 4       # optimizer minibatches per serving tick
    train_epochs: int = 2         # retrain epochs over the reservoir
    train_batch: int = 256        # retrain minibatch size
    seed: int = 0


class DriftMonitor:
    """Decayed reservoir sample of recently inserted keys.

    Classic reservoir sampling keeps a uniform sample over *all* keys
    ever seen, which is exactly wrong for drift detection — old keys
    must age out.  Instead each incoming key replaces a uniformly random
    slot with probability ``sample_size / window_keys``, making the
    reservoir an exponentially-decayed sample whose expected age is
    ``window_keys`` inserts: recent enough to see drift, wide enough
    that one hot batch doesn't own the whole sample.
    """

    def __init__(self, cfg: DriftConfig):
        self.cfg = cfg
        self._rng = np.random.default_rng(cfg.seed)
        self._res = np.empty(int(cfg.sample_size), np.float64)
        self._fill = 0
        self.keys_observed = 0
        self._last_check_at = 0

    def seed(self, keys: np.ndarray) -> None:
        """Prime the reservoir from the bulkload keyset (not counted as
        observed inserts — the baseline tail is measured separately)."""
        keys = np.asarray(keys, np.float64).ravel()
        if keys.shape[0] == 0:
            return
        take = min(keys.shape[0], self._res.shape[0])
        self._res[:take] = self._rng.choice(keys, size=take, replace=False)
        self._fill = max(self._fill, take)

    def observe(self, keys: np.ndarray) -> None:
        """Fold one inserted batch into the reservoir."""
        keys = np.asarray(keys, np.float64).ravel()
        m = keys.shape[0]
        if m == 0:
            return
        self.keys_observed += m
        k = self._res.shape[0]
        start = 0
        if self._fill < k:
            take = min(m, k - self._fill)
            self._res[self._fill:self._fill + take] = keys[:take]
            self._fill += take
            start = take
        rest = keys[start:]
        if rest.shape[0] == 0:
            return
        p = min(1.0, k / float(max(self.cfg.window_keys, 1)))
        hit = self._rng.random(rest.shape[0]) < p
        nh = int(hit.sum())
        if nh:
            slots = self._rng.integers(0, k, size=nh)
            self._res[slots] = rest[hit]

    def should_check(self) -> bool:
        if self._fill == 0:
            return False
        if self.keys_observed - self._last_check_at < self.cfg.check_every:
            return False
        self._last_check_at = self.keys_observed
        return True

    def sample(self) -> np.ndarray:
        return self._res[:self._fill].copy()


class ReflowManager:
    """Bounded-work state machine from drift score to atomic re-key.

    Injected callables (all may raise; raising counts as a failed
    episode, never an error on the serving path):

    - ``serving_tail(sample) -> int``: tail conflict degree of the
      sample under the *currently serving* transform.
    - ``train_factory(sample, attempt) -> trainer``: build a
      ``FlowTrainer``-shaped object (``step() -> done: bool``) for a
      retrain attempt.  Instance attribute, so tests can swap it to
      inject failures.
    - ``evaluate(trainer, sample) -> (tail, candidate)``: finish the
      trained flow into a candidate payload and measure its tail on the
      sample; must raise if the candidate is unusable (non-finite z).
    - ``apply(candidate, use_flow, accepted_tail) -> bool``: start the
      re-key fold.  ``False`` means "busy, retry next tick" (an
      incremental fold is already in flight) — the episode stays
      pending.  The owner must call :meth:`note_swap` when the re-key
      actually swaps in.

    ``exclusion`` is the shared :class:`ExclusionLock` serializing
    structural episodes against a :class:`ReshardManager` (§18): the
    re-key acquires it before ``apply`` and holds it until the swap (or
    failure), so a boundary migration can never interleave with a
    cross-shard re-key.
    """

    IDLE, TRAINING, PENDING = "idle", "training", "pending"

    def __init__(self, cfg: DriftConfig, monitor: DriftMonitor, *,
                 serving_tail: Callable[[np.ndarray], int],
                 train_factory: Callable[[np.ndarray, int], Any],
                 evaluate: Callable[[Any, np.ndarray], Tuple[int, Any]],
                 apply: Callable[[Any, bool, int], bool],
                 exclusion: Optional[ExclusionLock] = None):
        self.cfg = cfg
        self.monitor = monitor
        self.serving_tail = serving_tail
        self.train_factory = train_factory
        self.evaluate = evaluate
        self.apply = apply
        self.exclusion = exclusion if exclusion is not None \
            else ExclusionLock()
        self.state = self.IDLE
        self.baseline_tail = 1
        self.last_score = 0.0
        self.last_serving_tail = 0
        self.cooldown_until = 0
        self._cooldown_span = int(cfg.cooldown_keys)
        self._episode_attempts = 0
        self._trainer: Any = None
        self._sample: Optional[np.ndarray] = None
        self._pending: Optional[Tuple[Any, bool, int]] = None
        self._pending_identity = False
        self._applied = False
        self._in_tick = False          # reentrancy guard (lock discipline)
        self._commit_depth = 0         # stats() barred inside _commit()
        # counters (monotone; NOT reset by dispatch_stats(reset=True))
        self.checks = 0
        self.triggers = 0
        self.retrain_attempts = 0
        self.retrain_failures = 0
        self.candidates_rejected = 0
        self.reflows_started = 0
        self.reflows_completed = 0
        self.identity_switches = 0

    # -- public surface -------------------------------------------------
    def set_baseline(self, tail: int) -> None:
        """Anchor the drift score at the bulkload's accepted tail."""
        self.baseline_tail = max(int(tail), 1)

    def tick(self) -> None:
        """One bounded unit of drift work; called per insert batch.

        Single-owner: an injected callable calling back into ``tick()``
        would advance the state machine underneath its own caller, so
        reentrancy raises :class:`LockDisciplineError` instead of
        silently double-driving an episode.
        """
        if self._in_tick:
            raise LockDisciplineError(
                "tick() re-entered from within an injected callable: "
                "the manager is single-owner and its callables must "
                "not drive the state machine recursively")
        self._in_tick = True
        try:
            if self.state == self.TRAINING:
                self._advance_training()
            elif self.state == self.PENDING:
                self._try_apply()
            elif self.monitor.should_check():
                self._check()
        finally:
            self._in_tick = False

    def note_swap(self) -> None:
        """The re-key fold swapped in: the candidate now serves."""
        with self._commit():
            self.reflows_completed += 1
            if self._pending_identity:
                self.identity_switches += 1
            if self._pending is not None:
                self.baseline_tail = max(int(self._pending[2]), 1)
            self._pending = None
            self._pending_identity = False
            self._applied = False
            self._episode_attempts = 0
            self._cooldown_span = int(self.cfg.cooldown_keys)
            self.cooldown_until = (self.monitor.keys_observed
                                   + self._cooldown_span)
            self.state = self.IDLE
        self.exclusion.release("reflow")

    def stats(self) -> dict:
        if self._commit_depth:
            raise LockDisciplineError(
                "stats() read inside a commit window: the episode "
                "counters are mid-transition and would be mutually "
                "inconsistent")
        return {
            "state": self.state,
            "last_score": self.last_score,
            "last_serving_tail": self.last_serving_tail,
            "baseline_tail": self.baseline_tail,
            "checks": self.checks,
            "triggers": self.triggers,
            "retrain_attempts": self.retrain_attempts,
            "retrain_failures": self.retrain_failures,
            "candidates_rejected": self.candidates_rejected,
            "reflows_started": self.reflows_started,
            "reflows_completed": self.reflows_completed,
            "identity_switches": self.identity_switches,
            "cooldown_until": self.cooldown_until,
            "keys_observed": self.monitor.keys_observed,
            "reservoir_fill": int(self.monitor._fill),
        }

    # -- state machine --------------------------------------------------
    @contextlib.contextmanager
    def _commit(self):
        """Episode-bookkeeping mutation window.

        Counters and state flip together inside it, so an external read
        (``stats()``) mid-window would observe e.g. ``reflows_completed``
        advanced with ``state`` still PENDING.  Injected callables run
        *outside* commit windows — they may legitimately read stats —
        and the window must never nest: nesting means a mutation section
        called another mutation section, i.e. the discipline is already
        broken somewhere above.
        """
        if self._commit_depth:
            raise LockDisciplineError(
                "nested commit window: an episode transition ran inside "
                "another transition's mutation section")
        self._commit_depth += 1
        try:
            yield
        finally:
            self._commit_depth -= 1

    def _check(self) -> None:
        sample = self.monitor.sample()
        self.checks += 1
        try:
            tail = int(self.serving_tail(sample))
        except LockDisciplineError:
            raise
        except Exception:
            return  # measurement failure is never a serving-path error
        with self._commit():
            self.last_serving_tail = tail
            self.last_score = tail / float(max(self.baseline_tail, 1))
        if not self.cfg.reflow:
            return
        if (self.last_score < self.cfg.threshold
                or tail < self.cfg.min_tail
                or self.monitor.keys_observed < self.cooldown_until):
            return
        self.triggers += 1
        self.retrain_attempts += 1
        try:
            trainer = self.train_factory(sample, self._episode_attempts)
        except LockDisciplineError:
            raise
        except Exception:
            self._fail()
            return
        with self._commit():
            self._trainer = trainer
            self._sample = sample
            self.state = self.TRAINING

    def _advance_training(self) -> None:
        try:
            for _ in range(max(int(self.cfg.steps_per_tick), 1)):
                if self._trainer.step():
                    self._validate()
                    return
        except LockDisciplineError:
            raise
        except Exception:
            self._fail()

    def _validate(self) -> None:
        """Margin-gate the finished candidate against serving AND the
        identity transform (online AutoSwitch: a near-uniform drifted
        distribution should drop the flow, not fit a new one)."""
        sample = self._sample
        try:
            cand_tail, candidate = self.evaluate(self._trainer, sample)
            cand_tail = int(cand_tail)
        except LockDisciplineError:
            raise
        except Exception:
            self._fail()
            return
        ident_tail = int(dataset_tail_conflict(sample, self.cfg.gamma))
        if cand_tail < ident_tail:
            best, use_flow, best_tail = candidate, True, cand_tail
        else:  # ties keep the simpler transform
            best, use_flow, best_tail = None, False, ident_tail
        if not accept_candidate(self.last_serving_tail, best_tail,
                                self.cfg.conflicts_decay):
            self._fail(rejected=True)
            return
        with self._commit():
            self._pending = (best, use_flow, best_tail)
            self._pending_identity = not use_flow
            self._trainer = None
            self._sample = None
            self.state = self.PENDING
        self._try_apply()

    def _try_apply(self) -> None:
        if self._applied:
            return  # re-key fold in flight; note_swap() closes the episode
        if not self.exclusion.acquire("reflow"):
            return  # a reshard episode owns the structure; retry next tick
        best, use_flow, best_tail = self._pending
        epoch = self.reflows_completed
        try:
            started = bool(self.apply(best, use_flow, best_tail))
        except LockDisciplineError:
            raise
        except Exception:
            self._fail()
            return
        if started:
            with self._commit():
                self.reflows_started += 1
                if self.reflows_completed == epoch:
                    # stay PENDING until note_swap(): the fold is in
                    # flight and a second episode must not start
                    # underneath it
                    self._applied = True
                # else: apply() swapped synchronously (empty-snapshot
                # re-key calls on_swap before returning) and note_swap
                # already closed the episode — marking it in-flight now
                # would wedge every future PENDING episode behind a
                # swap that will never arrive
        # else: a regular fold is mid-flight; retry next tick

    def _fail(self, rejected: bool = False) -> None:
        with self._commit():
            if rejected:
                self.candidates_rejected += 1
            else:
                self.retrain_failures += 1
            self._trainer = None
            self._sample = None
            self._pending = None
            self._pending_identity = False
            self._applied = False
            self._episode_attempts += 1
            if self._episode_attempts >= max(int(self.cfg.max_attempts), 1):
                self._cooldown_span = min(self._cooldown_span * 2,
                                          64 * int(self.cfg.cooldown_keys))
                self._episode_attempts = 0
            self.cooldown_until = (self.monitor.keys_observed
                                   + self._cooldown_span)
            self.state = self.IDLE
        self.exclusion.release("reflow")


# ---------------------------------------------------------------- reshard
@dataclasses.dataclass(frozen=True)
class ReshardConfig:
    """Knobs for hot-shard detection and online boundary migration
    (DESIGN.md §18).  ``enabled`` turns on the load checks; ``migrate``
    additionally lets the manager *act* — with it off, the hot-shard
    score is telemetry only (``dispatch_stats()["reshard"]``), mirroring
    ``DriftConfig.reflow``'s opt-in split."""

    enabled: bool = False
    migrate: bool = True           # False: detect + report, never migrate
    hot_frac: float = 2.0          # hot when share >= hot_frac / n_shards
    min_load: float = 256.0        # decayed key mass before shares count
    min_keys: int = 1024           # ignore while the table is tiny
    check_every: int = 512         # routed keys between load checks
    cooldown_keys: int = 4096      # base cooldown span after an episode
    neighbors: int = 1             # cold neighbors on each side of the
    #                                hot shard in the migration window
    load_window_keys: int = 4096   # router load-gauge decay constant
    max_backoff: int = 64          # cooldown doubling cap (x cooldown_keys)


class ReshardManager:
    """Load-triggered boundary-migration control (DESIGN.md §18).

    The structural sibling of :class:`ReflowManager`: same single-owner
    tick discipline (reentrancy raises :class:`LockDisciplineError`),
    same ``_commit()`` mutation windows, same monotone episode counters
    that survive ``dispatch_stats(reset=True)``, and the same
    degradation ladder — a migration that fails mid-flight leaves
    serving untouched and backs off with a doubling cooldown.  Unlike a
    re-flow there is no training phase: the trigger *is* the plan (a
    contiguous shard window around the hot shard), so the machine has
    two states:

        idle --(hot shard detected)--> migrating --(swap)--> idle
          ^                                |
          +------ cooldown w/ backoff <----+  (abort / busy / refused)

    Injected callables:

    - ``load_snapshot() -> dict``: the router's decayed per-shard load
      gauges (``reads``/``writes`` f64[P]) plus per-shard key counts.
    - ``start_migration(lo, hi) -> bool``: freeze shards ``lo..hi`` and
      begin the localized migration.  ``False`` means the index is busy
      (a re-flow or another migration in flight); raising means the
      freeze itself failed.  Both leave serving untouched and count as a
      failed episode.  The owner calls :meth:`note_swap` when the
      migration swaps in, :meth:`note_failure` if a later fold tick
      aborts it.

    ``exclusion`` is the :class:`ExclusionLock` shared with the
    :class:`ReflowManager`: acquired before ``start_migration``, held
    until swap or failure, so a migration and a re-flow can never
    interleave — a re-flow re-derives *all* boundaries, and a migration
    moves a window of them.
    """

    IDLE, MIGRATING = "idle", "migrating"

    def __init__(self, cfg: ReshardConfig, *,
                 load_snapshot: Callable[[], dict],
                 start_migration: Callable[[int, int], bool],
                 exclusion: Optional[ExclusionLock] = None):
        self.cfg = cfg
        self.load_snapshot = load_snapshot
        self.start_migration = start_migration
        self.exclusion = exclusion if exclusion is not None \
            else ExclusionLock()
        self.state = self.IDLE
        self.keys_routed = 0
        self._last_check_at = 0
        self.cooldown_until = 0
        self._cooldown_span = int(cfg.cooldown_keys)
        self.last_hot_shard = -1
        self.last_hot_share = 0.0
        self.last_window = (-1, -1)
        self._in_tick = False          # reentrancy guard (lock discipline)
        self._commit_depth = 0         # stats() barred inside _commit()
        # counters (monotone; NOT reset by dispatch_stats(reset=True))
        self.checks = 0
        self.resharding_episodes = 0
        self.migrations_completed = 0
        self.migrations_failed = 0

    # -- public surface -------------------------------------------------
    def observe(self, n_keys: int) -> None:
        """Count routed traffic (reads AND writes — read skew is the
        canonical trigger); drives the check cadence."""
        self.keys_routed += int(n_keys)

    def tick(self) -> None:
        """One bounded unit of reshard control work, called per routed
        batch.  While a migration is in flight the index advances its
        own candidate folds (charged to routed traffic); the manager
        just waits for ``note_swap`` / ``note_failure``."""
        if self._in_tick:
            raise LockDisciplineError(
                "tick() re-entered from within an injected callable: "
                "the manager is single-owner and its callables must "
                "not drive the state machine recursively")
        self._in_tick = True
        try:
            if self.state == self.IDLE:
                self._check()
        finally:
            self._in_tick = False

    def note_swap(self) -> None:
        """The migration swapped in: the window's candidates now serve."""
        with self._commit():
            self.migrations_completed += 1
            self._cooldown_span = int(self.cfg.cooldown_keys)
            self.cooldown_until = self.keys_routed + self._cooldown_span
            self.state = self.IDLE
        self.exclusion.release("reshard")

    def note_failure(self) -> None:
        """A mid-flight migration aborted (candidate fold raised): the
        index rolled the freeze back and serving is untouched — close
        the episode through the backoff ladder."""
        self._fail()

    def stats(self) -> dict:
        if self._commit_depth:
            raise LockDisciplineError(
                "stats() read inside a commit window: the episode "
                "counters are mid-transition and would be mutually "
                "inconsistent")
        return {
            "state": self.state,
            "checks": self.checks,
            "resharding_episodes": self.resharding_episodes,
            "migrations_completed": self.migrations_completed,
            "migrations_failed": self.migrations_failed,
            "last_hot_shard": self.last_hot_shard,
            "last_hot_share": self.last_hot_share,
            "last_window": list(self.last_window),
            "cooldown_until": self.cooldown_until,
            "cooldown_span": self._cooldown_span,
            "keys_routed": self.keys_routed,
        }

    # -- state machine --------------------------------------------------
    @contextlib.contextmanager
    def _commit(self):
        if self._commit_depth:
            raise LockDisciplineError(
                "nested commit window: an episode transition ran inside "
                "another transition's mutation section")
        self._commit_depth += 1
        try:
            yield
        finally:
            self._commit_depth -= 1

    def _check(self) -> None:
        if self.keys_routed - self._last_check_at < self.cfg.check_every:
            return
        self._last_check_at = self.keys_routed
        self.checks += 1
        try:
            snap = self.load_snapshot()
            reads = np.asarray(snap["reads"], np.float64)
            writes = np.asarray(snap["writes"], np.float64)
            n_keys = int(np.sum(snap["n_keys"]))
        except LockDisciplineError:
            raise
        except Exception:
            return  # measurement failure is never a serving-path error
        P = reads.shape[0]
        load = reads + writes
        total = float(load.sum())
        if P < 2 or total <= 0.0:
            return
        hot = int(np.argmax(load))
        share = float(load[hot] / total)
        with self._commit():
            self.last_hot_shard = hot
            self.last_hot_share = share
        if not self.cfg.migrate:
            return
        if (total < self.cfg.min_load
                or n_keys < self.cfg.min_keys
                or share < self.cfg.hot_frac / float(P)
                or self.keys_routed < self.cooldown_until):
            return
        k = max(int(self.cfg.neighbors), 1)
        lo = max(hot - k, 0)
        hi = min(hot + k, P - 1)
        if hi <= lo:
            return  # single-shard window: nothing to rebalance
        self.resharding_episodes += 1
        with self._commit():
            self.last_window = (lo, hi)
        if not self.exclusion.acquire("reshard"):
            self._fail()   # a re-flow owns the structure: back off
            return
        epoch = self.migrations_completed + self.migrations_failed
        try:
            started = bool(self.start_migration(lo, hi))
        except LockDisciplineError:
            raise
        except Exception:
            self._fail()
            return
        if not started:
            self._fail()   # index busy (fold/re-flow in flight): back off
            return
        if self.migrations_completed + self.migrations_failed == epoch:
            with self._commit():
                self.state = self.MIGRATING
        # else: the migration swapped (or aborted) synchronously — an
        # empty window folds nothing — and note_swap/note_failure
        # already closed the episode

    def _fail(self) -> None:
        with self._commit():
            self.migrations_failed += 1
            self._cooldown_span = min(
                self._cooldown_span * 2,
                max(int(self.cfg.max_backoff), 1)
                * int(self.cfg.cooldown_keys))
            self.cooldown_until = self.keys_routed + self._cooldown_span
            self.state = self.IDLE
        self.exclusion.release("reshard")
