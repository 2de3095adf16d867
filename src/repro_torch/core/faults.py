"""Fault injection, per-predicate fault ledger, and launch watchdog.

Hydro's premise — UDF behavior is unknowable up front, so the plan must
adapt DURING execution — applies to failures as much as to cost: a flaky
compiled kernel, a hung launch, or a poison batch is just another runtime
statistic the eddy should route around.  This module supplies the three
pieces the AQP core wires together (see core/executor.py for the
end-to-end failure-semantics contract):

* ``FaultPlan`` — a deterministic injection API for tests and the chaos
  benchmark: fail launch N of predicate P, hang a launch for T (virtual or
  wall) seconds, corrupt an output's dtype.  Schedules are either explicit
  1-based attempt indices or seeded per-attempt Bernoulli draws; every
  random stream is derived from ``(plan seed, predicate name, spec
  index)``, so an injected timeline is bit-exact run to run and
  SimClock-compatible (an injected hang becomes extra VIRTUAL occupancy,
  never a wall sleep, under the simulated clock).

* ``FaultLedger`` — the per-predicate failure statistics the routing
  layer ranks on: error-rate EMA, consecutive-failure count, retry /
  quarantine / degradation / deadline counters.  Surfaced in
  ``AQPExecutor.stats_snapshot()["_faults"]``.  Writes happen only on the
  (rare) failure/retry/success bookkeeping path; the hot read
  (``rank_penalty``) is lock-free and returns exactly 1.0 until the first
  failure is recorded, so fault-free runs rank bit-identically to a build
  without this module.

* ``LaunchWatchdog`` — a wall-clock daemon thread (name prefix
  ``fault-watchdog``, covered by the tests/conftest.py leaked-thread
  guard) that flags in-flight launches older than a deadline.  Python
  cannot interrupt a thread blocked inside a foreign launch, so the
  watchdog's job is *visibility*: the ledger learns about the hang WHILE
  it is in progress, and failure-aware routing steers new batches away
  from the wedged predicate instead of piling onto it.  Under SimClock
  deadlines are checked post-hoc from virtual turnaround instead (the
  watchdog thread never starts), keeping deterministic timelines exact.
"""
from __future__ import annotations

import itertools
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.stats import Ema

# Error-rate -> rank-penalty slope: a predicate failing every launch
# (EMA -> 1.0) ranks as if it cost (1 + weight)x its measured cost, so the
# eddy defers it behind healthy siblings without ever starving it outright
# (quarantine, not penalty, is what removes a predicate from routing).
FAULT_PENALTY_WEIGHT = 4.0

# Error-rate EMA horizon: ~the last dozen evaluations dominate, so a
# predicate that recovers stops paying the penalty within a few batches.
FAULT_EMA_ALPHA = 0.15


class InjectedFault(RuntimeError):
    """A deliberately injected launch failure (FaultPlan ``fail`` spec)."""


class CorruptOutputError(RuntimeError):
    """An evaluation returned outputs violating the UDF's learned spec
    (wrong leading row count, or — under injection — wrong dtype)."""


def _spec_rng(seed: int, pred: str, index: int) -> np.random.Generator:
    """Deterministic per-(plan, predicate, spec) random stream."""
    return np.random.default_rng((seed, zlib.crc32(pred.encode()), index))


@dataclass
class FaultSpec:
    """One injection rule: WHAT happens on WHICH attempts of WHICH predicate.

    ``attempts`` are 1-based indices into the predicate's global attempt
    counter (retries count as new attempts); ``probability`` instead draws
    a seeded Bernoulli per attempt.  ``compiled_only`` specs stop firing
    once the predicate has been degraded to its reference path — modelling
    a fault in the COMPILED executable that the fallback escapes."""

    pred: str
    kind: str                      # "error" | "hang" | "corrupt"
    attempts: Tuple[int, ...] = ()
    probability: float = 0.0
    hang_s: float = 0.0
    compiled_only: bool = True
    rng: Optional[np.random.Generator] = None

    def triggers(self, attempt: int) -> bool:
        if self.attempts:
            return attempt in self.attempts
        if self.probability > 0.0 and self.rng is not None:
            # one draw per attempt, unconditionally: the stream position
            # depends only on the attempt index, never on other specs
            return bool(self.rng.random() < self.probability)
        return False


class FaultPlan:
    """Deterministic fault schedule for a set of predicates.

    Chainable builders::

        plan = (FaultPlan(seed=7)
                .fail("detector", attempts=(1, 2))      # first two launches
                .fail("classifier", probability=0.05)   # seeded 5%/launch
                .hang("ocr", attempts=(3,), seconds=2)  # 3rd launch stalls
                .corrupt("detector", attempts=(5,)))    # wrong dtype once

    ``invoke`` wraps ``pred.evaluate_outputs`` and is the ONLY seam the
    worker needs: errors raise ``InjectedFault`` before any virtual cost
    accrues (an injected failure is pre-launch in the simulated timeline;
    wall-clock failures cost whatever real time elapsed), hangs sleep for
    real under a wall clock or deposit extra virtual occupancy consumed by
    ``take_extra_cost`` under SimClock, and corruptions cast the real
    output to ``complex128`` so the worker-side spec validation trips."""

    def __init__(self, *, seed: int = 0):
        self.seed = seed
        self._specs: Dict[str, list] = {}
        self._attempts: Dict[str, int] = {}
        self._count = itertools.count()
        self._lock = threading.Lock()
        self._tls = threading.local()
        self.injected = 0

    # ------------------------- builders ------------------------- #
    def _add(self, pred: str, kind: str, attempts: Sequence[int],
             probability: float, hang_s: float = 0.0) -> "FaultPlan":
        spec = FaultSpec(pred=pred, kind=kind, attempts=tuple(attempts),
                         probability=float(probability), hang_s=hang_s)
        if spec.probability > 0.0:
            spec.rng = _spec_rng(self.seed, pred, next(self._count))
        else:
            next(self._count)  # keep downstream spec streams stable
        self._specs.setdefault(pred, []).append(spec)
        return self

    def fail(self, pred: str, *, attempts: Sequence[int] = (),
             probability: float = 0.0) -> "FaultPlan":
        return self._add(pred, "error", attempts, probability)

    def hang(self, pred: str, *, attempts: Sequence[int] = (),
             probability: float = 0.0, seconds: float = 1.0) -> "FaultPlan":
        return self._add(pred, "hang", attempts, probability, hang_s=seconds)

    def corrupt(self, pred: str, *, attempts: Sequence[int] = (),
                probability: float = 0.0) -> "FaultPlan":
        return self._add(pred, "corrupt", attempts, probability)

    # ------------------------- injection ------------------------- #
    def attempt_count(self, pred: str) -> int:
        with self._lock:
            return self._attempts.get(pred, 0)

    def take_extra_cost(self) -> float:
        """Pending injected-hang VIRTUAL seconds for the calling thread
        (set by ``invoke`` under SimClock, consumed by the worker's
        occupancy accounting; always 0.0 under a wall clock)."""
        extra = getattr(self._tls, "extra", 0.0)
        self._tls.extra = 0.0
        return extra

    def invoke(self, pred, data, clock) -> np.ndarray:
        """Evaluate ``pred`` on ``data`` with this plan's faults applied."""
        degraded = getattr(pred.udf, "degraded", False)
        with self._lock:
            attempt = self._attempts.get(pred.name, 0) + 1
            self._attempts[pred.name] = attempt
            fired = None
            for spec in self._specs.get(pred.name, ()):
                hit = spec.triggers(attempt)
                if hit and fired is None \
                        and not (spec.compiled_only and degraded):
                    fired = spec
        if fired is None:
            return pred.evaluate_outputs(data)
        self.injected += 1
        if fired.kind == "error":
            raise InjectedFault(
                f"injected failure: {pred.name} attempt {attempt}"
            )
        if fired.kind == "hang":
            if getattr(clock, "simulated", False):
                # virtual hang: extra occupancy, consumed by the worker's
                # SimClock cost accounting — bit-exact, no wall sleep
                self._tls.extra = getattr(self._tls, "extra", 0.0) \
                    + fired.hang_s
            else:
                time.sleep(fired.hang_s)
            return pred.evaluate_outputs(data)
        # corrupt: run the real evaluation, hand back a wrong dtype — the
        # worker's output-spec validation must catch it BEFORE caching
        out = np.asarray(pred.evaluate_outputs(data))
        return out.astype(np.complex128)


@dataclass(frozen=True)
class FaultConfig:
    """Retry/degradation policy for the worker evaluation loop.

    ``mode``: ``"retry"`` retries with capped exponential backoff and
    quarantines poison batches / repeatedly-failing predicates;
    ``"degrade"`` additionally switches a failing UDF to its reference
    path (``UDF.fallback_fn``) after ``degrade_after`` consecutive
    failures.  Backoff for attempt k is ``min(base * 2^(k-1), cap)``
    times a seeded jitter factor in ``[1, 1 + jitter]`` — under SimClock
    the delay advances the batch's VIRTUAL ready time (never a wall
    sleep).  ``launch_deadline_s`` arms deadline detection: post-hoc
    virtual turnaround under SimClock, the ``LaunchWatchdog`` thread
    under a wall clock.

    ``probe_after_skips`` (None = off, the pre-probe behavior: quarantine
    is permanent within a run) arms RECOVERY PROBES: after that many
    routing-level skips of a quarantined predicate, the eddy routes ONE
    probe batch to it (``FaultLedger.take_probe_route``).  The probe gets
    a single attempt — success un-quarantines the predicate
    (``clear_quarantine``) and normal routing resumes; failure re-arms
    the skip counter so the next probe waits another full window."""

    mode: str = "retry"
    max_attempts: int = 3
    backoff_base_s: float = 0.01
    backoff_cap_s: float = 0.25
    jitter: float = 0.1
    seed: int = 0
    degrade_after: int = 2
    quarantine_after: int = 6
    launch_deadline_s: Optional[float] = None
    probe_after_skips: Optional[int] = None

    def __post_init__(self):
        if self.mode not in ("retry", "degrade"):
            raise ValueError(f"FaultConfig mode must be retry|degrade, "
                             f"got {self.mode!r}")
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.probe_after_skips is not None and self.probe_after_skips < 1:
            raise ValueError("probe_after_skips must be >= 1 (or None)")

    @classmethod
    def resolve(cls, on_fault) -> Optional["FaultConfig"]:
        """``None``/``"fail_fast"`` -> None (the pre-fault-tolerance
        abort-on-first-error path, byte-for-byte); ``"retry"``/``"degrade"``
        -> defaults; a ``FaultConfig`` instance passes through."""
        if on_fault is None or on_fault == "fail_fast":
            return None
        if isinstance(on_fault, cls):
            return on_fault
        if on_fault in ("retry", "degrade"):
            return cls(mode=on_fault)
        raise ValueError(
            f"on_fault must be 'fail_fast', 'retry', 'degrade' or a "
            f"FaultConfig, got {on_fault!r}"
        )


def backoff_delay(config: FaultConfig, attempt: int,
                  rng: np.random.Generator) -> float:
    """Capped exponential backoff with seeded jitter for attempt N >= 1."""
    base = min(config.backoff_base_s * (2.0 ** (attempt - 1)),
               config.backoff_cap_s)
    if base <= 0.0:
        return 0.0
    if config.jitter > 0.0:
        base *= 1.0 + config.jitter * float(rng.random())
    return base


@dataclass
class PredicateFaultState:
    """One predicate's fault history (see ``FaultLedger.snapshot`` for the
    exported key contract)."""

    name: str
    failures: int = 0
    successes: int = 0
    retries: int = 0
    consecutive_failures: int = 0
    quarantined: bool = False
    degraded: bool = False
    quarantined_batches: int = 0
    quarantined_rows: int = 0
    deadline_hits: int = 0
    skipped_routes: int = 0
    # recovery-probe state machine (FaultConfig.probe_after_skips):
    # skips arm probe_pending -> the eddy claims it (take_probe_route,
    # probe_inflight) -> the worker claims the single attempt
    # (begin_probe) -> end_probe either clears the quarantine or re-arms
    # the skip window
    skips_since_probe: int = 0
    probe_pending: bool = False
    probe_inflight: bool = False
    probes: int = 0
    unquarantines: int = 0
    last_error: str = ""
    error_rate: Ema = field(
        default_factory=lambda: Ema(FAULT_EMA_ALPHA)
    )
    rng: Optional[np.random.Generator] = None


class FaultLedger:
    """Per-predicate fault statistics shared by workers and the eddy.

    Writes (note_*) take the ledger lock but only run on failure /
    bookkeeping paths; ``rank_penalty`` — called once per predicate per
    routing decision — is lock-free and short-circuits to exactly 1.0
    until the first failure is recorded, so a fault-free run's rank keys
    are bit-identical to a ledger-less build (x * 1.0 == x)."""

    def __init__(self, predicate_names: Iterable[str] = (), *, seed: int = 0,
                 probe_after_skips: Optional[int] = None):
        self.seed = seed
        self.probe_after_skips = probe_after_skips
        self._lock = threading.Lock()
        self._entries: Dict[str, PredicateFaultState] = {}
        # lock-free fast-path flags (GIL-atomic bool reads)
        self.dirty = False            # any failure ever recorded
        self.has_quarantined = False  # any predicate currently quarantined
        for n in predicate_names:
            self._entry(n)

    def _entry(self, name: str) -> PredicateFaultState:
        st = self._entries.get(name)
        if st is None:
            with self._lock:
                st = self._entries.get(name)
                if st is None:
                    st = PredicateFaultState(
                        name, rng=_spec_rng(self.seed, name, 0)
                    )
                    self._entries[name] = st
        return st

    def entry(self, name: str) -> PredicateFaultState:
        return self._entry(name)

    # ------------------------- recording ------------------------- #
    def note_failure(self, name: str, error: Optional[BaseException] = None
                     ) -> int:
        """Record one failed evaluation attempt; returns the consecutive-
        failure count (the degrade/quarantine trigger)."""
        st = self._entry(name)
        with self._lock:
            self.dirty = True
            st.failures += 1
            st.consecutive_failures += 1
            st.error_rate.update(1.0)
            if error is not None:
                st.last_error = repr(error)
            return st.consecutive_failures

    def note_success(self, name: str) -> None:
        st = self._entry(name)
        with self._lock:
            st.successes += 1
            st.consecutive_failures = 0
            st.error_rate.update(0.0)

    def note_retry(self, name: str) -> None:
        st = self._entry(name)
        with self._lock:
            st.retries += 1

    def note_quarantined_batch(self, name: str, rows: int) -> None:
        st = self._entry(name)
        with self._lock:
            st.quarantined_batches += 1
            st.quarantined_rows += int(rows)

    def note_degraded(self, name: str) -> None:
        st = self._entry(name)
        with self._lock:
            st.degraded = True

    def note_deadline(self, name: str) -> None:
        st = self._entry(name)
        with self._lock:
            self.dirty = True
            st.deadline_hits += 1

    def note_skip(self, name: str) -> None:
        st = self._entry(name)
        with self._lock:
            st.skipped_routes += 1
            if (self.probe_after_skips is not None and st.quarantined
                    and not st.probe_pending and not st.probe_inflight):
                st.skips_since_probe += 1
                if st.skips_since_probe >= self.probe_after_skips:
                    st.probe_pending = True
                    st.skips_since_probe = 0

    def set_quarantined(self, name: str) -> bool:
        """Quarantine ``name``; returns True if newly quarantined."""
        st = self._entry(name)
        with self._lock:
            if st.quarantined:
                return False
            st.quarantined = True
            st.skips_since_probe = 0
            st.probe_pending = False
            st.probe_inflight = False
            self.has_quarantined = True
            return True

    def clear_quarantine(self, name: str) -> bool:
        """Lift ``name``'s quarantine (probe success); returns True if it
        was quarantined.  Resets the consecutive-failure streak so the
        next real failure starts a fresh window rather than instantly
        re-quarantining."""
        st = self._entry(name)
        with self._lock:
            if not st.quarantined:
                return False
            st.quarantined = False
            st.consecutive_failures = 0
            st.skips_since_probe = 0
            st.probe_pending = False
            st.probe_inflight = False
            st.unquarantines += 1
            self.has_quarantined = any(
                s.quarantined for s in self._entries.values()
            )
            return True

    # ------------------------- recovery probes ------------------------- #
    def take_probe_route(self, name: str) -> bool:
        """Eddy-side claim: route ONE batch to quarantined ``name`` as a
        recovery probe instead of skipping it.  At most one probe is in
        flight per predicate; returns True exactly once per armed probe."""
        st = self._entry(name)
        with self._lock:
            if not (st.quarantined and st.probe_pending):
                return False
            st.probe_pending = False
            st.probe_inflight = True
            st.probes += 1
            return True

    def begin_probe(self, name: str) -> bool:
        """Worker-side claim of the in-flight probe: the caller must give
        the quarantined predicate exactly ONE evaluation attempt (no
        retries) and report the outcome via ``end_probe``.  Returns False
        for any non-probe batch that raced into a quarantined predicate's
        queue (those pass through as before)."""
        st = self._entry(name)
        with self._lock:
            if not st.probe_inflight:
                return False
            st.probe_inflight = False
            return True

    def end_probe(self, name: str, success: bool) -> bool:
        """Probe outcome: success lifts the quarantine (returns True);
        failure re-arms the skip window so the next probe waits another
        full ``probe_after_skips`` skips."""
        if success:
            return self.clear_quarantine(name)
        st = self._entry(name)
        with self._lock:
            st.skips_since_probe = 0
            st.probe_pending = False
            st.probe_inflight = False
            return False

    # ------------------------- reading ------------------------- #
    def is_quarantined(self, name: str) -> bool:
        if not self.has_quarantined:
            return False
        st = self._entries.get(name)
        return st is not None and st.quarantined

    def quarantined_names(self) -> Tuple[str, ...]:
        if not self.has_quarantined:
            return ()
        with self._lock:
            return tuple(
                n for n, st in self._entries.items() if st.quarantined
            )

    def failed_names(self) -> Tuple[str, ...]:
        """Predicates with at least one recorded failure.  The eddy exempts
        these from the warmup all-measured gate: a failing predicate may
        never produce a measurement, and warmup dispatches one batch per
        predicate exactly once — waiting on it would circulate every other
        batch forever.  (Exempt, not skipped: normal ranking still routes
        batches to it, so it either recovers and gets measured or keeps
        failing until quarantine removes it.)"""
        if not self.dirty:
            return ()
        with self._lock:
            return tuple(
                n for n, st in self._entries.items() if st.failures > 0
            )

    def error_rate_of(self, name: str) -> float:
        st = self._entries.get(name)
        return 0.0 if st is None else st.error_rate.get(0.0)

    def rank_penalty(self, name: str) -> float:
        """Routing rank multiplier: exactly 1.0 for a never-failed
        predicate (bit-exact fault-free ranking), growing linearly in the
        error-rate EMA for a flaky one."""
        if not self.dirty:
            return 1.0
        st = self._entries.get(name)
        if st is None:
            return 1.0
        rate = st.error_rate.get(0.0)
        return 1.0 if rate <= 0.0 else 1.0 + FAULT_PENALTY_WEIGHT * rate

    def jitter_rng(self, name: str) -> np.random.Generator:
        return self._entry(name).rng

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        """Exported under ``stats_snapshot()["_faults"]``.  Per predicate:

        failures / successes / retries — attempt-level counters;
        consecutive_failures — current streak (degrade/quarantine trigger);
        error_rate — failure-probability EMA (the routing rank penalty);
        quarantined / degraded — current state flags;
        quarantined_batches / quarantined_rows — poison batches completed
        via the conservative pass-through verdict;
        deadline_hits — launches past ``launch_deadline_s``;
        skipped_routes — routing decisions that skipped this predicate
        because it was quarantined;
        probes — recovery probes routed (``probe_after_skips`` armed);
        unquarantines — quarantines lifted by a probe success;
        last_error — repr of the most recent failure."""
        with self._lock:
            return {
                n: {
                    "failures": st.failures,
                    "successes": st.successes,
                    "retries": st.retries,
                    "consecutive_failures": st.consecutive_failures,
                    "error_rate": st.error_rate.get(0.0),
                    "quarantined": st.quarantined,
                    "degraded": st.degraded,
                    "quarantined_batches": st.quarantined_batches,
                    "quarantined_rows": st.quarantined_rows,
                    "deadline_hits": st.deadline_hits,
                    "skipped_routes": st.skipped_routes,
                    "probes": st.probes,
                    "unquarantines": st.unquarantines,
                    "last_error": st.last_error,
                }
                for n, st in self._entries.items()
            }


class LaunchWatchdog:
    """Flags in-flight launches older than ``deadline_s`` (wall clock).

    ``begin``/``end`` bracket a launch (called by the worker retry loop
    and the ``kernels.launch`` pallas_call wrapper via
    ``set_launch_watchdog``); a daemon scan thread (name
    ``fault-watchdog``, guarded by the conftest leaked-thread check)
    flags each overdue launch exactly once through ``on_deadline(name,
    elapsed)``.  It cannot preempt the hung launch — Python can't
    interrupt a thread blocked in a foreign call — the point is that the
    fault ledger learns about the hang while it is still in progress, so
    routing steers new work away instead of stacking onto the wedged
    worker.  ``scan`` is callable directly (with an explicit ``now``) for
    deterministic tests; ``start`` is optional."""

    def __init__(self, deadline_s: float,
                 on_deadline: Callable[[str, float], None],
                 *, interval_s: Optional[float] = None):
        self.deadline_s = float(deadline_s)
        self.on_deadline = on_deadline
        self.interval_s = interval_s or max(self.deadline_s / 4.0, 0.01)
        self._inflight: Dict[int, list] = {}  # token -> [name, start, flagged]
        self._count = itertools.count(1)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.began = 0
        self.flagged = 0

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="fault-watchdog"
        )
        self._thread.start()

    def begin(self, name: str) -> int:
        token = next(self._count)
        with self._lock:
            self._inflight[token] = [name, time.monotonic(), False]
            self.began += 1
        return token

    def end(self, token: int) -> None:
        with self._lock:
            self._inflight.pop(token, None)

    def inflight(self) -> int:
        with self._lock:
            return len(self._inflight)

    def scan(self, now: Optional[float] = None) -> int:
        """Flag overdue launches once; returns how many were flagged."""
        now = time.monotonic() if now is None else now
        overdue = []
        with self._lock:
            for entry in self._inflight.values():
                name, start, seen = entry
                elapsed = now - start
                if not seen and elapsed > self.deadline_s:
                    entry[2] = True
                    self.flagged += 1
                    overdue.append((name, elapsed))
        for name, elapsed in overdue:
            try:
                self.on_deadline(name, elapsed)
            except Exception:
                pass  # observability must never take down the scan thread
        return len(overdue)

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.scan()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
            self._thread = None


class ReverifyQueue:
    """Drains conservative pass-through verdicts once a predicate recovers.

    Quarantine / poison-batch completion keeps every row (flagged in
    ``batch.passthrough``) so the termination barrier and row-id-multiset
    invariants hold — but the flagged rows were never actually FILTERED by
    the flagged predicate.  With the executor knob ``reverify=True`` the
    run loop intercepts flagged output batches here instead of emitting
    them; ``drain()`` re-evaluates each held batch through every flagged
    predicate that has since RECOVERED (not quarantined, current streak
    clean, at least one recorded success — e.g. after a probe
    un-quarantine), clears the flag (``batch.clear_passthrough``), and
    applies the real row filter.  A predicate that never recovers within
    the run releases its batches still-flagged at the final forced drain,
    preserving the conservative contract.

    Re-verification runs on the executor's OWN thread (offer/drain are
    called from the run loop, never from workers) and deliberately
    bypasses the cache and SimClock occupancy: it is an audit path, not
    the measured hot path, and the held batches already completed —
    re-evaluation must not perturb pinned virtual timelines.  Failures
    during re-verification are recorded in the ledger like any other
    attempt and leave the flag in place."""

    def __init__(self, predicates, ledger: FaultLedger,
                 *, fault_plan: Optional[FaultPlan] = None,
                 clock: Optional[object] = None):
        self._preds = {p.name: p for p in predicates}
        self.ledger = ledger
        self.fault_plan = fault_plan
        self.clock = clock
        self._held: list = []
        self._lock = threading.Lock()
        self.intercepted = 0
        self.reverified_batches = 0
        self.reverified_rows = 0
        self.dropped_rows = 0
        self.released_flagged = 0

    def offer(self, batch):
        """Intercept ``batch`` if it carries pass-through flags; returns
        the batch unchanged when clean, None when held for re-verify."""
        if not batch.passthrough:
            return batch
        with self._lock:
            self._held.append(batch)
            self.intercepted += 1
        return None

    def pending(self) -> int:
        with self._lock:
            return len(self._held)

    def _recovered(self, name: str) -> bool:
        st = self.ledger.entry(name)
        with self.ledger._lock:
            return (not st.quarantined and st.consecutive_failures == 0
                    and st.successes > 0)

    def _reverify_one(self, pred, batch):
        """One single-attempt re-evaluation; None on failure (flag kept)."""
        data = {c: batch.data[c] for c in pred.udf.columns}
        try:
            if self.fault_plan is not None:
                outputs = self.fault_plan.invoke(pred, data, self.clock)
                self.fault_plan.take_extra_cost()  # discard virtual hangs
            else:
                outputs = pred.evaluate_outputs(data)
            out = np.asarray(outputs)
            if out.ndim == 0 or out.shape[0] != batch.rows:
                raise CorruptOutputError(
                    f"{pred.name}: reverify expected {batch.rows} output "
                    f"rows, got shape {out.shape}"
                )
        except Exception as e:
            self.ledger.note_failure(pred.name, error=e)
            return None
        self.ledger.note_success(pred.name)
        mask = pred.mask_from_outputs(out)
        refined = batch.clear_passthrough(pred.name).filter(mask)
        self.reverified_rows += batch.rows
        self.dropped_rows += batch.rows - refined.rows
        return refined

    def drain(self, *, force: bool = False) -> list:
        """Re-verify held batches whose flagged predicates recovered.

        Returns the batches ready for release: fully re-verified ones
        (flags cleared, rows filtered) and — under ``force=True``, the
        end-of-run flush — still-flagged batches released as-is (the
        pre-reverify conservative contract).  Batches with unrecovered
        flags stay held unless forced."""
        with self._lock:
            held, self._held = self._held, []
        out, keep = [], []
        for batch in held:
            for name in sorted(batch.passthrough):
                pred = self._preds.get(name)
                if pred is None or not self._recovered(name):
                    continue
                refined = self._reverify_one(pred, batch)
                if refined is not None:
                    batch = refined
                    self.reverified_batches += 1
            if batch.passthrough and not force:
                keep.append(batch)
            else:
                if batch.passthrough:
                    self.released_flagged += 1
                out.append(batch)
        if keep:
            with self._lock:
                self._held = keep + self._held
        return out

    def snapshot(self) -> Dict[str, int]:
        """Exported under ``stats_snapshot()["_service"]`` /
        per-query telemetry."""
        with self._lock:
            return {
                "pending": len(self._held),
                "intercepted": self.intercepted,
                "reverified_batches": self.reverified_batches,
                "reverified_rows": self.reverified_rows,
                "dropped_rows": self.dropped_rows,
                "released_flagged": self.released_flagged,
            }
