"""Deterministic simulated clock for scheduling experiments.

The paper's scheduling claims (Fig. 4: cost-driven = 14 time units vs
score-driven = 20; Fig. 7 sweeps; Fig. 11 scaling) depend on concurrency
that a 1-core CPU container cannot physically exhibit. The routing logic in
this repo is clock-agnostic: executors take a ``Clock``, and ``SimClock``
advances virtual time per (worker, batch) from the predicates' cost models —
making the paper's timelines exactly reproducible and assertable in tests.
``WallClock`` is the production clock.

MICRO-BATCH COALESCING under SimClock: a fused launch is ONE
``occupy_shared`` call — ``ready`` is the fused batch's ``sim_ready``
(the max over its constituents, i.e. the last arrival) and ``cost`` is
the cost model evaluated once over the summed computed rows, so an affine
model pays one fixed launch term plus the summed per-row terms.  Every
split output inherits the single fused finish as its ``sim_ready``.  The
deterministic suites keep coalescing OFF (executor default): their pinned
timelines assume one launch per batch.
"""
from __future__ import annotations

import heapq
import threading
import time
from dataclasses import dataclass, field
from typing import Dict


class WallClock:
    simulated = False

    def now(self) -> float:
        return time.monotonic()

    def sleep(self, dt: float) -> None:
        time.sleep(dt)


@dataclass
class SimClock:
    """Virtual time with per-resource busy tracking.

    Workers call ``occupy(resource, cost)``: the batch completes at
    ``max(now, resource_free) + cost``; the resource's free-time advances.
    Concurrency across resources is exact and deterministic.
    """

    simulated = True
    _now: float = 0.0
    _free: Dict[str, float] = field(default_factory=dict)
    _busy: Dict[str, float] = field(default_factory=dict)  # cumulative occupancy
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def now(self) -> float:
        with self._lock:
            return self._now

    def sleep(self, dt: float) -> None:
        with self._lock:
            self._now += dt

    def occupy(self, resource: str, cost: float, *, ready: float = None) -> float:
        """Schedule ``cost`` seconds of work on ``resource``; returns finish time."""
        with self._lock:
            start = max(self._now if ready is None else ready, self._free.get(resource, 0.0))
            finish = start + cost
            self._free[resource] = finish
            self._now = max(self._now, finish)
            return finish

    def occupy_shared(self, worker: str, device: str, cost: float,
                      serial_fraction: float = 0.0, ready: float = 0.0) -> float:
        """Worker-local cost with a ``serial_fraction`` contending on the
        shared device resource — models spatial multiplexing saturation
        (paper §5.1: overlap of data movement / CPU / device compute).

        ``ready`` is the batch's virtual arrival time: starts are
        max(ready, resource_free) — NOT the global clock — so the virtual
        timeline is a proper discrete-event simulation, independent of the
        real thread interleaving.
        """
        with self._lock:
            start = max(ready, self._free.get(worker, 0.0),
                        self._free.get(device, 0.0))
            finish = start + cost
            self._free[worker] = finish
            self._free[device] = start + cost * serial_fraction
            self._busy[worker] = self._busy.get(worker, 0.0) + cost
            self._busy[device] = self._busy.get(device, 0.0) + cost * serial_fraction
            self._now = max(self._now, finish)
            return finish

    def resource_busy_until(self, resource: str) -> float:
        with self._lock:
            return self._free.get(resource, 0.0)

    def release_horizon(self, resource: str) -> float:
        """Detach and return a retiring lease's busy horizon (§5.2).

        The outstanding virtual work now belongs to the released SLOT, not
        the retired worker: clearing the worker's entry means a later
        re-lease of the same context starts from the slot's inherited
        horizon — never from a stale copy of work that was already handed
        off (which would double-count it)."""
        with self._lock:
            return self._free.pop(resource, 0.0)

    def seed_horizon(self, resource: str, until: float) -> None:
        """Seed a new lease holder with its slot's inherited busy horizon.

        The slot models one physical execution context, so the new lease
        cannot start before the previous holder's outstanding virtual work
        drains — this is what keeps the deterministic Fig. 7 / UC3
        timelines exact across cross-predicate reallocation. The value is
        carried on the Slot itself (recorded by ``release_horizon``), so
        the transfer also works when two executors with separate SimClocks
        share one DevicePool."""
        with self._lock:
            if until > self._free.get(resource, 0.0):
                self._free[resource] = until

    def lease_handoff(self, frm: str, to: str) -> None:
        """Same-clock convenience: MOVE ``frm``'s horizon onto ``to``."""
        self.seed_horizon(to, self.release_horizon(frm))

    def busy_time(self, resource: str) -> float:
        """Cumulative occupied seconds (utilization numerator, Fig 12)."""
        with self._lock:
            return self._busy.get(resource, 0.0)

    @property
    def makespan(self) -> float:
        # _now tracks the max finish ever scheduled, so the makespan
        # survives released leases detaching their _free entries
        with self._lock:
            return max([self._now, *self._free.values()])
