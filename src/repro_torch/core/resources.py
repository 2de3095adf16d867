"""Elastic resource arbiter (§5.2): cross-predicate worker leasing.

Hydro "dynamically allocates resources for evaluating predicates": capacity
is not pinned to a predicate for the lifetime of a query but flows to
wherever the bottleneck currently is. This module is the subsystem that
makes that true in this reproduction:

``DevicePool``
    Process-wide slot inventory per device group. A *slot* is the right to
    run one worker on that group. Groups may be bounded (``capacity``) or
    unbounded (the default — reproducing the per-predicate private pools
    that predate the arbiter). Slots remember their last holder so a
    handed-off lease can inherit the holder's simulated busy horizon
    (``SimClock.lease_handoff``), keeping the deterministic Fig. 7 / UC3
    timelines exact across reallocation.

``ResourceArbiter``
    Owns every ``WorkerContext`` (greedy allocation — contexts are cheap;
    activation stays conservative, per GACU §5.1) and leases device slots
    to predicates. Lifecycle of a lease:

      1. ``register(name, ...)`` — a ``LaminarRouter`` hands the arbiter a
         context factory; the arbiter pre-creates ``num_workers`` contexts.
      2. ``lease(name)`` — the router asks for one more worker. The
         configured ``ArbiterPolicy`` arbitrates between claimants: the
         default ``PressureRanked`` policy grants the slot to the claimant
         with the highest measured cost x queue-depth pressure (profiled
         statistics from the StatsBoard, never a-priori estimates — the
         GRACEFUL stance on UDF cost). A predicate with no leased worker
         bypasses ranking (floor guarantee: no starvation).
      3. ``release(name, worker)`` — the scale-DOWN path: the router
         retires a lease whose queue sat idle past the drain threshold;
         the slot returns to the pool, claimable by ANOTHER predicate's
         router (cross-predicate reallocation, counted in
         ``cross_pred_handoffs``).
      4. ``unregister(name)`` — executor shutdown; all held slots return.

    Counters (``counters()``) are surfaced through
    ``AQPExecutor.stats_snapshot()`` under the reserved ``"_arbiter"`` key.

    Multi-tenancy (QueryService, launch/serve.py): registrations — and
    therefore leases and slots — carry a QUERY identity (``register(...,
    query=...)``; ``Slot.last_query``), and each query may carry an
    URGENCY weight (``note_query_admitted``) folded into ``PressureRanked``
    arbitration so a higher-priority or deadline-pressed query wins
    contended slots at equal measured pressure. Admission and completion
    trigger a PREEMPTION-FREE ``rebalance()``: standing wants from
    predicates that no longer exert pressure are cleared so freed capacity
    flows to live claimants on their next ask — held leases are never
    revoked (routers retire their own leases via the drain path).

Thread-safety / lock order: router lock -> arbiter lock -> pool lock.
Pressure evaluation inside the arbiter deliberately reads only leaf-locked
structures (worker queues, PredicateStats) — never a router lock — so a
claimant's lease() can never deadlock against another router's retire path.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional

from repro_torch.core.policies import ArbiterPolicy, PressureRanked
from repro_torch.core.stats import StatsBoard

# Scale-down drain threshold (seconds of queue idleness before a worker
# lease retires). Generous by default so short-lived runs behave exactly
# like the pre-arbiter private pools; contended-pool deployments pass
# something much smaller (the UC2-realloc benchmark uses 0.05s).
DRAIN_THRESHOLD_S = 2.0


@dataclass
class Slot:
    """One unit of device-group capacity, handed out by the DevicePool."""

    group: str
    index: int
    last_holder: Optional[str] = None   # wid of the previous lease holder
    last_pred: Optional[str] = None     # predicate that last held the slot
    last_query: Optional[str] = None    # query identity of the last lease
    sim_horizon: float = 0.0            # SimClock busy horizon at release


class DevicePool:
    """Slot inventory per device group (process-wide when shared).

    ``capacity`` maps device-group name -> slot count; groups not listed
    fall back to ``default_capacity`` (``None`` = unbounded, the
    pre-arbiter behavior). Released slots are reissued LIFO so a re-leased
    slot is the most recently drained one — the holder whose simulated
    horizon is most likely still warm."""

    def __init__(self, capacity: Optional[Mapping[str, int]] = None,
                 default_capacity: Optional[int] = None):
        self._capacity = dict(capacity or {})
        self._default = default_capacity
        self._free: Dict[str, List[Slot]] = {}
        self._created: Dict[str, int] = {}
        self._lock = threading.Lock()

    def capacity_of(self, group: str) -> Optional[int]:
        return self._capacity.get(group, self._default)

    def in_use(self, group: str) -> int:
        with self._lock:
            return self._created.get(group, 0) - len(self._free.get(group, ()))

    def try_acquire(self, group: str) -> Optional[Slot]:
        with self._lock:
            free = self._free.get(group)
            if free:
                return free.pop()
            cap = self._capacity.get(group, self._default)
            n = self._created.get(group, 0)
            if cap is not None and n >= cap:
                return None
            self._created[group] = n + 1
            return Slot(group=group, index=n)

    def release(self, slot: Slot) -> None:
        with self._lock:
            self._free.setdefault(slot.group, []).append(slot)


class ResourceArbiter:
    """Owns all worker contexts; leases device slots to predicates."""

    def __init__(self, pool: Optional[DevicePool] = None,
                 policy: Optional[ArbiterPolicy] = None):
        self.pool = pool or DevicePool()
        self.policy = policy or PressureRanked()
        self._lock = threading.RLock()
        self._contexts: Dict[str, List] = {}
        self._leased: Dict[str, List] = {}
        self._slot_of: Dict[str, Slot] = {}      # wid -> held slot
        self._stats: Dict[str, StatsBoard] = {}
        self._clock: Dict[str, object] = {}
        self._wants: Dict[str, bool] = {}        # denied claimants (live ask)
        self._query: Dict[str, Optional[str]] = {}   # name -> query identity
        self._urgency: Dict[str, float] = {}     # query -> arbitration weight
        # reallocation counters (exposed via AQPExecutor.stats_snapshot)
        self.leases = 0
        self.releases = 0
        self.denials = 0
        self.cross_pred_handoffs = 0
        self.cross_query_handoffs = 0
        self.rebalances = 0

    # --------------------------- registration --------------------------- #
    def register(self, name: str, *, num_workers: int,
                 factory: Callable[[int], object],
                 stats: Optional[StatsBoard] = None,
                 clock: Optional[object] = None,
                 query: Optional[str] = None) -> List:
        """Greedy allocation: pre-create and return all contexts for
        ``name``.

        ``factory(i)`` builds the i-th context (the router closes over its
        queues/callbacks); the arbiter owns the list while registered and
        ALSO returns it so the registrant can keep its own reference — a
        long-lived shared arbiter drops the list on ``unregister`` rather
        than accumulating dead executors' worker graphs. A name may
        re-register only after ``unregister`` (sequential executors can
        reuse a shared arbiter); a currently-registered name is rejected
        outright — silently replacing another executor's contexts would
        cross-wire their pipelines."""
        with self._lock:
            if name in self._contexts:
                raise ValueError(
                    f"predicate {name!r} is already registered with this"
                    " arbiter (executors sharing an arbiter need distinct"
                    " predicate names; share only the DevicePool otherwise)"
                )
            ctxs = [factory(i) for i in range(num_workers)]
            self._contexts[name] = ctxs
            self._leased[name] = []
            if stats is not None:
                self._stats[name] = stats
            if clock is not None:
                self._clock[name] = clock
            self._wants[name] = False
            self._query[name] = query
            return ctxs

    def unregister(self, name: str) -> None:
        """Return every slot held by ``name`` and drop the registration
        (contexts included — the registrant holds its own reference)."""
        with self._lock:
            for w in list(self._leased.get(name, ())):
                self._release_locked(name, w)
            self._contexts.pop(name, None)
            self._leased.pop(name, None)
            self._wants.pop(name, None)
            self._stats.pop(name, None)
            self._clock.pop(name, None)
            self._query.pop(name, None)

    # ----------------------------- inventory ---------------------------- #
    def contexts(self, name: str) -> List:
        with self._lock:
            return list(self._contexts.get(name, ()))

    def leased(self, name: str) -> List:
        with self._lock:
            return list(self._leased.get(name, ()))

    @property
    def scale_down_enabled(self) -> bool:
        return self.policy.scale_down

    # ----------------------------- pressure ----------------------------- #
    def pressure_of(self, name: str) -> float:
        """Measured cost x queue-depth pressure of a claimant.

        Reads only leaf-locked state (worker input queues + the predicate's
        StatsBoard entry) — safe to evaluate under the arbiter lock from
        any thread."""
        with self._lock:
            leased = list(self._leased.get(name, ()))
            board = self._stats.get(name)
        depth = sum(len(w.queue) for w in leased)
        if board is None:
            return float(depth)
        return board[name].pressure(depth)

    # ------------------------------ leasing ------------------------------ #
    def lease(self, name: str):
        """Grant one worker lease to ``name``, or None (ceiling/denied).

        Floor guarantee: a claimant holding zero leases skips policy
        arbitration — it only needs a physically free slot — so a drained
        predicate can never be starved out of its last worker by a
        high-pressure rival."""
        with self._lock:
            ctxs = self._contexts.get(name)
            if ctxs is None:
                return None  # unregistered (e.g. a stray post-shutdown ask)
            held = self._leased[name]
            held_ids = {id(w) for w in held}
            candidates = [w for w in ctxs if id(w) not in held_ids]
            if not candidates:
                return None  # at this predicate's own ceiling
            if held:  # non-floor request: arbitrate between claimants
                pressures = {n: self.pressure_of(n) for n in self._contexts}
                # only rivals that could USE one of the requested groups
                # count: a standing claim on an exhausted 'gpu' group must
                # not block this predicate's free 'cpu' capacity
                groups = {w.device_group for w in candidates}
                wants = {
                    n: (w and bool(self._groups_locked(n) & groups))
                    for n, w in self._wants.items()
                }
                held_counts = {n: len(l) for n, l in self._leased.items()}
                urgency = {
                    n: self._urgency.get(self._query.get(n), 1.0)
                    for n in self._contexts
                } if self._urgency else None
                if not self.policy.grant(name, pressures=pressures,
                                         wants=wants, held=held_counts,
                                         urgency=urgency):
                    self._deny_locked(name)
                    return None
            for w in candidates:  # index order: deterministic activation
                slot = self.pool.try_acquire(w.device_group)
                if slot is None:
                    continue
                self._bind_locked(name, w, slot)
                return w
            self._deny_locked(name)
            return None

    def _groups_locked(self, name: str) -> set:
        return {w.device_group for w in self._contexts.get(name, ())}

    def _deny_locked(self, name: str) -> None:
        # count standing claims, not retry polls: routers re-ask a denied
        # lease every submit iteration, which would inflate the counter
        if not self._wants.get(name, False):
            self.denials += 1
        self._wants[name] = True

    def release(self, name: str, worker) -> None:
        with self._lock:
            self._release_locked(name, worker)

    # ----------------------------- internals ----------------------------- #
    def _bind_locked(self, name: str, w, slot: Slot) -> None:
        if slot.last_pred is not None and slot.last_pred != name:
            self.cross_pred_handoffs += 1
        query = self._query.get(name)
        if slot.last_query is not None and slot.last_query != query:
            self.cross_query_handoffs += 1
        slot.last_query = query
        clock = self._clock.get(name)
        if getattr(clock, "simulated", False) and slot.sim_horizon > 0.0:
            # the new lease inherits the physical slot's virtual horizon
            # (recorded at release), keeping deterministic timelines exact
            # across handoff — including across executors with separate
            # SimClocks that share only the DevicePool
            clock.seed_horizon(w.wid, slot.sim_horizon)
        slot.last_holder = w.wid
        slot.last_pred = name
        self._slot_of[w.wid] = slot
        self._leased[name].append(w)
        self._wants[name] = False
        self.leases += 1

    def _release_locked(self, name: str, w) -> None:
        held = self._leased.get(name, [])
        if w not in held:
            return
        held.remove(w)
        slot = self._slot_of.pop(w.wid, None)
        if slot is not None:
            clock = self._clock.get(name)
            if getattr(clock, "simulated", False):
                # detach the worker's horizon: the outstanding virtual
                # work travels with the SLOT from here on
                slot.sim_horizon = clock.release_horizon(w.wid)
            else:
                slot.sim_horizon = 0.0
            slot.last_holder = w.wid
            slot.last_pred = name
            slot.last_query = self._query.get(name)
            self.pool.release(slot)
        self._wants[name] = False
        self.releases += 1

    # --------------------------- multi-tenancy --------------------------- #
    def note_query_admitted(self, query: str, urgency: float = 1.0) -> None:
        """A query entered the service: record its arbitration urgency.

        ``urgency`` (see ``policies.urgency_weight``) multiplies the
        measured pressure of every predicate registered under ``query``
        during ``PressureRanked`` arbitration. Admission triggers a
        preemption-free ``rebalance()`` so standing wants from finished
        tenants don't shadow the newcomer's first asks."""
        with self._lock:
            self._urgency[query] = float(urgency)
        self.rebalance()

    def note_query_finished(self, query: str) -> None:
        """A query left the service: drop its urgency and rebalance."""
        with self._lock:
            self._urgency.pop(query, None)
        self.rebalance()

    def rebalance(self) -> None:
        """Preemption-free rebalance on query admit/finish.

        Clears standing wants from claimants that no longer exert pressure
        (their queues drained or they unregistered) so freed capacity flows
        to live claimants on their next ask. Held leases are NEVER revoked
        — routers retire their own leases via the drain path."""
        with self._lock:
            stale = [
                n for n, wanting in self._wants.items()
                if wanting and (n not in self._contexts
                                or self.pressure_of(n) <= 0.0)
            ]
            for n in stale:
                self._wants[n] = False
            self.rebalances += 1

    # ------------------------------ metrics ------------------------------ #
    def counters(self) -> Dict[str, object]:
        with self._lock:
            return {
                "leases": self.leases,
                "releases": self.releases,
                "denials": self.denials,
                "cross_pred_handoffs": self.cross_pred_handoffs,
                "cross_query_handoffs": self.cross_query_handoffs,
                "rebalances": self.rebalances,
                "policy": self.policy.name,
            }
