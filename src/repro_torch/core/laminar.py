"""Laminar router (§5): per-predicate elastic parallelism with GACU.

Greedy-allocation-conservative-use: ``max_workers`` contexts per predicate
are created up front (cheap — no compilation, no device buffers) and owned
by the ResourceArbiter; a worker only initializes when the router first
routes a batch to it. Capacity is LEASED, not owned: the router claims a
device slot from the arbiter whenever every active worker's input queue is
saturated (the utilization proxy: queue backpressure == device-idle
opportunity) up to the configured ceiling — "spawning through routing", no
pipeline surgery mid-query.

Scale-DOWN (§5.2): a worker whose queue has been idle past the drain
threshold offers to retire (``_on_worker_idle``); the router accepts when
it holds more than its one-worker floor, returning the slot to the
DevicePool so ANOTHER predicate's router can claim it — cross-predicate
reallocation, the paper's "dynamically allocates resources for evaluating
predicates". By default each executor gets a private unbounded pool, which
reproduces the pre-arbiter behavior exactly; contended deployments share a
bounded pool (see benchmarks/bench_uc2_realloc.py).

Device placement: workers are assigned to device groups round-robin at
construction; the DeviceAlternating policy keeps consecutive batches on
alternating devices (the paper's GPU-aware load balancing when scaling out).
"""
from __future__ import annotations

import threading
import time
from typing import List, Optional, Sequence

from repro_torch.core.batch import RoutingBatch
from repro_torch.core.cache import ReuseCache
from repro_torch.core.coalesce import CoalesceConfig, CoalescePlanner
from repro_torch.core.policies import LaminarPolicy, RoundRobin
from repro_torch.core.queues import BoundedQueue, CentralQueue
from repro_torch.core.resources import DRAIN_THRESHOLD_S, ResourceArbiter
from repro_torch.core.simclock import SimClock
from repro_torch.core.stats import StatsBoard
from repro_torch.core.udf import Predicate
from repro_torch.core.worker import WorkerContext

GACU_MAX_WORKERS = 50  # paper's hardcoded per-device ceiling

# back-off while the floor lease is denied (shared pool fully claimed by
# higher-pressure predicates); the submit loop retries until granted, and
# raises after the deadline — a predicate that cannot hold even one worker
# can never finish the query, and a loud error beats a silent hang
_FLOOR_RETRY_SLEEP_S = 0.01
FLOOR_STARVATION_DEADLINE_S = 10.0

# Wall poll interval for the VIRTUAL-idle drain path (``virtual_drain=``):
# under SimClock the retire *decision* reads only virtual state (the
# router's observed virtual frontier vs the worker's busy horizon), so the
# wall-clock poll cadence cannot change WHICH workers retire — only how
# promptly the deterministic verdict is acted on.
_VIRTUAL_DRAIN_POLL_S = 0.02


class LaminarRouter:
    def __init__(
        self,
        pred: Predicate,
        central: CentralQueue,
        stats: StatsBoard,
        *,
        cache: Optional[ReuseCache] = None,
        clock=None,
        policy: Optional[LaminarPolicy] = None,
        max_workers: int = GACU_MAX_WORKERS,
        devices: Sequence[str] = ("cpu",),
        serial_fraction: float = 0.0,
        on_error=None,
        arbiter: Optional[ResourceArbiter] = None,
        drain_threshold: Optional[float] = DRAIN_THRESHOLD_S,
        launch_token=None,
        coalesce: Optional[CoalesceConfig] = None,
        worker_queue_capacity: int = 2,
        fault_plan=None,
        fault_ledger=None,
        fault_config=None,
        watchdog=None,
        tracker=None,
        virtual_drain: bool = False,
        query: Optional[str] = None,
    ):
        self.pred = pred
        self.stats = stats
        self.policy = policy or RoundRobin()
        self.clock = clock
        self.max_workers = max(1, max_workers)
        self.arbiter = arbiter or ResourceArbiter()
        self.retirements = 0
        # One planner per predicate, SHARED by all its workers: the fused
        # launches any worker records refine the decomposition every other
        # worker's fuse target reads. None == the pre-coalescing loop.
        self.coalesce_planner = (
            CoalescePlanner(pred, stats[pred.name], coalesce,
                            wall_clock=not isinstance(clock, SimClock))
            if coalesce is not None else None
        )
        self._worker_queue_capacity = max(1, worker_queue_capacity)
        self._virtual_drain = bool(virtual_drain) and isinstance(clock, SimClock)
        idle_timeout = drain_threshold
        if isinstance(clock, SimClock):
            if self._virtual_drain and drain_threshold is not None:
                # virtual-idle drain: the threshold is measured in VIRTUAL
                # seconds of horizon idleness (_on_worker_idle reads the
                # SimClock, never the wall), so deterministic benchmarks
                # exercise scale-down too; the worker's wall idle_timeout
                # becomes just a poll cadence for the virtual verdict
                idle_timeout = _VIRTUAL_DRAIN_POLL_S
            else:
                # wall-clock queue idleness is meaningless in virtual time
                # and would make the deterministic timelines depend on real
                # thread scheduling: scale-down stays off under SimClock
                # unless virtual_drain= opts in
                drain_threshold = None
                idle_timeout = None
        self._drain_threshold = drain_threshold
        self._sim_frontier = 0.0  # latest virtual arrival seen by submit
        self._lock = threading.RLock()
        self._active: List[WorkerContext] = []

        def _factory(i: int) -> WorkerContext:
            return WorkerContext(
                wid=f"{pred.name}#{i}",
                index=i,
                pred=pred,
                central=central,
                stats=stats,
                cache=cache,
                clock=clock,
                device_group=devices[i % len(devices)],
                serial_fraction=serial_fraction,
                on_error=on_error,
                idle_timeout=idle_timeout,
                on_idle=self._on_worker_idle,
                launch_token=launch_token,
                coalesce=self.coalesce_planner,
                queue=BoundedQueue(self._worker_queue_capacity),
                fault_plan=fault_plan,
                ledger=fault_ledger,
                fault_config=fault_config,
                watchdog=watchdog,
                tracker=tracker,
            )

        # GREEDY allocation of worker contexts (lazy until first batch),
        # owned by the arbiter while registered; the router keeps its own
        # reference for inspection so a long-lived shared arbiter does not
        # accumulate dead executors' contexts after unregister(). The
        # floor slot is leased lazily on the first submit — a constructed
        # but never-run executor must not hold shared-pool capacity.
        self._contexts = self.arbiter.register(
            pred.name, num_workers=self.max_workers,
            factory=_factory, stats=stats, clock=clock, query=query,
        )

    # ------------------------------------------------------------------ #
    @property
    def workers(self) -> List[WorkerContext]:
        """All greedily-allocated contexts (leased or not)."""
        return list(self._contexts)

    @property
    def active_workers(self) -> List[WorkerContext]:
        with self._lock:
            return list(self._active)

    def _insert(self, w: WorkerContext) -> None:
        self._active.append(w)
        self._active.sort(key=lambda c: c.index)  # deterministic order

    def _ensure_floor(self) -> None:
        """Hold at least one lease (retry happens in the submit loop)."""
        with self._lock:
            if not self._active:
                w = self.arbiter.lease(self.pred.name)
                if w is not None:
                    self._insert(w)

    def _on_worker_idle(self, w: WorkerContext) -> bool:
        """Scale-down handshake (called from the worker's own thread).

        True == retire: the lease is released and the calling thread must
        exit immediately. All bookkeeping happens under the router lock,
        so no batch can be routed to ``w`` concurrently with retirement —
        and a batch that raced into the queue before we took the lock
        vetoes it."""
        with self._lock:
            if not self.arbiter.scale_down_enabled:
                return False
            if w not in self._active or len(self._active) <= 1:
                return False  # never drop below the one-worker floor
            if w.pinned > 0:
                return False  # a submit is in flight toward this worker
            if len(w.queue) > 0:
                return False  # a batch raced in: keep serving
            if self._virtual_drain:
                # deterministic verdict: retire only when the worker's
                # virtual busy horizon lags the router's observed virtual
                # frontier by at least the drain threshold — i.e. it has
                # been idle that long in SIMULATED time, regardless of
                # wall-clock thread scheduling
                idle_v = self._sim_frontier \
                    - self.clock.resource_busy_until(w.wid)
                if idle_v < self._drain_threshold:
                    return False
            self._active.remove(w)
            w.activated = False     # re-leasable: activate() restarts
            w._thread = None
            self.arbiter.release(self.pred.name, w)
            self.retirements += 1
            return True

    def _maybe_scale_up(self, batch: RoutingBatch):
        """Lease one more slot under saturation; returns the new worker.

        WallClock: queue backpressure (all active input queues full).
        SimClock: deterministic — every active worker's virtual busy
        horizon is past the batch's virtual arrival, i.e. the batch would
        WAIT (the utilization proxy the paper reads from the device).

        The caller must ``activate()`` the returned worker (OUTSIDE this
        router's lock — activation may warm-compile a kernel): a scale-up
        lease is granted under live traffic, and only an activated worker
        has the idle timer that can retire it — a leased-but-threadless
        context would strand its slot if the stream dried up before a
        batch was routed to it."""
        with self._lock:
            active = self._active
            if not active or len(active) >= self.max_workers:
                return None
            if isinstance(self.clock, SimClock):
                saturated = all(
                    self.clock.resource_busy_until(w.wid) > batch.sim_ready
                    for w in active
                )
            else:
                saturated = all(
                    len(w.queue) >= w.queue.capacity for w in active
                )
            if not saturated:
                return None
            w = self.arbiter.lease(self.pred.name)
            if w is not None:
                self._insert(w)
            return w

    def submit(self, batch: RoutingBatch) -> bool:
        """Route a batch to a worker (blocking; scales up under saturation).

        Returns True once the batch is accepted by a worker queue; every
        failure path RAISES (ClosedError from a stopped worker's queue,
        RuntimeError on floor starvation) — there is no silent False, so
        a caller that ignores the return value still cannot lose a batch
        without an exception crossing it (the eddy shard decrements the
        in-flight tracker on that exception).

        Thread-safe for the N-shard eddy core: the router lock is held only
        for the choose/pin bookkeeping; the blocking queue put, worker
        activation, and proxy-load reduction all run outside it, and the
        blocking waits land on per-worker condition variables — concurrent
        shard submits to different workers never serialize on one CV."""
        # data-aware proxy load (§5.3), computed OUTSIDE the router lock:
        # it reduces over the batch's columns and must not serialize
        # against worker retirement callbacks
        load = self.pred.udf.proxy(
            {c: batch.data[c] for c in self.pred.udf.columns}
        ) if batch.rows else 0.0
        starved_since = None
        while True:
            self._ensure_floor()
            grown = self._maybe_scale_up(batch)
            if grown is not None:
                # outside the router lock: activation may warm-compile
                # (GACU ensure_ready) and must not serialize against
                # retirement callbacks. N routing shards may submit
                # concurrently; WorkerContext.activate is internally
                # locked, so racing activations start exactly one thread
                grown.activate()
            with self._lock:
                if self._virtual_drain and batch.sim_ready > self._sim_frontier:
                    self._sim_frontier = batch.sim_ready
                workers = list(self._active)
                if workers:
                    worker = self.policy.choose(workers, batch, self.stats)
                    # proactive load accounting; PIN the chosen worker
                    # under the lock so its lease cannot retire while the
                    # (possibly blocking) queue put below runs lock-free
                    self.stats.add_load(worker.wid, load)
                    worker.pinned += 1
                else:
                    worker = None  # floor lease denied: back off, retry
            if worker is None:
                now = time.monotonic()
                if starved_since is None:
                    starved_since = now
                elif now - starved_since > FLOOR_STARVATION_DEADLINE_S:
                    # e.g. a bounded shared pool fully held by rivals under
                    # a policy that never releases (StaticPartition): this
                    # predicate can never run, so the query can never
                    # finish — surface it instead of spinning silently
                    raise RuntimeError(
                        f"predicate {self.pred.name!r} starved: floor "
                        f"lease denied for {FLOOR_STARVATION_DEADLINE_S}s "
                        f"(device pool exhausted by other predicates and "
                        f"nothing scaled down); arbiter counters: "
                        f"{self.arbiter.counters()}"
                    )
                time.sleep(_FLOOR_RETRY_SLEEP_S)
                continue
            starved_since = None
            try:
                ok = worker.submit(batch, timeout=0.05)
            finally:
                with self._lock:
                    worker.pinned -= 1
            if ok:
                return True
            # queue full: undo accounting, scale, retry
            self.stats.finish_load(worker.wid, load)

    def queue_depth(self) -> int:
        return sum(len(w.queue) for w in self.workers)

    def stop(self) -> None:
        for w in self.workers:
            w.stop()
        self.arbiter.unregister(self.pred.name)
        with self._lock:
            # the arbiter released every slot above: reporting the old
            # active list would fabricate leases that no longer exist
            self._active = []
