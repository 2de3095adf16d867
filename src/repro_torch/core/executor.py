"""AQPExecutor — wires EddyPull + EddyShardSet + Laminar routers + workers
into the executor of Fig. 2 and exposes the parent-executor pull interface
(a blocking iterator over the output queue).

Sharded routing core: the eddy loop runs as N shards over a lock-sharded
central queue with consumer-side work-stealing and merged statistics (see
core/eddy.py). Knobs:

  ``shards=None`` (default) — ONE shard, auto-scaling to ``SHARD_AUTO_MAX``
      once observed routing throughput crosses ``shard_auto_threshold``
      batches/s (the regime where routing, not UDF eval, is the ceiling).
      Under SimClock auto-scaling is disabled: the deterministic paths
      always run single-shard, bit-for-bit as before.
  ``shards=k`` — exactly k shards from the start (wall or sim clock).
  ``shard_auto_threshold`` — batches/s above which auto mode grows.

Resource arbitration (§5.2): the executor creates a ResourceArbiter (or
accepts a shared one) that owns every predicate's worker contexts and
leases device slots to the Laminar routers — scale-up keeps the queue
backpressure trigger, scale-down retires idle leases so capacity flows to
the current bottleneck predicate. Reallocation counters are exposed in
``stats_snapshot()`` under the reserved ``"_arbiter"`` key.

Micro-batch coalescing (§5.1): ``coalesce="adaptive" | "fixed" | k | off``
lets workers fuse queued same-predicate batches into one kernel launch,
amortizing per-launch overhead (see core/coalesce.py and
core/worker.evaluate_fused). Off by default — the deterministic SimClock
suites rely on one-launch-per-batch occupancy. Planner counters surface
in ``stats_snapshot()`` under the reserved ``"_coalesce"`` key.

Kernel cost visibility (§3.3): for the lifetime of a ``run()`` the executor
registers ``launch.connect_stats_board(self.stats, token=...)``, so every
Pallas launch a predicate makes reports its per-launch timing into the same
StatsBoard the routing policies rank on — kernel UDF cost is profiled, not
estimated, exactly like predicate-level cost. The hook is THREAD-AFFINE:
it is keyed by this executor's launch token, and every thread this executor
owns (eddy pull, eddy router, predicate workers) tags itself with that
token — so concurrent executors in one process each record only their own
launches (per-executor attribution; the old process-global bus
cross-recorded). The hook is removed in ``shutdown()`` so back-to-back
executors never double-count either.

FAILURE-SEMANTICS CONTRACT (``on_fault=``, core/faults.py):

* ``"fail_fast"`` (default): today's behavior bit-exact — the first
  worker exception aborts the query (``run()`` raises RuntimeError with
  the worker traceback); pull/shard errors raise as themselves.  Even on
  this path teardown is guaranteed: an errored batch decrements the
  in-flight tracker (no wedged termination barrier), a failed shard
  closes both queues so every blocked thread wakes immediately, and
  ``run()``'s finally / the context-manager ``__exit__`` route through
  ``shutdown()`` — launch hooks deregister and ``StatsStore.record_board``
  is still attempted.
* ``"retry"`` (or a ``FaultConfig``): per-batch retry with capped
  exponential backoff + seeded jitter (virtual delays under SimClock); a
  batch exhausting ``max_attempts`` completes as a conservative
  pass-through (rows kept, predicate flagged in ``batch.passthrough``);
  ``quarantine_after`` consecutive failures quarantine the predicate —
  the eddy skips it (logged) and routing ranks penalize flaky predicates
  by their error-rate EMA.
* ``"degrade"``: retry semantics plus automatic switch of a repeatedly-
  failing UDF to its reference path (``UDF.fallback_fn``) after
  ``degrade_after`` consecutive failures.
* ``fault_plan=`` injects deterministic faults (tests / bench_chaos);
  ``stats_snapshot()["_faults"]`` exposes the per-predicate ledger
  (failures, retries, error-rate EMA, quarantine/degraded state,
  pass-through counts, deadline hits, skipped routes — see
  ``FaultLedger.snapshot`` for the key contract).
* ``launch_deadline_s`` (FaultConfig): hung-launch detection — a
  wall-clock ``LaunchWatchdog`` thread flags in-flight launches past the
  deadline (it cannot preempt them; it makes routing see the hang), and
  under SimClock the deadline is checked post-hoc from virtual
  turnaround so deterministic timelines stay exact.
"""
from __future__ import annotations

import threading
from typing import Dict, Iterable, Iterator, List, Optional, Sequence

from repro_torch.core.batch import RoutingBatch
from repro_torch.core.cache import ReuseCache
from repro_torch.core.coalesce import COALESCE_QUEUE_CAPACITY, CoalesceConfig
from repro_torch.core.eddy import (
    SHARD_AUTO_MAX, SHARD_AUTO_THRESHOLD_BPS, EddyPull, EddyShardSet,
    InFlightTracker,
)
from repro_torch.core.faults import (
    FaultConfig, FaultLedger, LaunchWatchdog, ReverifyQueue,
)
from repro_torch.core.laminar import GACU_MAX_WORKERS, LaminarRouter
from repro_torch.core.policies import (
    ArbiterPolicy, EddyPolicy, HydroPolicy, LaminarPolicy, RoundRobin,
)
from repro_torch.core.queues import CentralQueue, ClosedError
from repro_torch.core.resources import DRAIN_THRESHOLD_S, DevicePool, ResourceArbiter
from repro_torch.core.simclock import WallClock
from repro_torch.core.stats import StatsBoard
from repro_torch.core.statstore import StatsStore
from repro_torch.core.udf import Predicate
from repro_torch.kernels import launch as kernel_launch


class AQPExecutor:
    def __init__(
        self,
        predicates: List[Predicate],
        *,
        policy: Optional[EddyPolicy] = None,
        laminar_policy_factory=RoundRobin,
        clock=None,
        cache: Optional[ReuseCache] = None,
        central_capacity: int = 64,
        lam: float = 0.3,
        max_workers: int = GACU_MAX_WORKERS,
        devices: Optional[Dict[str, Sequence[str]]] = None,  # pred -> device groups
        serial_fraction: float = 0.0,
        warmup: bool = True,
        output_capacity: int = 1024,
        cost_alpha: float = 0.3,
        arbiter: Optional[ResourceArbiter] = None,
        pool: Optional[DevicePool] = None,
        arbiter_policy: Optional[ArbiterPolicy] = None,
        drain_threshold: Optional[float] = DRAIN_THRESHOLD_S,
        shards: Optional[int] = None,
        shard_auto_threshold: float = SHARD_AUTO_THRESHOLD_BPS,
        stats_store: Optional[StatsStore] = None,
        coalesce=None,
        worker_queue_capacity: Optional[int] = None,
        on_fault="fail_fast",
        fault_plan=None,
        query: Optional[str] = None,
        reverify: bool = False,
        virtual_drain: bool = False,
    ):
        self.predicates = predicates
        self.policy = policy or HydroPolicy()
        self.clock = clock or WallClock()
        self.cache = cache
        # Shard-count resolution: explicit ``shards=k`` wins; the default
        # is one shard that AUTO-scales to SHARD_AUTO_MAX above the
        # throughput threshold — except under SimClock, where the
        # deterministic timelines require the single-shard loop.
        if shards is not None and shards < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        deterministic = getattr(self.clock, "simulated", False)
        self._shard_auto = shards is None and not deterministic
        self._initial_shards = 1 if shards is None else shards
        self._max_shards = (
            SHARD_AUTO_MAX if self._shard_auto else self._initial_shards
        )
        self._shard_auto_threshold = shard_auto_threshold
        self.stats = StatsBoard(
            [p.name for p in predicates], cost_alpha=cost_alpha,
            shards=self._max_shards,
        )
        # Cross-query statistics (core/statstore.py): warm-start this
        # run's board from profiled, age-decayed records — a fully seeded
        # board skips the warmup circulation — and record the board back
        # (seed-only entries excluded) when the executor shuts down.
        self.stats_store = stats_store
        self._stats_seeded = (
            stats_store.warm_start(self.stats, predicates)
            if stats_store is not None else {}
        )
        self._stats_recorded = False
        self.central = CentralQueue(central_capacity, lam,
                                    shards=self._max_shards)
        self.output = CentralQueue(output_capacity, lam=1.0,
                                   shards=self._max_shards)
        self._error_lock = threading.Lock()
        self._worker_error = None
        # Fault tolerance (core/faults.py; module docstring contract):
        # fail_fast resolves to config None — workers take the
        # pre-fault-tolerance path byte-for-byte, and the ledger stays
        # clean (rank penalty exactly 1.0). The injection plan applies
        # regardless of mode (fail_fast + plan == "assert today's abort").
        self.fault_config = FaultConfig.resolve(on_fault)
        self.fault_plan = fault_plan
        self.faults = FaultLedger(
            [p.name for p in predicates],
            seed=self.fault_config.seed if self.fault_config else 0,
            probe_after_skips=(
                self.fault_config.probe_after_skips
                if self.fault_config else None
            ),
        )
        self.stats.faults = self.faults
        # Multi-tenancy (launch/serve.py): the query identity tags this
        # executor's registrations in a shared arbiter; service_info is
        # filled in by a managing QueryService and surfaced under the
        # stats_snapshot() "_service" key.
        self.query = query
        self.service_info: Optional[Dict[str, object]] = None
        # Re-verification queue (core/faults.py): with reverify=True the
        # run loop holds pass-through-flagged output batches and drains
        # them back through each flagged predicate once it recovers;
        # unrecovered flags release as-is at end of run.
        self.reverify_queue = (
            ReverifyQueue(predicates, self.faults,
                          fault_plan=self.fault_plan, clock=self.clock)
            if reverify else None
        )
        self._watchdog = None
        if (self.fault_config is not None
                and self.fault_config.launch_deadline_s is not None
                and not deterministic):
            # wall clock only: under SimClock deadline detection is
            # post-hoc from virtual turnaround (evaluate_resilient)
            self._watchdog = LaunchWatchdog(
                self.fault_config.launch_deadline_s,
                on_deadline=lambda name, elapsed:
                    self.faults.note_deadline(name),
            )
        # ONE tracker for the executor's lifetime: worker contexts hold a
        # reference (to decrement for batches dropped on error paths), so
        # run() must not swap in a fresh instance. Executors are
        # effectively one-shot (shutdown closes the queues), so there is
        # no carry-over between runs to worry about.
        self._tracker = InFlightTracker()
        # per-executor launch attribution token: every thread this executor
        # owns tags itself with it, and the run()-lifetime stats hook only
        # observes launches from so-tagged threads
        self._launch_token = object()
        # shared arbiter > shared pool > private unbounded pool (the
        # private default reproduces the pre-arbiter per-predicate pools)
        if arbiter is not None and (pool is not None or arbiter_policy is not None):
            raise ValueError(
                "pass either a pre-built arbiter OR pool/arbiter_policy "
                "(a shared arbiter keeps its own pool and policy)"
            )
        self.arbiter = arbiter or ResourceArbiter(
            pool=pool, policy=arbiter_policy
        )
        # Micro-batch coalescing knob (core/coalesce.py): off (default) |
        # "fixed"/int k | "adaptive". OFF is load-bearing for the
        # deterministic SimClock suites — their timelines are pinned to
        # one-launch-per-batch occupancy. When on, worker queues deepen to
        # COALESCE_QUEUE_CAPACITY by default so there is something to fuse
        # (an explicit worker_queue_capacity always wins).
        self.coalesce_config = CoalesceConfig.resolve(coalesce)
        if worker_queue_capacity is None:
            worker_queue_capacity = (
                COALESCE_QUEUE_CAPACITY if self.coalesce_config is not None
                else 2
            )
        pred_devices = {
            p.name: tuple((devices or {}).get(p.name, (p.resource,)))
            for p in predicates
        }
        self._check_pool_floors(pred_devices)
        self.laminars: Dict[str, LaminarRouter] = {}
        try:
            for p in predicates:
                self.laminars[p.name] = LaminarRouter(
                    p,
                    self.central,
                    self.stats,
                    cache=cache,
                    clock=self.clock,
                    policy=laminar_policy_factory(),
                    max_workers=max_workers,
                    devices=pred_devices[p.name],
                    serial_fraction=serial_fraction,
                    on_error=self._on_worker_error,
                    arbiter=self.arbiter,
                    drain_threshold=drain_threshold,
                    virtual_drain=virtual_drain,
                    query=query,
                    launch_token=self._launch_token,
                    coalesce=self.coalesce_config,
                    worker_queue_capacity=worker_queue_capacity,
                    fault_plan=self.fault_plan,
                    fault_ledger=self.faults,
                    fault_config=self.fault_config,
                    watchdog=self._watchdog,
                    tracker=self._tracker,
                )
        except BaseException:
            # don't poison a shared arbiter with half a registration: the
            # names registered before the failure must become reusable
            for name in self.laminars:
                self.arbiter.unregister(name)
            raise
        self.warmup = warmup
        self._pull: Optional[EddyPull] = None
        self._router: Optional[EddyShardSet] = None
        self._kernel_hook = None  # launch-timing hook, live only during run()

    # ------------------------------------------------------------------ #
    def _check_pool_floors(self, pred_devices: Dict[str, Sequence[str]]) -> None:
        """Fail fast on a pool that can never hold one floor slot per
        predicate: floor leases never retire, so an undersized BOUNDED
        pool is a guaranteed mid-query starvation, not a transient."""
        cap = self.arbiter.pool.capacity_of
        groups = {g for ds in pred_devices.values() for g in ds}
        if any(cap(g) is None for g in groups):
            return  # an unbounded group can absorb any floor demand
        total = sum(cap(g) for g in groups)
        if total < len(pred_devices):
            raise ValueError(
                f"DevicePool holds {total} slot(s) across {sorted(groups)} "
                f"but {len(pred_devices)} predicates each need a one-worker "
                "floor: the query would starve — size the pool to at least "
                "one slot per predicate"
            )
        for g in groups:  # predicates pinned to a single group
            pinned = [n for n, ds in pred_devices.items() if set(ds) == {g}]
            if len(pinned) > cap(g):
                raise ValueError(
                    f"device group {g!r} has {cap(g)} slot(s) but "
                    f"{len(pinned)} predicates ({sorted(pinned)}) can only "
                    "run there: the query would starve"
                )

    def _on_worker_error(self, exc, tb):
        with self._error_lock:
            if self._worker_error is None:
                self._worker_error = (exc, tb)
        self.output.close()
        self.central.close()

    def run(self, source: Iterable[RoutingBatch]) -> Iterator[RoutingBatch]:
        """Execute; yields completed (non-empty) batches in completion order."""
        if self._kernel_hook is None:
            # Per-launch kernel timings feed the routing StatsBoard for the
            # duration of the run — thread-affine on this executor's token,
            # so a concurrently-running executor never cross-records.
            # shutdown() deregisters.
            self._kernel_hook = kernel_launch.connect_stats_board(
                self.stats, token=self._launch_token
            )
        if self._watchdog is not None:
            self._watchdog.start()
        tracker = self._tracker
        self._pull = EddyPull(source, self.central,
                              launch_token=self._launch_token,
                              tracker=tracker)
        self._router = EddyShardSet(
            self.predicates, self.central, self.output, self.laminars,
            self.stats, self.policy, self._pull,
            cache=self.cache, warmup=self.warmup,
            launch_token=self._launch_token,
            shards=self._initial_shards,
            max_shards=self._max_shards,
            auto_threshold=self._shard_auto_threshold,
            tracker=tracker,
            faults=self.faults,
        )
        self._pull.start()
        self._router.start()
        try:
            while True:
                try:
                    out = self.output.get(timeout=1.0)
                except TimeoutError:
                    if self._worker_error is not None:
                        break
                    continue
                except ClosedError:
                    break
                if self.reverify_queue is None:
                    yield out
                    continue
                # re-verification (core/faults.py): flagged batches are
                # held; recovered predicates' holds drain opportunistically
                out = self.reverify_queue.offer(out)
                if out is not None:
                    yield out
                if self.reverify_queue.pending():
                    for b in self.reverify_queue.drain():
                        yield b
            if self.reverify_queue is not None:
                # end of run: release still-held batches — re-verified
                # where the predicate recovered, still-flagged otherwise
                # (the pre-reverify conservative contract)
                for b in self.reverify_queue.drain(force=True):
                    yield b
        finally:
            self.shutdown()
        if self._worker_error is not None:
            exc, tb = self._worker_error
            raise RuntimeError(f"predicate worker failed:\n{tb}") from exc
        if self._pull.error is not None:
            raise self._pull.error
        if self._router.error is not None:
            raise self._router.error

    def collect(self, source: Iterable[RoutingBatch]) -> List[RoutingBatch]:
        return list(self.run(source))

    # ------------------------- context manager ------------------------- #
    # ``with AQPExecutor(...) as ex:`` guarantees teardown on EVERY exit
    # path — including a consumer that abandons the run() generator
    # mid-iteration, where the generator's own finally-clause only fires
    # at GC time. shutdown() is idempotent, so run()'s internal teardown
    # composing with __exit__ is harmless.
    def __enter__(self) -> "AQPExecutor":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.shutdown()

    def shutdown(self) -> None:
        if self._watchdog is not None:
            self._watchdog.stop()
        if self._kernel_hook is not None:
            kernel_launch.remove_launch_hook(self._kernel_hook)
            self._kernel_hook = None
        for lam in self.laminars.values():
            lam.stop()
        self.central.close()
        self.output.close()
        if self.stats_store is not None and not self._stats_recorded:
            self._stats_recorded = True
            try:
                self.stats_store.record_board(
                    self.stats, self.predicates, seeded=self._stats_seeded
                )
                self.stats_store.flush()
            except Exception as e:
                # persistence is best-effort at teardown: a full disk or
                # yanked mount must not mask the query's actual results
                import warnings

                warnings.warn(f"StatsStore persistence failed: {e!r}")

    # ------------------------------ metrics ---------------------------- #
    def stats_snapshot(self):
        """Predicate statistics plus arbiter and routing-core counters.

        Predicate entries are keyed by name as before; the reserved
        ``"_arbiter"`` key carries lease/release/denial/handoff counters,
        ``"_routing"`` the shard-set picture (active shards, steals,
        circulations, completed), and ``"_faults"`` the per-predicate
        fault ledger (see core/faults.FaultLedger.snapshot for the key
        contract). The reserved ``"_service"`` key carries the
        multi-tenant picture: ``{"managed": False}`` for a standalone
        executor, or the managing QueryService's per-query identity
        (query id, priority, deadline — see launch/serve.py) when this
        executor runs as a service tenant; with ``reverify=True`` it also
        carries the re-verification counters
        (``ReverifyQueue.snapshot``). Consumers iterating predicate
        entries should skip ``_``-keys."""
        snap = self.stats.snapshot()
        snap["_arbiter"] = self.arbiter.counters()
        snap["_faults"] = self.faults.snapshot()
        svc: Dict[str, object] = (
            dict(self.service_info) if self.service_info
            else {"managed": False}
        )
        if self.reverify_queue is not None:
            svc["reverify"] = self.reverify_queue.snapshot()
        snap["_service"] = svc
        r = self._router
        snap["_routing"] = {
            "shards_active": r.shards_active if r is not None else 0,
            "steals": r.steals if r is not None else 0,
            "circulations": r.circulations if r is not None else 0,
            "completed": r.completed if r is not None else 0,
        }
        if self.coalesce_config is not None:
            snap["_coalesce"] = {
                "mode": self.coalesce_config.mode,
                **{
                    name: lam.coalesce_planner.counters()
                    for name, lam in self.laminars.items()
                    if lam.coalesce_planner is not None
                },
            }
        return snap

    @property
    def shards_active(self) -> int:
        """Routing shards currently running (grows past 1 only when
        auto-scaling trips or ``shards=`` was explicit)."""
        return self._router.shards_active if self._router is not None else 0

    def active_worker_counts(self) -> Dict[str, int]:
        return {
            name: sum(1 for w in lam.workers if w.activated)
            for name, lam in self.laminars.items()
        }

    def leased_worker_counts(self) -> Dict[str, int]:
        """Current leases per predicate (the §5.2 allocation picture)."""
        return {
            name: len(lam.active_workers)
            for name, lam in self.laminars.items()
        }

    @property
    def makespan(self) -> float:
        """Simulated-clock makespan (SimClock only)."""
        return getattr(self.clock, "makespan", 0.0)


class QuerySession:
    """Restartable per-query session over a (possibly shared) arbiter.

    ``AQPExecutor`` is one-shot by design: ``shutdown()`` closes its
    queues, so a second ``run()`` on the same instance cannot work. A
    ``QuerySession`` is the restartable object the multi-tenant service
    holds instead: it captures the predicates and executor configuration
    once, and every ``run()`` builds a FRESH executor, streams its
    output, and GUARANTEES teardown (context-manager + finally) even if
    the consumer abandons the iterator or an evaluation fails — the
    arbiter registration is released, so the same predicate names are
    re-registerable for the next run and the shared DevicePool never
    leaks slots. The final ``stats_snapshot()`` of each run is kept in
    ``last_snapshot`` for telemetry."""

    def __init__(self, predicates: List[Predicate], **executor_kwargs):
        self.predicates = predicates
        self.executor_kwargs = executor_kwargs
        self.runs = 0
        self.executor: Optional[AQPExecutor] = None  # live during run()
        self.last_snapshot = None

    def run(self, source: Iterable[RoutingBatch]) -> Iterator[RoutingBatch]:
        """One full query execution on a fresh executor; restartable."""
        ex = AQPExecutor(self.predicates, **self.executor_kwargs)
        self.executor = ex
        self.runs += 1
        try:
            with ex:
                for b in ex.run(source):
                    yield b
        finally:
            self.last_snapshot = ex.stats_snapshot()
            self.executor = None

    def collect(self, source: Iterable[RoutingBatch]) -> List[RoutingBatch]:
        return list(self.run(source))
