"""Predicate workers (§3.2 step 5, §5.1 GACU, §5.2 elastic leases).

A WorkerContext is pre-created greedily but allocates nothing until the
first batch is routed to it ("spawning through routing"). Evaluation:
cache probe -> compute only misses (bucketed) -> mask -> eager
materialization -> reinsert into the central queue. Timing goes through the
Clock abstraction so the identical code path runs wall-clock (production)
or simulated (deterministic scheduling benchmarks).

MICRO-BATCH COALESCING (§5.1 utilization): when the context holds a
``CoalescePlanner`` (core/coalesce.py), a dequeue may drain additional
queued batches — non-blocking first, then waiting up to the plan's latency
budget — and evaluate them as ONE fused launch through the identical
cache-probe -> bucketed-launch -> mask pipeline (``evaluate_fused``).  The
fused mask is split back at the recorded segment boundaries
(``batch.split_back``), so each output batch is bit-identical to what the
uncoalesced path would have produced: same bid, visited set, surviving
row multiset, circulation order, and one output per input batch (the
eddy in-flight tracker counts split outputs exactly like unfused ones).
Statistics credit tickets/wins per original segment but cost per fused
launch, and the per-launch (rows, seconds) sample feeds the fixed+marginal
decomposition the adaptive planner learns from.  The planner DECLINES to
fuse (plan() -> None) when it has no launch-overhead evidence or the
predicate is already amortized — then this module is byte-for-byte the
old single-batch loop.

Elastic lifecycle (§5.2): a worker holds a *lease* on a device slot (see
core/resources.py). When its input queue has been idle past
``idle_timeout`` seconds it offers to retire via ``on_idle``; if the
router accepts (scale-down), the thread exits and the slot returns to the
DevicePool for another predicate to claim. A retired context can be
re-leased later — ``activate()`` simply starts a fresh thread.

Per-executor launch attribution: each worker thread tags itself with its
executor's ``launch_token`` so kernel-launch timing hooks registered by
that executor (thread-affine, see kernels/launch.py) only observe its own
launches — concurrent executors in one process never cross-record.

FAILURE SEMANTICS (core/faults.py; executor knob ``on_fault``):

* ``fail_fast`` (default, and whenever no FaultConfig is supplied):
  ``evaluate_resilient`` delegates straight to ``evaluate_predicate`` —
  the pre-fault-tolerance path, byte-for-byte — and any evaluation
  exception aborts the query via ``on_error``.  The worker DOES decrement
  the in-flight tracker for every batch it drops on the error path, so an
  errored batch can never wedge the termination barrier.
* ``retry``: each failed attempt is recorded in the FaultLedger
  (error-rate EMA + consecutive count) and retried up to
  ``max_attempts`` with capped exponential backoff + seeded jitter —
  under SimClock the delay advances the batch's VIRTUAL ready time, never
  a wall sleep, so injected timelines stay bit-exact.  A batch that
  exhausts its attempts is a POISON BATCH: it completes with a
  conservative pass-through verdict (all rows kept, flagged in
  ``batch.passthrough``) so the row-id-multiset and termination
  invariants hold.  ``quarantine_after`` consecutive failures quarantine
  the PREDICATE: the eddy stops routing to it (skips are logged) and any
  batch already in its queue passes through.
* ``degrade``: retry semantics plus, after ``degrade_after`` consecutive
  failures, the UDF is switched to its reference path
  (``UDF.fallback_fn``) — injected ``compiled_only`` faults stop firing,
  modelling a bug in the compiled executable that the interpreter
  escapes.  No fallback -> falls through to quarantine.
* Corrupt outputs (wrong leading row count; wrong dtype vs the UDF's
  learned ``out_spec`` under injection) raise ``CorruptOutputError``
  BEFORE the result can enter the reuse cache, and count as failures.
* A FUSED (coalesced) launch that fails is un-fused: one ledger failure
  for the group attempt, then each constituent retries individually so a
  poison batch is isolated alone rather than poisoning its whole group.
"""
from __future__ import annotations

import threading
import time
import traceback
from dataclasses import dataclass, field, replace as _replace
from typing import Callable, List, Optional

import numpy as np

from repro_torch.core.batch import RoutingBatch, concat, split_back
from repro_torch.core.cache import ReuseCache
from repro_torch.core.coalesce import CoalescePlanner
from repro_torch.core.faults import (
    CorruptOutputError, FaultConfig, FaultLedger, FaultPlan, LaunchWatchdog,
    backoff_delay,
)
from repro_torch.core.queues import BoundedQueue, CentralQueue, ClosedError
from repro_torch.core.simclock import SimClock
from repro_torch.core.stats import StatsBoard
from repro_torch.core.udf import Predicate
from repro_torch.kernels import launch as kernel_launch


def _checked_outputs(pred, data, rows: int, faults, clock) -> np.ndarray:
    """One evaluation through the (optional) fault-injection seam, with
    output validation BEFORE the caller may cache the result.

    The leading-dimension check always runs (a wrong row count would
    corrupt the mask/filter contract silently); the dtype check against
    the UDF's learned ``out_spec`` runs only under injection, where a
    ``corrupt`` spec deliberately flips it — real UDFs are allowed dtype
    drift (the cache merge already promotes dtypes)."""
    if faults is None:
        outputs = pred.evaluate_outputs(data)
    else:
        outputs = faults.invoke(pred, data, clock)
    out = np.asarray(outputs)
    if out.ndim == 0 or out.shape[0] != rows:
        raise CorruptOutputError(
            f"{pred.name}: expected {rows} output rows, got shape {out.shape}"
        )
    if faults is not None:
        spec = getattr(pred.udf, "out_spec", None)
        if spec is not None and out.dtype != spec[0]:
            raise CorruptOutputError(
                f"{pred.name}: output dtype {out.dtype} != learned {spec[0]}"
            )
    return out


def _evaluate_with_cache(pred, batch, data, *, cache, stats, faults=None,
                         clock=None):
    """Cache probe -> compute misses -> vectorized hit/miss merge.

    Returns ``(outputs, wall_seconds, computed_rows, compute_data)`` where
    ``computed_rows`` is how many rows actually launched (0 on a full
    cache hit) and ``compute_data`` the column dict that was computed
    (None when nothing was) — the compute-only proxy load, so the
    proxy->seconds rate is never fed a full batch's load against a
    near-zero cached wall time.  Output validation (``_checked_outputs``)
    precedes every ``cache.put_batch``, so a corrupt result can never
    poison the reuse cache."""
    rows = batch.rows
    if cache is not None and pred.cacheable:
        # batch-aware probe: a layered cache digests the row payloads so
        # content-identical rows hit even under fresh row ids; the id-keyed
        # base cache ignores the payload argument
        hits, vals = cache.probe_batch(pred.udf.name, batch.row_ids, data)
        stats[pred.name].record_cache(rows, int(hits.sum()))
        if hits.any():
            miss = ~hits
            computed_rows = int(miss.sum())
            hit_vals = np.stack(
                [np.asarray(vals[i]) for i in np.nonzero(hits)[0]]
            )
            if computed_rows:
                sub = {c: v[miss] for c, v in data.items()}
                t0 = time.perf_counter()
                sub_out = _checked_outputs(pred, sub, computed_rows,
                                           faults, clock)
                wall = time.perf_counter() - t0
                cache.put_batch(pred.udf.name, batch.row_ids[miss], sub,
                                sub_out)
                # fancy-index scatter instead of the old per-index Python
                # loop + full-batch np.stack; dtype promotion matches what
                # stacking mixed hit/computed values used to produce
                outputs = np.empty(
                    (rows,) + sub_out.shape[1:],
                    np.promote_types(sub_out.dtype, hit_vals.dtype),
                )
                outputs[miss] = sub_out
                outputs[hits] = hit_vals
                return outputs, wall, computed_rows, sub
            outputs = np.empty((rows,) + hit_vals.shape[1:], hit_vals.dtype)
            outputs[hits] = hit_vals
            return outputs, 0.0, 0, None
        t0 = time.perf_counter()
        outputs = _checked_outputs(pred, data, rows, faults, clock)
        wall = time.perf_counter() - t0
        cache.put_batch(pred.udf.name, batch.row_ids, data, outputs)
        return outputs, wall, rows, data
    t0 = time.perf_counter()
    outputs = _checked_outputs(pred, data, rows, faults, clock)
    wall = time.perf_counter() - t0
    return outputs, wall, rows, data


def _sim_cost(pred, computed_rows: int, data, wall: float) -> float:
    if pred.udf.cost_model is None:
        return wall
    try:
        # data-aware cost models see the batch columns (UC4: LLM
        # cost proportional to text length, not just row count)
        return pred.udf.cost_model(computed_rows, data)
    except TypeError:
        return pred.udf.cost_model(computed_rows)


def evaluate_predicate(
    pred: Predicate,
    batch: RoutingBatch,
    *,
    stats: StatsBoard,
    cache: Optional[ReuseCache],
    clock,
    worker_id: str,
    device_group: str,
    serial_fraction: float = 0.0,
    faults: Optional[FaultPlan] = None,
) -> RoutingBatch:
    """Evaluate one predicate on one batch; returns the filtered batch."""
    rows = batch.rows
    if rows == 0:
        return batch.mark_visited(pred.name)

    data = {c: batch.data[c] for c in pred.udf.columns}
    outputs, wall, computed_rows, compute_data = _evaluate_with_cache(
        pred, batch, data, cache=cache, stats=stats, faults=faults,
        clock=clock,
    )

    finish = None
    if isinstance(clock, SimClock):
        cost = _sim_cost(pred, computed_rows, data, wall)
        if faults is not None:
            # injected hang under SimClock: extra VIRTUAL occupancy
            cost += faults.take_extra_cost()
        finish = clock.occupy_shared(
            worker_id, device_group, cost, serial_fraction, ready=batch.sim_ready
        )
        seconds = cost
    else:
        seconds = wall

    mask = pred.mask_from_outputs(outputs)
    out_batch = batch.filter(mask).mark_visited(pred.name)
    if finish is not None:
        out_batch = _replace(out_batch, sim_ready=finish)
    stats[pred.name].record_eval(
        rows, out_batch.rows, seconds, bucket=stats.bucket_of(batch),
        computed_rows=computed_rows,
    )
    # proxy->seconds rate: compute-only load over compute-only time. The
    # old call fed the FULL batch's proxy load even when most rows were
    # cache hits and wall ~= 0, corrupting the rate (and risking
    # div-by-near-zero on full hits) — full-hit evaluations are skipped.
    if computed_rows and compute_data is not None:
        stats.note_proxy_rate(pred.udf.proxy(compute_data), seconds)
    return out_batch


def evaluate_fused(
    pred: Predicate,
    batches: List[RoutingBatch],
    *,
    stats: StatsBoard,
    cache: Optional[ReuseCache],
    clock,
    worker_id: str,
    device_group: str,
    serial_fraction: float = 0.0,
    faults: Optional[FaultPlan] = None,
) -> List[RoutingBatch]:
    """Evaluate ``batches`` as ONE fused launch; returns per-bid outputs.

    The fused batch goes through the identical cache-probe ->
    bucketed-launch -> mask pipeline as a single batch, then the mask is
    split at the segment boundaries so every output is bit-identical to
    individual evaluation (see the coalescing contract in core/batch.py).
    Under SimClock the fused occupancy is ONE launch: cost_model(total
    computed rows) = one fixed launch term + summed per-row terms, started
    at the LAST constituent's virtual arrival; every split output inherits
    the single fused finish as its ``sim_ready``."""
    assert batches and all(b.rows > 0 for b in batches)
    fused, segments = concat(batches)
    data = {c: fused.data[c] for c in pred.udf.columns}
    outputs, wall, computed_rows, compute_data = _evaluate_with_cache(
        pred, fused, data, cache=cache, stats=stats, faults=faults,
        clock=clock,
    )

    finish = None
    if isinstance(clock, SimClock):
        cost = _sim_cost(pred, computed_rows, data, wall)
        if faults is not None:
            cost += faults.take_extra_cost()
        finish = clock.occupy_shared(
            worker_id, device_group, cost, serial_fraction, ready=fused.sim_ready
        )
        seconds = cost
    else:
        seconds = wall

    mask = pred.mask_from_outputs(outputs)
    outs = split_back(segments, mask, visit=pred.name, sim_ready=finish)
    stats[pred.name].record_fused_eval(
        [
            (b.rows, o.rows, stats.bucket_of(b))
            for b, o in zip(batches, outs)
        ],
        seconds,
        computed_rows=computed_rows,
    )
    if computed_rows and compute_data is not None:
        stats.note_proxy_rate(pred.udf.proxy(compute_data), seconds)
    return outs


def passthrough_batch(batch: RoutingBatch, pred_name: str) -> RoutingBatch:
    """Complete ``batch`` with a conservative quarantine verdict: every
    row PASSES (no row is dropped on faulty evidence) and the predicate is
    flagged in ``batch.passthrough`` for downstream auditing.  The batch
    completes like any other, so the in-flight termination barrier and the
    row-id-multiset invariant hold unchanged."""
    return batch.mark_passthrough(pred_name)


def evaluate_resilient(
    pred: Predicate,
    batch: RoutingBatch,
    *,
    stats: StatsBoard,
    cache: Optional[ReuseCache],
    clock,
    worker_id: str,
    device_group: str,
    serial_fraction: float = 0.0,
    faults: Optional[FaultPlan] = None,
    ledger: Optional[FaultLedger] = None,
    config: Optional[FaultConfig] = None,
    watchdog: Optional[LaunchWatchdog] = None,
) -> RoutingBatch:
    """Fault-policy wrapper around ``evaluate_predicate`` implementing the
    retry / degrade / quarantine contract (module docstring).

    With no ``config``/``ledger`` (``on_fault="fail_fast"``) this is a
    direct delegation — the pre-fault-tolerance path, byte-for-byte."""
    if config is None or ledger is None:
        return evaluate_predicate(
            pred, batch, stats=stats, cache=cache, clock=clock,
            worker_id=worker_id, device_group=device_group,
            serial_fraction=serial_fraction, faults=faults,
        )
    if batch.rows == 0:
        return batch.mark_visited(pred.name)
    if ledger.is_quarantined(pred.name):
        if not ledger.begin_probe(pred.name):
            # raced into the worker queue after quarantine tripped: same
            # conservative verdict the routing-level skip would have applied
            ledger.note_quarantined_batch(pred.name, batch.rows)
            return passthrough_batch(batch, pred.name)
        # recovery probe (FaultConfig.probe_after_skips): the eddy routed
        # this ONE batch at the quarantined predicate deliberately — a
        # single attempt, no retries.  Success lifts the quarantine and
        # normal routing resumes; failure passes the batch through and
        # re-arms the skip window.
        try:
            out = evaluate_predicate(
                pred, batch, stats=stats, cache=cache, clock=clock,
                worker_id=worker_id, device_group=device_group,
                serial_fraction=serial_fraction, faults=faults,
            )
        except ClosedError:
            raise
        except Exception as e:
            ledger.note_failure(pred.name, error=e)
            ledger.end_probe(pred.name, success=False)
            ledger.note_quarantined_batch(pred.name, batch.rows)
            return passthrough_batch(batch, pred.name)
        ledger.note_success(pred.name)
        ledger.end_probe(pred.name, success=True)
        return out
    simulated = getattr(clock, "simulated", False)
    attempt = 0
    while True:
        attempt += 1
        token = watchdog.begin(pred.name) if watchdog is not None else None
        t0 = time.perf_counter()
        try:
            out = evaluate_predicate(
                pred, batch, stats=stats, cache=cache, clock=clock,
                worker_id=worker_id, device_group=device_group,
                serial_fraction=serial_fraction, faults=faults,
            )
        except ClosedError:
            raise  # shutdown in progress, not an evaluation fault
        except Exception as e:
            consecutive = ledger.note_failure(pred.name, error=e)
            if (config.mode == "degrade"
                    and consecutive >= config.degrade_after
                    and not pred.udf.degraded and pred.udf.degrade()):
                ledger.note_degraded(pred.name)
            if consecutive >= config.quarantine_after:
                ledger.set_quarantined(pred.name)
            if ledger.is_quarantined(pred.name) \
                    or attempt >= config.max_attempts:
                # poison batch: conservative pass-through completion
                ledger.note_quarantined_batch(pred.name, batch.rows)
                return passthrough_batch(batch, pred.name)
            ledger.note_retry(pred.name)
            delay = backoff_delay(config, attempt,
                                  ledger.jitter_rng(pred.name))
            if simulated:
                # virtual backoff: the retry cannot start before the
                # delay elapses in SIMULATED time — never a wall sleep
                batch = _replace(batch, sim_ready=batch.sim_ready + delay)
            elif delay > 0.0:
                clock.sleep(delay)
            continue
        finally:
            if token is not None:
                watchdog.end(token)
        ledger.note_success(pred.name)
        if config.launch_deadline_s is not None:
            # post-hoc deadline accounting: virtual turnaround under
            # SimClock (the watchdog thread never runs there), wall
            # elapsed otherwise (the live watchdog additionally flags
            # launches still in flight past the deadline)
            elapsed = (out.sim_ready - batch.sim_ready if simulated
                       else time.perf_counter() - t0)
            if elapsed > config.launch_deadline_s:
                ledger.note_deadline(pred.name)
        return out


@dataclass
class WorkerContext:
    """GACU worker: greedy allocation, conservative (lazy) use.

    ``index`` is the context's position in its predicate's greedy
    allocation (stable activation order); ``idle_timeout``/``on_idle``
    implement the §5.2 scale-down handshake; ``launch_token`` tags the
    worker thread for per-executor kernel-launch attribution; ``coalesce``
    (a per-predicate CoalescePlanner shared across the predicate's
    workers) enables micro-batch fusing on the dequeue path."""

    wid: str
    pred: Predicate
    central: CentralQueue
    stats: StatsBoard
    cache: Optional[ReuseCache]
    clock: object
    device_group: str = "cpu"
    serial_fraction: float = 0.0
    queue: BoundedQueue = field(default_factory=lambda: BoundedQueue(2))
    activated: bool = False
    batches_done: int = 0
    _thread: Optional[threading.Thread] = None
    on_error: Optional[object] = None
    index: int = 0
    idle_timeout: Optional[float] = None
    on_idle: Optional[Callable[["WorkerContext"], bool]] = None
    launch_token: Optional[object] = None
    coalesce: Optional[CoalescePlanner] = None
    # fault tolerance (core/faults.py): the injection plan (tests/chaos
    # bench), the shared per-predicate ledger, the retry policy (None ==
    # fail_fast), the wall-clock launch watchdog, and the executor's
    # in-flight tracker — decremented for every batch dropped on an error
    # path so the termination barrier cannot leak
    fault_plan: Optional[FaultPlan] = None
    ledger: Optional[FaultLedger] = None
    fault_config: Optional[FaultConfig] = None
    watchdog: Optional[LaunchWatchdog] = None
    tracker: Optional[object] = None
    # submits in flight (set under the router lock): a pinned worker must
    # not retire, or the in-flight batch would land in a dead queue
    pinned: int = 0
    # guards the activated check-and-set: with N routing shards, two
    # shards can choose the same worker concurrently and both reach
    # activate() — without the lock they would race the flag and start
    # two threads for one context
    _activate_lock: threading.Lock = field(default_factory=threading.Lock)

    def activate(self) -> None:
        """Called by the Laminar router when the first batch is routed here.

        Re-entrant across retirement: a context whose lease was retired
        (thread exited, ``activated`` reset by the router) starts a fresh
        thread on the next routed batch. Safe to race from multiple
        routing shards: exactly one caller starts the thread."""
        with self._activate_lock:
            if self.activated:
                return
            self.activated = True
            self.pred.udf.ensure_ready()  # lazy context allocation (GACU)
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name=f"worker-{self.wid}")
            self._thread.start()

    def submit(self, batch: RoutingBatch, timeout: Optional[float] = None) -> bool:
        self.activate()
        return self.queue.put(batch, timeout)

    # ------------------------- coalescing ------------------------- #
    def _drain_coalesce(self, first: RoutingBatch) -> List[RoutingBatch]:
        """Collect the fuse group for this dequeue: ``[first]`` plus up to
        ``plan.max_batches - 1`` more queued batches, draining
        non-blocking first and then waiting out the latency budget while
        still short of ``plan.target_rows``.  A closed queue ends the
        drain — whatever is in hand still gets evaluated."""
        planner = self.coalesce
        if planner is None:
            return [first]
        plan = planner.plan(first.rows)
        if plan is None:
            return [first]
        batches, rows = [first], first.rows
        deadline = None
        while rows < plan.target_rows and len(batches) < plan.max_batches:
            got = self.queue.get_many(plan.max_batches - len(batches))
            if got:
                batches.extend(got)
                rows += sum(b.rows for b in got)
                continue
            if plan.max_wait_s <= 0:
                break
            now = time.monotonic()
            if deadline is None:
                deadline = now + plan.max_wait_s
            remaining = deadline - now
            if remaining <= 0:
                break
            try:
                batches.append(self.queue.get(timeout=remaining))
                rows += batches[-1].rows
            except (TimeoutError, ClosedError):
                break
        planner.note_fused(len(batches))
        return batches

    def _evaluate_group(self, batches: List[RoutingBatch]) -> List[RoutingBatch]:
        """Evaluate a fuse group, preserving per-batch output order.

        Zero-row batches never launch anything and take the single-batch
        path (mark-visited only); the non-empty remainder fuses into one
        launch when there are at least two."""
        fusable = [b for b in batches if b.rows > 0]
        if len(fusable) < 2 or (
            # quarantined: per-batch path so the pass-through / recovery-
            # probe bookkeeping in evaluate_resilient sees every batch
            self.ledger is not None
            and self.ledger.is_quarantined(self.pred.name)
        ):
            return [self._evaluate_one(b) for b in batches]
        try:
            fused_outs = iter(evaluate_fused(
                self.pred, fusable,
                stats=self.stats, cache=self.cache, clock=self.clock,
                worker_id=self.wid, device_group=self.device_group,
                serial_fraction=self.serial_fraction,
                faults=self.fault_plan,
            ))
        except ClosedError:
            raise
        except Exception as e:
            if self.fault_config is None or self.ledger is None:
                raise  # fail_fast: the pre-fault-tolerance abort path
            # fused-launch failure: one ledger failure for the group
            # attempt, then UN-FUSE — each batch retries individually so
            # a poison batch is quarantined alone, not its whole group
            self.ledger.note_failure(self.pred.name, error=e)
            return [self._evaluate_one(b) for b in batches]
        return [
            next(fused_outs) if b.rows > 0 else b.mark_visited(self.pred.name)
            for b in batches
        ]

    def _evaluate_one(self, b: RoutingBatch) -> RoutingBatch:
        return evaluate_resilient(
            self.pred, b,
            stats=self.stats, cache=self.cache, clock=self.clock,
            worker_id=self.wid, device_group=self.device_group,
            serial_fraction=self.serial_fraction,
            faults=self.fault_plan, ledger=self.ledger,
            config=self.fault_config, watchdog=self.watchdog,
        )

    def _run(self) -> None:
        if self.launch_token is not None:
            # thread-affine launch attribution: kernel timing hooks keyed
            # by this executor's token observe this thread's launches only
            kernel_launch.set_launch_context(self.launch_token)
        while True:
            try:
                batch = self.queue.get(timeout=self.idle_timeout)
            except TimeoutError:
                # queue idle past the drain threshold: offer to retire.
                # The router decides under its own lock (floor of one
                # worker, queue still empty, policy allows scale-down) and
                # performs all bookkeeping before we return — after a True
                # verdict this thread must touch nothing and exit.
                if self.on_idle is not None and self.on_idle(self):
                    return
                continue
            except ClosedError:
                return
            batches = [batch]
            reinserted = 0
            try:
                batches = self._drain_coalesce(batch)
                outs = self._evaluate_group(batches)
                for b, out in zip(batches, outs):
                    load = self.pred.udf.proxy(
                        {c: b.data[c] for c in self.pred.udf.columns}
                    ) if b.rows else 0.0
                    self.stats.finish_load(self.wid, load)
                    self.batches_done += 1
                    self.central.put_worker(out)
                    reinserted += 1
            except ClosedError:
                self._untrack(len(batches) - reinserted)
                return
            except Exception as e:  # propagate to the executor
                self._untrack(len(batches) - reinserted)
                if self.on_error is not None:
                    self.on_error(e, traceback.format_exc())
                return

    def _untrack(self, dropped: int) -> None:
        """Decrement the in-flight tracker for batches this worker dropped
        on an error/shutdown path (they will never complete): without
        this, an errored batch leaks the termination barrier and sibling
        shards poll until their timeout instead of exiting."""
        if self.tracker is None:
            return
        for _ in range(dropped):
            self.tracker.finished()

    def stop(self) -> None:
        self.queue.close()
