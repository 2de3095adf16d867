"""Sharded eddy routing core (§3.2, §4.1): pull -> partition -> shard loop
-> steal -> merged stats.

EDDY PULL drains the child executor into the central queue, honoring the
lambda watermark (one blocking wait per batch; ``close()`` wakes it).

The routing core is an EDDY SHARD SET: N shards, each owning one stripe of
the central queue and running the full completion/warmup/policy loop.

  data flow:   pull --round-robin--> stripe_i --> shard_i loop
               shard_i: completed?  -> output stripe_i
                        warmup?     -> fan-out / circulate (tail reinsert)
                        else        -> policy.rank on MERGED stats -> Laminar
               worker reinsert      -> home stripe (bid % active shards)
               stripe_i drained?    -> shard_i STEALS from the longest
                                       sibling stripe (consumer-side only,
                                       so the lambda-watermark deadlock
                                       invariant is untouched)

Statistics are lock-sharded (see core/stats.py): workers record into
thread-affine stripes; every shard's policy ranks on a merged snapshot, so
per-shard writes are uncontended and reads see the global picture.

TERMINATION: a shared in-flight tracker (incremented by the pull before a
batch enters the queue, decremented by the shard that completes it)
replaces the old unsynchronized ``pull.injected - completed`` read; a shard
exits when the pull is done AND the tracker reads zero, and the LAST shard
out closes the output queue — the termination barrier.  Micro-batch
coalescing preserves the invariant by construction: a worker that fuses k
queued batches into one launch splits the result back into exactly k
output batches, one per original ``bid`` (core/batch.split_back), so every
``started()`` batch still produces exactly one completion — the tracker
never needs to know fusing happened.

WARMUP (§4.1): until every predicate has at least one measurement, the
first batches are fanned out round-robin so all predicates get measured in
parallel (the dispatched set is shared across shards under a lock); other
batches are DELAYED via the circular flow — popped from the head of their
stripe and reinserted at the TAIL via ``put_worker`` — so no batch is
routed in a possibly-suboptimal order before statistics exist.

AUTO-SCALING: constructed with ``shards < max_shards`` the set starts one
shard and grows to ``max_shards`` once observed routing throughput crosses
``auto_threshold`` batches/s (the regime where routing, not UDF eval, is
the ceiling). Deterministic (SimClock) executors never auto-scale.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Iterable, List, Optional

from repro_torch.core.batch import RoutingBatch
from repro_torch.core.cache import ReuseCache
from repro_torch.core.laminar import LaminarRouter
from repro_torch.core.policies import EddyPolicy
from repro_torch.core.queues import CentralQueue, ClosedError
from repro_torch.core.stats import StatsBoard
from repro_torch.core.udf import Predicate
from repro_torch.kernels import launch as kernel_launch

# Circular-flow back-off during warmup (§4.1): a batch that cannot help
# warmup is reinserted at the tail, and the shard yields briefly so the
# head->tail cycle doesn't hot-spin a 1-core host while the warmup
# evaluations run on the worker threads.
WARMUP_CIRCULATION_SLEEP_S = 0.0005

# Shard-loop poll interval for the termination check while the stripe is
# empty (a shard blocked here wakes on its stripe's condition variable for
# new work; the timeout only bounds how fast it notices global completion).
SHARD_GET_TIMEOUT_S = 0.05

# Auto-scaling defaults: grow to SHARD_AUTO_MAX shards once at least
# SHARD_AUTO_MIN_COMPLETED batches completed at a measured routing rate
# above SHARD_AUTO_THRESHOLD_BPS batches/s — the issue's "<5 ms/batch"
# regime where the single-threaded router, not UDF eval, caps utilization.
SHARD_AUTO_MAX = 4
SHARD_AUTO_THRESHOLD_BPS = 200.0
SHARD_AUTO_MIN_COMPLETED = 64


class InFlightTracker:
    """Atomic in-flight batch count shared by the pull and every shard.

    The old single-threaded router computed ``pull.injected - completed``
    from two unsynchronized counters — benign with one router thread,
    a missed-termination/early-exit hazard with N shards. The pull calls
    ``started()`` BEFORE the batch enters the central queue and shards call
    ``finished()`` when a batch completes, so ``value() == 0`` together
    with ``pull.done`` is a safe global-quiescence condition.  Fused
    (coalesced) launches split back into one output per original batch, so
    the per-batch accounting holds unchanged with coalescing enabled."""

    def __init__(self) -> None:
        self._n = 0
        self._lock = threading.Lock()

    def started(self) -> None:
        with self._lock:
            self._n += 1

    def finished(self) -> None:
        with self._lock:
            self._n -= 1

    def value(self) -> int:
        with self._lock:
            return self._n


class EddyPull(threading.Thread):
    """Pulls batches from the child iterator into the central queue."""

    def __init__(self, source: Iterable[RoutingBatch], central: CentralQueue,
                 *, launch_token=None,
                 tracker: Optional[InFlightTracker] = None):
        super().__init__(daemon=True, name="eddy-pull")
        self.source = source
        self.central = central
        self.injected = 0
        self.done = threading.Event()
        self.error: Optional[BaseException] = None
        self.launch_token = launch_token
        self.tracker = tracker or InFlightTracker()

    def run(self) -> None:
        if self.launch_token is not None:
            kernel_launch.set_launch_context(self.launch_token)
        try:
            for batch in self.source:
                # count BEFORE the queue insert: a batch is in flight from
                # the moment it leaves the source iterator
                self.tracker.started()
                self.injected += 1
                try:
                    # single blocking below-watermark wait; close() wakes it
                    # with ClosedError (no 5 Hz busy-retry loop)
                    self.central.put_pull(batch)
                except BaseException:
                    self.tracker.finished()  # batch never entered the queue
                    raise
        except ClosedError:
            pass
        except BaseException as e:  # surfaced by the executor
            self.error = e
        finally:
            self.done.set()


class EddyShard(threading.Thread):
    """One routing shard: the full completion/warmup/policy loop over its
    own central-queue stripe, stealing from siblings when it drains."""

    def __init__(self, idx: int, core: "EddyShardSet"):
        super().__init__(daemon=True, name=f"eddy-shard-{idx}")
        self.idx = idx
        self.core = core
        self.completed = 0
        self.circulations = 0
        self.error: Optional[BaseException] = None

    def _route(self, batch: RoutingBatch) -> None:
        """Route one non-done batch.  Any failure to hand the batch onward
        (a closed worker queue, a starvation deadline, a policy error)
        decrements the in-flight tracker before re-raising — the batch is
        lost, but the termination barrier stays exact, so sibling shards
        and the executor observe completion instead of hanging forever on
        a count that can never reach zero."""
        try:
            self._route_inner(batch)
        except BaseException:
            self.core.tracker.finished()
            raise

    def _route_inner(self, batch: RoutingBatch) -> None:
        core = self.core
        remaining = batch.unvisited(core.preds)
        ledger = core.faults
        quarantined = ()
        if ledger is not None and ledger.has_quarantined:
            quarantined = ledger.quarantined_names()
            skipped = [p for p in remaining if p.name in quarantined]
            if skipped:
                # failure-aware skip: a fully-quarantined predicate gets
                # the conservative pass-through verdict at ROUTING time —
                # the decision is logged per predicate in the ledger.
                # Exception: an armed recovery probe
                # (FaultConfig.probe_after_skips) claims ONE batch and
                # routes it AT the quarantined predicate instead — probe
                # success un-quarantines it (see faults.py).
                for p in skipped:
                    if ledger.take_probe_route(p.name):
                        self._submit(core.laminars[p.name], batch)
                        return
                    batch = batch.mark_passthrough(p.name)
                    ledger.note_skip(p.name)
                remaining = [p for p in remaining
                             if p.name not in quarantined]
                if not remaining:
                    # completed by skips alone: reinsert; the next pop
                    # sees batch.done() and finishes it normally
                    core.central.put_worker(batch)
                    return
        warmup_exempt = quarantined
        if ledger is not None and ledger.dirty:
            # a predicate that has FAILED and never measured may never
            # produce a measurement; warmup dispatches one batch per
            # predicate exactly once, so gating all-measured on it would
            # circulate every other batch forever — exempt it from the
            # gate (normal ranking still routes batches at it until it
            # recovers or quarantines)
            warmup_exempt = set(quarantined) | set(ledger.failed_names())
        if core.warmup_enabled \
                and not core.stats.all_measured(exclude=warmup_exempt):
            target = core.claim_warmup(remaining)
            if target is not None:
                self._submit(core.laminars[target.name], batch)
                return
            # can't help warmup: circular delay (head -> TAIL, §4.1)
            self.circulations += 1
            core.central.put_worker(batch)
            time.sleep(WARMUP_CIRCULATION_SLEEP_S)
            return
        ranked = core.policy.rank(batch, remaining, core.stats, core.cache)
        self._submit(core.laminars[ranked[0].name], batch)

    @staticmethod
    def _submit(laminar, batch: RoutingBatch) -> None:
        """Hand a batch to a Laminar router, REFUSING the silent-drop
        path: ``submit`` contracts to return True or raise, but if a
        router implementation ever returns falsy without raising, the
        batch would vanish and wedge the termination barrier — turn that
        into a loud error (which ``_route`` converts into a tracker
        decrement + shard error)."""
        if not laminar.submit(batch):
            raise RuntimeError(
                f"laminar router for {laminar.pred.name!r} rejected batch "
                f"{batch.bid} without raising — batch would be lost"
            )

    def run(self) -> None:
        core = self.core
        if core.launch_token is not None:
            # warm_fn probes run on this thread (worker activation happens
            # inside submit): tag it so those launches attribute here too
            kernel_launch.set_launch_context(core.launch_token)
        try:
            while True:
                if core.pull.done.is_set() and core.tracker.value() == 0:
                    break
                try:
                    batch = core.central.get(
                        timeout=SHARD_GET_TIMEOUT_S, shard=self.idx
                    )
                except TimeoutError:
                    continue
                except ClosedError:
                    break
                if batch.done(core.preds):
                    self.completed += 1
                    core.tracker.finished()
                    if not batch.empty:
                        core.output.put(batch, shard=self.idx)
                    core.maybe_grow()
                    continue
                self._route(batch)
        except ClosedError:
            pass  # queue torn down mid-route: clean shutdown, not an error
        except BaseException as e:
            self.error = e
            # wake everything NOW: sibling shards get ClosedError instead
            # of polling out their timeouts, the pull stops injecting, and
            # the executor's output wait surfaces the error promptly
            core.abort()
        finally:
            core._shard_exited()


class EddyShardSet:
    """N routing shards over a sharded central queue with merged statistics.

    Replaces the single-threaded ``EddyRouter``. Shared state: the
    in-flight tracker (termination), the warmup-dispatch set, and the
    StatsBoard (whose per-shard write stripes merge on read). The last
    shard to exit closes the output queue."""

    def __init__(
        self,
        preds: List[Predicate],
        central: CentralQueue,
        output: CentralQueue,
        laminars: Dict[str, LaminarRouter],
        stats: StatsBoard,
        policy: EddyPolicy,
        pull: EddyPull,
        *,
        cache: Optional[ReuseCache] = None,
        warmup: bool = True,
        launch_token=None,
        shards: int = 1,
        max_shards: Optional[int] = None,
        auto_threshold: float = SHARD_AUTO_THRESHOLD_BPS,
        tracker: Optional[InFlightTracker] = None,
        faults=None,
    ):
        self.preds = preds
        # per-predicate FaultLedger (core/faults.py) or None: routing
        # skips fully-quarantined predicates with a logged pass-through
        self.faults = faults
        self.central = central
        self.output = output
        self.laminars = laminars
        self.stats = stats
        self.policy = policy
        self.pull = pull
        self.cache = cache
        self.warmup_enabled = warmup and len(preds) > 1
        self.launch_token = launch_token
        self.tracker = tracker or pull.tracker
        self.auto_threshold = auto_threshold
        self.initial_shards = max(1, shards)
        self.max_shards = max(self.initial_shards, max_shards or 0)
        self._shards = [EddyShard(i, self) for i in range(self.max_shards)]
        self._lock = threading.Lock()
        self._live = 0
        self._active = 0
        self._scaled = self.initial_shards >= self.max_shards
        self._warmup_dispatched: set = set()
        self._t0: Optional[float] = None
        self.grew_at: Optional[int] = None  # completed count at scale-up

    # ------------------------------------------------------------------ #
    def start(self) -> None:
        self._t0 = time.monotonic()
        self.central.set_active_shards(self.initial_shards)
        with self._lock:
            for s in self._shards[: self.initial_shards]:
                self._live += 1
                self._active += 1
                s.start()

    def maybe_grow(self) -> None:
        """Auto-scale: start the remaining shards once measured routing
        throughput crosses the threshold (one-shot, any shard may trip it)."""
        if self._scaled:
            return
        done = self.completed
        if done < SHARD_AUTO_MIN_COMPLETED:
            return
        elapsed = time.monotonic() - self._t0
        if elapsed <= 0 or done / elapsed < self.auto_threshold:
            return
        with self._lock:
            if self._scaled:
                return
            self._scaled = True
            self.grew_at = done
            for s in self._shards[self._active:]:
                self._live += 1
                self._active += 1
                s.start()
        self.central.set_active_shards(self.max_shards)

    def claim_warmup(self, remaining: List[Predicate]) -> Optional[Predicate]:
        """ "Just enough batches": one warmup batch per unmeasured predicate,
        the dispatched set shared across shards under one short lock."""
        with self._lock:
            for p in remaining:
                if (not self.stats[p.name].measured
                        and p.name not in self._warmup_dispatched):
                    self._warmup_dispatched.add(p.name)
                    return p
        return None

    def abort(self) -> None:
        """Error teardown: close both queues so every blocked thread (the
        pull's watermark wait, sibling shards' stripe waits, the
        executor's output wait) wakes with ClosedError immediately
        instead of discovering the failure by poll timeout."""
        self.central.close()
        self.output.close()

    def _shard_exited(self) -> None:
        with self._lock:
            self._live -= 1
            last = self._live == 0
        if last:  # termination barrier: only the last shard out closes
            self.output.close()

    # ------------------------------ metrics ---------------------------- #
    @property
    def shards_active(self) -> int:
        with self._lock:
            return self._active

    @property
    def completed(self) -> int:
        return sum(s.completed for s in self._shards)

    @property
    def circulations(self) -> int:
        return sum(s.circulations for s in self._shards)

    @property
    def steals(self) -> int:
        return self.central.steals

    @property
    def error(self) -> Optional[BaseException]:
        for s in self._shards:
            if s.error is not None:
                return s.error
        return None
