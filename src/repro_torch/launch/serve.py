"""QueryService — the always-on multi-tenant serving layer, on the port.

Port of ``repro.launch.serve``: the service, its handles and reports, and
``review_source`` with only their imports rewritten; ``build_llm_udf``
(the LLM(...) predicate, a decoder forward through the hand-written flash
kernel, then a token-pool score) and the single-query CLI ``main`` written
for torch. Both take ``device=`` (``--device``), the card by default:

  python -m repro_torch.launch.serve --reviews 200 --policy cost
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu

Everything below ``launch/`` used to be one-shot: build an ``AQPExecutor``,
run one query, tear it down.  Production ML-query traffic is N concurrent
queries contending for ONE accelerator pool — exactly what the
thread-affine launch attribution and cross-predicate leasing were built
for.  ``QueryService`` makes the executors long-lived *tenants* of a
shared ``ResourceArbiter``/``DevicePool``:

  service = QueryService(pool=DevicePool({"cpu": 8}), max_concurrent=4)
  h = service.submit(predicates, batches, priority=2.0, deadline_s=5.0)
  report = h.result(timeout=30)      # QueryReport telemetry
  service.close()

API semantics
-------------
``submit(predicates, source, *, priority=1.0, deadline_s=None, qid=None,
**executor_kwargs)`` enqueues a query and returns a ``QueryHandle``
immediately.

* **Admission control** — the pending queue is BOUNDED (``max_pending``):
  a submit that would overflow it raises ``AdmissionError`` synchronously
  (the caller sheds load at the edge instead of queueing unboundedly).
  ``close()`` also rejects new submits.  At most ``max_concurrent``
  queries run at once; the rest wait in priority order.
* **Priority** — higher runs first.  The dispatcher pops the pending heap
  by ``(-priority, earliest deadline, submit order)``, and a running
  query's predicates arbitrate shared-pool slots with an URGENCY weight
  (``policies.urgency_weight(priority, deadline)``) folded into
  ``PressureRanked`` — so a high-priority or deadline-pressed tenant wins
  contended slots at equal measured pressure.  Scheduling is
  PREEMPTION-FREE: admission/completion trigger ``arbiter.rebalance()``
  (stale standing wants cleared), but running queries are never paused
  and held leases never revoked.
* **Deadline** — ``deadline_s`` is relative to submission.  A PENDING
  query still waiting when its deadline passes is EXPIRED without
  running (its handle reports ``state == "EXPIRED"``).  A RUNNING query
  is never killed by its deadline (no preemption); its report records
  ``deadline_met`` so goodput metrics can discount late finishes.
  ``cancel()`` removes a pending query outright and asks a running one
  to stop at the next completed batch (state ``CANCELLED``).
* **Name conflicts** — arbiter registrations are keyed by predicate
  name, so two queries sharing a predicate NAME cannot run concurrently;
  the dispatcher SERIALIZES them (the later one waits, regardless of
  priority) instead of cross-wiring their pipelines.

Cross-query statistics (the live-prior channel): the service owns a
``StatsStore`` (in-memory by default, persistent with ``stats_path=``).
Before dispatching a query it folds every RUNNING executor's live board
into the store (``StatsStore.record_live`` — delta-based, never
double-counts), then warm-starts the newcomer's board from it: query B
starts from query A's in-flight profile, not from roofline priors.

Telemetry: each finished handle carries a structured ``QueryReport`` —
queue-time vs eval-time split, per-predicate cache hit rates, routing
counters, fault/quarantine summary, re-verification counters (executor
knob ``reverify=``), exact output row ids — and every tenant executor's
``stats_snapshot()["_service"]`` identifies its query, priority and
deadline.  Service threads are daemons named ``svc-dispatch`` /
``svc-query-<qid>`` (covered by the tests/conftest leaked-thread guard).
"""
from __future__ import annotations

import argparse
import heapq
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.core.executor import AQPExecutor
from repro_torch.core.policies import ArbiterPolicy, urgency_weight
from repro_torch.core.resources import DevicePool, ResourceArbiter
from repro_torch.core.statstore import StatsStore
from repro_torch.core.udf import Predicate

MAX_LEN = 512

# Dispatcher poll cadence: how promptly pending-queue deadline expiry is
# noticed when no submit/finish event wakes the dispatcher.
_DISPATCH_POLL_S = 0.05

PENDING = "PENDING"
RUNNING = "RUNNING"
DONE = "DONE"
FAILED = "FAILED"
CANCELLED = "CANCELLED"
EXPIRED = "EXPIRED"


class AdmissionError(RuntimeError):
    """Submit rejected: the bounded pending queue is full (or the service
    is closed).  Raised synchronously from ``submit`` — load is shed at
    the edge, never queued unboundedly."""


@dataclass
class QueryReport:
    """Structured per-query telemetry (returned by ``QueryHandle.result``).

    ``queue_time_s`` is submit -> dispatch; ``eval_time_s`` dispatch ->
    finish; ``deadline_met`` is None for deadline-less queries.
    ``row_ids`` is the exact concatenated output row-id multiset;
    ``board_predicates`` the predicate entries this query's OWN board
    profiled (the cross-query leakage assert: it must only ever contain
    this query's names).  ``routing`` / ``faults`` / ``cache_hit_rates``
    / ``reverify`` summarize the tenant executor's final snapshot."""

    qid: str
    state: str
    priority: float
    deadline_s: Optional[float]
    submitted_at: float
    started_at: Optional[float] = None
    finished_at: Optional[float] = None
    queue_time_s: float = 0.0
    eval_time_s: float = 0.0
    deadline_met: Optional[bool] = None
    rows: int = 0
    batches: int = 0
    row_ids: Optional[np.ndarray] = None
    board_predicates: Tuple[str, ...] = ()
    cache_hit_rates: Dict[str, float] = field(default_factory=dict)
    routing: Dict[str, object] = field(default_factory=dict)
    faults: Dict[str, object] = field(default_factory=dict)
    reverify: Optional[Dict[str, int]] = None
    error: str = ""


class QueryHandle:
    """Caller-side handle: await, inspect, or cancel one submitted query."""

    def __init__(self, qid: str, *, priority: float,
                 deadline_abs: Optional[float], report: QueryReport):
        self.qid = qid
        self.priority = priority
        self.deadline_abs = deadline_abs
        self.report = report
        self._pred_names: frozenset = frozenset()
        self.output: List = []          # completed RoutingBatches
        self._done = threading.Event()
        self._cancel = threading.Event()

    @property
    def state(self) -> str:
        return self.report.state

    def done(self) -> bool:
        return self._done.is_set()

    def cancel(self) -> bool:
        """Request cancellation; returns True if the query had not
        already finished.  Pending -> dropped at next dispatch; running
        -> stops at the next completed batch."""
        if self._done.is_set():
            return False
        self._cancel.set()
        return True

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    def result(self, timeout: Optional[float] = None) -> QueryReport:
        """Block until the query reaches a terminal state; returns the
        ``QueryReport``.  Raises TimeoutError on timeout and RuntimeError
        if the query FAILED (the report stays readable on ``.report``)."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"query {self.qid!r} still {self.state}")
        if self.report.state == FAILED:
            raise RuntimeError(
                f"query {self.qid!r} failed: {self.report.error}"
            )
        return self.report


class QueryService:
    """N long-lived executor tenants over one shared arbiter (module
    docstring has the full submit/priority/deadline/admission contract)."""

    def __init__(self, *,
                 pool: Optional[DevicePool] = None,
                 arbiter_policy: Optional[ArbiterPolicy] = None,
                 max_concurrent: int = 2,
                 max_pending: int = 16,
                 stats_store: Optional[StatsStore] = None,
                 stats_path: Optional[str] = None,
                 executor_defaults: Optional[dict] = None):
        if max_concurrent < 1:
            raise ValueError("max_concurrent must be >= 1")
        if max_pending < 0:
            raise ValueError("max_pending must be >= 0")
        self.arbiter = ResourceArbiter(pool=pool, policy=arbiter_policy)
        self.max_concurrent = max_concurrent
        self.max_pending = max_pending
        # the live-prior channel: in-memory unless the caller persists
        self.store = stats_store or StatsStore(stats_path)
        self.executor_defaults = dict(executor_defaults or {})
        self._cv = threading.Condition()
        self._seq = itertools.count()
        self._qid_count = itertools.count()
        # pending heap: (-priority, deadline key, submit seq, handle, ...)
        self._pending: List[tuple] = []
        self._running: Dict[str, QueryHandle] = {}
        # qid -> (executor, predicates, fold bases): the live boards the
        # dispatcher folds into the store before admitting a newcomer
        self._live: Dict[str, tuple] = {}
        self._threads: List[threading.Thread] = []
        self._closed = False
        # service counters (surfaced via snapshot())
        self.submitted = 0
        self.rejected = 0
        self.completed = 0
        self.failed = 0
        self.cancelled = 0
        self.expired = 0
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, daemon=True, name="svc-dispatch"
        )
        self._dispatcher.start()

    # ----------------------------- submit ----------------------------- #
    def submit(self, predicates: List[Predicate], source: Iterable, *,
               priority: float = 1.0, deadline_s: Optional[float] = None,
               qid: Optional[str] = None, **executor_kwargs) -> QueryHandle:
        """Enqueue one query (an iterable of RoutingBatches plus its
        predicates); returns a ``QueryHandle`` immediately.  Raises
        ``AdmissionError`` when the bounded pending queue is full or the
        service is closed."""
        now = time.monotonic()
        qid = qid or f"q{next(self._qid_count)}"
        deadline_abs = None if deadline_s is None else now + deadline_s
        report = QueryReport(
            qid=qid, state=PENDING, priority=float(priority),
            deadline_s=deadline_s, submitted_at=now,
        )
        handle = QueryHandle(qid, priority=float(priority),
                             deadline_abs=deadline_abs, report=report)
        handle._pred_names = frozenset(p.name for p in predicates)
        with self._cv:
            if self._closed:
                raise AdmissionError("service is closed")
            if len(self._pending) >= self.max_pending:
                self.rejected += 1
                raise AdmissionError(
                    f"pending queue full ({self.max_pending}); "
                    f"query {qid!r} rejected"
                )
            self.submitted += 1
            heapq.heappush(self._pending, (
                -float(priority),
                deadline_abs if deadline_abs is not None else float("inf"),
                next(self._seq),
                handle, list(predicates), source, dict(executor_kwargs),
            ))
            self._cv.notify_all()
        return handle

    # --------------------------- dispatcher --------------------------- #
    def _dispatch_loop(self) -> None:
        while True:
            with self._cv:
                while not self._dispatchable_locked():
                    if self._closed and not self._pending:
                        return
                    self._cv.wait(timeout=_DISPATCH_POLL_S)
                    self._expire_locked()
                item = self._pop_eligible_locked()
                if item is None:
                    continue
                handle, predicates, source, kwargs = item
                handle.report.state = RUNNING
                self._running[handle.qid] = handle
            t = threading.Thread(
                target=self._run_query,
                args=(handle, predicates, source, kwargs),
                daemon=True, name=f"svc-query-{handle.qid}",
            )
            with self._cv:
                self._threads.append(t)
            t.start()

    def _dispatchable_locked(self) -> bool:
        return bool(self._pending) and len(self._running) < self.max_concurrent

    def _expire_locked(self) -> None:
        """Drop pending queries whose deadline passed, and honor pending
        cancels, without disturbing heap order for the rest."""
        if not self._pending:
            return
        now = time.monotonic()
        keep = []
        for item in self._pending:
            handle = item[3]
            if handle._cancel.is_set():
                self._finish_pending(handle, CANCELLED)
            elif handle.deadline_abs is not None and now > handle.deadline_abs:
                self._finish_pending(handle, EXPIRED)
            else:
                keep.append(item)
        if len(keep) != len(self._pending):
            self._pending = keep
            heapq.heapify(self._pending)

    def _finish_pending(self, handle: QueryHandle, state: str) -> None:
        handle.report.state = state
        handle.report.finished_at = time.monotonic()
        handle.report.queue_time_s = (
            handle.report.finished_at - handle.report.submitted_at
        )
        if state == EXPIRED:
            self.expired += 1
            handle.report.deadline_met = False
        else:
            self.cancelled += 1
        handle._done.set()

    def _pop_eligible_locked(self) -> Optional[tuple]:
        """Pop the best pending query whose predicate names don't collide
        with a running tenant (name-keyed arbiter registrations — see
        module docstring); colliding entries are pushed back untouched."""
        self._expire_locked()
        running_names = set()
        for h in self._running.values():
            running_names |= h._pred_names
        deferred = []
        picked = None
        while self._pending:
            item = heapq.heappop(self._pending)
            _, _, _, handle, predicates, _, _ = item
            if {p.name for p in predicates} & running_names:
                deferred.append(item)
                continue
            picked = item[3:]
            break
        for item in deferred:
            heapq.heappush(self._pending, item)
        return picked

    # --------------------------- query runner --------------------------- #
    def _fold_live_locked(self) -> None:
        """Fold every running executor's live board into the store (the
        cross-query live-prior channel; delta-based via record_live)."""
        for qid, (ex, preds, bases) in list(self._live.items()):
            try:
                new_bases = self.store.record_live(ex.stats, preds, bases)
            except Exception:
                continue  # a torn-down rival must not block admission
            self._live[qid] = (ex, preds, new_bases)

    def _run_query(self, handle: QueryHandle, predicates: List[Predicate],
                   source: Iterable, kwargs: dict) -> None:
        report = handle.report
        started = time.monotonic()
        report.started_at = started
        report.queue_time_s = started - report.submitted_at
        # deadline/priority-aware arbitration + preemption-free rebalance
        self.arbiter.note_query_admitted(
            handle.qid,
            urgency_weight(handle.priority, handle.deadline_abs, started),
        )
        ex = None
        try:
            merged = dict(self.executor_defaults)
            merged.update(kwargs)
            ex = AQPExecutor(predicates, arbiter=self.arbiter,
                             query=handle.qid, **merged)
            ex.service_info = {
                "managed": True,
                "query": handle.qid,
                "priority": handle.priority,
                "deadline_s": report.deadline_s,
            }
            with self._cv:
                # rivals' live evidence first, then warm-start from it
                self._fold_live_locked()
            seeded = self.store.warm_start(ex.stats, predicates)
            bases = {
                n: c for n, c in ex.stats.batch_counts().items() if c
            }
            del seeded  # bases (post-seed batch counts) supersede it
            with self._cv:
                self._live[handle.qid] = (ex, predicates, bases)
            ids = []
            with ex:
                for b in ex.run(source):
                    handle.output.append(b)
                    ids.append(np.asarray(b.row_ids))
                    report.batches += 1
                    report.rows += b.rows
                    if handle._cancel.is_set():
                        break
            report.row_ids = (
                np.concatenate(ids) if ids else np.zeros((0,), np.int64)
            )
            snap = ex.stats_snapshot()
            report.board_predicates = tuple(
                sorted(k for k in snap if not k.startswith("_"))
            )
            report.cache_hit_rates = {
                k: v.get("cache_hit_rate", 0.0)
                for k, v in snap.items() if not k.startswith("_")
            }
            report.routing = snap.get("_routing", {})
            fsnap = snap.get("_faults", {})
            report.faults = {
                "quarantined": sorted(
                    n for n, s in fsnap.items() if s.get("quarantined")
                ),
                "unquarantined": sorted(
                    n for n, s in fsnap.items() if s.get("unquarantines")
                ),
                "failures": sum(s.get("failures", 0) for s in fsnap.values()),
                "retries": sum(s.get("retries", 0) for s in fsnap.values()),
                "passthrough_batches": sum(
                    s.get("quarantined_batches", 0) for s in fsnap.values()
                ),
                "skipped_routes": sum(
                    s.get("skipped_routes", 0) for s in fsnap.values()
                ),
            }
            report.reverify = snap.get("_service", {}).get("reverify")
            report.state = CANCELLED if handle._cancel.is_set() else DONE
        except Exception as e:
            report.state = FAILED
            report.error = repr(e)
        finally:
            if ex is not None:
                try:
                    ex.shutdown()
                except Exception:
                    pass
            finished = time.monotonic()
            report.finished_at = finished
            report.eval_time_s = finished - started
            if handle.deadline_abs is not None:
                report.deadline_met = finished <= handle.deadline_abs
            with self._cv:
                # final fold: this query's closing profile becomes the
                # next tenant's prior (then drop the live reference)
                if handle.qid in self._live:
                    ex2, preds, bases = self._live.pop(handle.qid)
                    try:
                        self.store.record_live(ex2.stats, preds, bases)
                    except Exception:
                        pass
                self._running.pop(handle.qid, None)
                if report.state == DONE:
                    self.completed += 1
                elif report.state == FAILED:
                    self.failed += 1
                elif report.state == CANCELLED:
                    self.cancelled += 1
                self._cv.notify_all()
            self.arbiter.note_query_finished(handle.qid)
            try:
                self.store.flush()
            except Exception:
                pass
            handle._done.set()

    # ----------------------------- lifecycle ----------------------------- #
    def pending_count(self) -> int:
        with self._cv:
            return len(self._pending)

    def running_count(self) -> int:
        with self._cv:
            return len(self._running)

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until no query is pending or running; False on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while self._pending or self._running:
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return False
                self._cv.wait(timeout=min(
                    _DISPATCH_POLL_S, remaining or _DISPATCH_POLL_S
                ))
        return True

    def snapshot(self) -> Dict[str, object]:
        """Service-level counters + the shared arbiter's picture."""
        with self._cv:
            return {
                "submitted": self.submitted,
                "rejected": self.rejected,
                "completed": self.completed,
                "failed": self.failed,
                "cancelled": self.cancelled,
                "expired": self.expired,
                "pending": len(self._pending),
                "running": len(self._running),
                "max_concurrent": self.max_concurrent,
                "max_pending": self.max_pending,
                "arbiter": self.arbiter.counters(),
            }

    def close(self, *, drain: bool = True,
              timeout: Optional[float] = None) -> None:
        """Stop accepting submits; optionally wait for in-flight queries.
        With ``drain=False`` pending queries are cancelled."""
        with self._cv:
            self._closed = True
            if not drain:
                for item in self._pending:
                    self._finish_pending(item[3], CANCELLED)
                self._pending = []
            self._cv.notify_all()
        if drain:
            self.drain(timeout=timeout)
        self._dispatcher.join(timeout=5.0)
        with self._cv:
            threads = list(self._threads)
        for t in threads:
            t.join(timeout=5.0)

    def __enter__(self) -> "QueryService":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()


# ----------------------------- single-query CLI ----------------------------- #
def build_llm_udf(arch: str = "smollm-135m", params=None, cfg=None, *,
                  device="cuda"):
    """The LLM(...) predicate: a real decoder forward + token-pool scoring.

    As the JAX package's: ``get_config(arch).reduce_for_smoke()`` unless a
    ``cfg`` is given, weights from ``init_params`` with seed 0 unless
    ``params`` (a ``Transformer``, e.g. from ``convert.transformer_params``)
    is given, and the score of a row is its float32 log-softmax summed over
    its live positions, averaged over FOOD_WORDS less the average over
    SERVICE_WORDS. Runs on ``device`` (raises at once without a card when
    it is "cuda"): the copy in, the forward and the copy back run on the
    worker thread's own stream (``launch.thread_stream``). Token ids
    outside the vocabulary raise ValueError (``library.token_ids``)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.udf import UDF
    from repro_torch.data.text import FOOD_WORDS, SERVICE_WORDS
    from repro_torch.kernels import launch
    from repro_torch.models import transformer as tf
    from repro_torch.models.registry import model_api
    from repro_torch.udfs.library import token_ids

    dev = launch.require_device(device)
    cfg = cfg or get_config(arch).reduce_for_smoke()
    api = model_api(cfg)
    if params is None:
        params = api.init_params(cfg, torch.Generator(dev).manual_seed(0),
                                 device=dev)

    food = torch.as_tensor(FOOD_WORDS, device=dev)
    service = torch.as_tensor(SERVICE_WORDS, device=dev)

    def score(tokens):  # (rows, MAX_LEN) int32, 0-padded
        # the dense decoder's forward whatever the family, as the JAX
        # package's score: an ssm or hybrid model's parameters raise here
        logits = tf.forward(cfg, params, {"tokens": tokens})  # (rows, L, V)
        mask = (tokens > 0)[..., None].to(logits.dtype)
        pooled = (torch.log_softmax(logits.to(torch.float32), -1)
                  * mask).sum(1)
        return pooled[:, food].mean(-1) - pooled[:, service].mean(-1)

    def fn(data):
        tokens = np.asarray(data["tokens"])
        with torch.inference_mode(), launch.thread_stream(dev):
            out = score(token_ids(tokens, tokens.shape[1], cfg.vocab_size,
                                  dev))
            return out.cpu().numpy()

    return UDF(
        "LLM", fn, columns=("tokens",), resource="cuda:0",
        proxy_cost=lambda d: float((d["tokens"] > 0).sum()),  # text length
    )


def review_source(reviews, chunk=64):
    for i in range(0, len(reviews), chunk):
        part = reviews[i : i + chunk]
        toks = np.zeros((len(part), MAX_LEN), np.int32)
        for j, r in enumerate(part):
            toks[j, : len(r.tokens)] = r.tokens[:MAX_LEN]
        yield {
            "tokens": toks,
            "rating": np.array([r.rating for r in part], np.int32),
            "_row_id": np.array([r.rid for r in part], np.int64),
        }


def main(argv=None) -> None:
    """Single-query driver, rebuilt on QueryService (max_concurrent=1):
    the one-off path and the multi-tenant path share one implementation."""
    from repro_torch.core.plan import Query, TrivialPredicate, batches_of
    from repro_torch.core.policies import EDDY_POLICIES, DataAware

    ap = argparse.ArgumentParser()
    ap.add_argument("--reviews", type=int, default=200)
    ap.add_argument("--policy", default="cost", choices=sorted(EDDY_POLICIES))
    ap.add_argument("--batch-rows", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.data.text import make_reviews

    reviews = make_reviews(args.reviews)
    llm = build_llm_udf(device=args.device)
    pred = Predicate("LLM_is_food", llm, compare=lambda s: s > 0)
    q = Query(
        source=review_source(reviews),
        predicates=[pred],
        trivial=[TrivialPredicate("rating", "<=", 1)],
        batch_rows=args.batch_rows,
    )
    t0 = time.perf_counter()
    with QueryService(max_concurrent=1) as service:
        handle = service.submit(
            [pred], batches_of(q),
            policy=EDDY_POLICIES[args.policy](),
            laminar_policy_factory=DataAware,
            max_workers=4,
        )
        report = handle.result()
    dt = time.perf_counter() - t0
    print(f"[serve] matched {report.rows} negative food reviews in {dt:.2f}s"
          f" (queue {report.queue_time_s*1e3:.1f}ms,"
          f" eval {report.eval_time_s:.2f}s)")
    print("[serve] routing:", report.routing)
    print("[serve] cache hit rates:", report.cache_hit_rates)
    print("[serve] service:", service.snapshot())


if __name__ == "__main__":
    main()
