"""Queues of the AQP executor (§3.2/§3.3) — lock-sharded.

CentralQueue implements the paper's deadlock prevention: the EDDY PULL may
insert only while the queue is < lambda (default 0.3) full, while predicate
workers may ALWAYS reinsert — completed batches can never be blocked out by
fresh ingest, so the cycle (pull -> route -> worker -> central) cannot
deadlock. Worker input queues are bounded short (default 2) to cap backlog,
exactly as in the paper.

SHARDING: with ``shards > 1`` the queue keeps one deque + condition
variable per routing shard behind a SINGLE lambda-watermark account (one
small counter lock, never held together with a stripe lock). Producers
touch exactly one stripe per insert (pull round-robins over the ACTIVE
stripes; workers reinsert to a batch's home stripe, ``bid % active``), so
the submit path of N shards never serializes on one condition variable.
Consumers ``get(shard=i)`` from their own stripe and — consumer-side ONLY —
steal from the longest sibling stripe when theirs drains. Stealing never
inserts, so the watermark invariant (worker reinserts always admitted,
pull gated below lambda) is exactly the single-deque one.

The old head-insert ``put_front`` is gone: the §4.1 warmup circular flow
pops from the head and reinserts at the TAIL via ``put_worker`` (pinned by
a regression test), so nothing ever inserted at the head.
"""
from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Any, List, Optional

LAMBDA_DEFAULT = 0.3

# A sharded consumer with an empty stripe re-scans its siblings for work to
# steal at this cadence; its own stripe's condition variable still wakes it
# immediately, so the poll only bounds cross-stripe pickup latency.
STEAL_POLL_S = 0.02


class ClosedError(RuntimeError):
    pass


class CentralQueue:
    """Bounded multi-producer queue with lambda-watermark pull gating.

    ``shards`` stripes each own a deque + condition variable; a single
    counter (its own lock, never nested with a stripe lock) carries the
    watermark/capacity accounting. ``shards=1`` reproduces the original
    single-deque behavior exactly.
    """

    def __init__(self, capacity: int = 64, lam: float = LAMBDA_DEFAULT,
                 shards: int = 1):
        assert capacity > 0 and 0 < lam <= 1 and shards >= 1
        self.capacity = capacity
        self.lam = lam
        self.shards = shards
        self._stripes: List[collections.deque] = [
            collections.deque() for _ in range(shards)
        ]
        self._cvs = [threading.Condition() for _ in range(shards)]
        # watermark/capacity account: guarded by its own condition variable;
        # producers blocked on space wait here, consumers notify on pop
        self._size_cv = threading.Condition()
        self._size = 0
        self._closed = False
        self._active = shards
        self._rr = itertools.count()
        self.steals = 0  # consumer-side cross-stripe pops (observability)

    # -------------------- stripe selection -------------------- #
    def set_active_shards(self, n: int) -> None:
        """Limit producer-side stripe assignment to the first ``n`` stripes
        (consumers may still drain/steal any stripe). Used by the shard set
        when it auto-scales mid-run."""
        self._active = max(1, min(n, self.shards))

    @property
    def active_shards(self) -> int:
        return self._active

    def _home(self, item: Any) -> int:
        """A batch's home stripe: affinity by batch id, so a batch cycles
        through one shard's loop and stealing is the only cross-shard path."""
        bid = getattr(item, "bid", None)
        if bid is None:
            return next(self._rr) % self._active
        return bid % self._active

    # -------------------- producer side -------------------- #
    def _reserve(self, limit: int, timeout: Optional[float]) -> bool:
        with self._size_cv:
            ok = self._size_cv.wait_for(
                lambda: self._closed or self._size < limit, timeout
            )
            if self._closed:
                raise ClosedError
            if not ok:
                return False
            self._size += 1
            return True

    def _unreserve(self) -> None:
        with self._size_cv:
            self._size -= 1
            self._size_cv.notify_all()

    def _append(self, idx: int, item: Any) -> None:
        with self._cvs[idx]:
            if self._closed:
                closed = True
            else:
                closed = False
                self._stripes[idx].append(item)
                self._cvs[idx].notify()
        if closed:  # raced with close(): undo the reservation, surface it
            self._unreserve()
            raise ClosedError

    def put_pull(self, item: Any, timeout: Optional[float] = None) -> bool:
        """EddyPull insert: allowed only below the lambda watermark.

        With no ``timeout`` this is a single blocking wait that wakes on
        space OR ``close()`` (raising ClosedError) — the pull thread never
        needs to spin-retry."""
        limit = max(1, int(self.capacity * self.lam))
        if not self._reserve(limit, timeout):
            return False
        self._append(next(self._rr) % self._active, item)
        return True

    def put_worker(self, item: Any, shard: Optional[int] = None) -> None:
        """Worker reinsert: always allowed (deadlock prevention)."""
        idx = self._home(item) if shard is None else shard % self.shards
        with self._cvs[idx]:
            if self._closed:
                raise ClosedError
            self._stripes[idx].append(item)
            self._cvs[idx].notify()
        with self._size_cv:
            self._size += 1

    def put(self, item: Any, timeout: Optional[float] = None,
            shard: Optional[int] = None) -> bool:
        """Capacity-bounded insert (no watermark) to a chosen stripe —
        the sharded OUTPUT queue path: each shard writes its own stripe so
        collection never serializes producers on one condition variable."""
        if not self._reserve(self.capacity, timeout):
            return False
        idx = (next(self._rr) if shard is None else shard) % self.shards
        self._append(idx, item)
        return True

    # -------------------- consumer side -------------------- #
    def _after_pop(self) -> None:
        with self._size_cv:
            self._size -= 1
            self._size_cv.notify_all()

    def get(self, timeout: Optional[float] = None, *, shard: int = 0) -> Any:
        """Pop for consumer ``shard``: own stripe first, else steal from the
        longest sibling stripe (consumer-side only — stealing never inserts,
        preserving the lambda-watermark invariant)."""
        idx = shard % self.shards
        if self.shards == 1:
            cv, q = self._cvs[0], self._stripes[0]
            with cv:
                ok = cv.wait_for(lambda: self._closed or q, timeout)
                if q:
                    item = q.popleft()
                elif self._closed:
                    raise ClosedError
                elif not ok:
                    raise TimeoutError
                else:
                    raise AssertionError("unreachable")
            self._after_pop()
            return item

        deadline = None if timeout is None else time.monotonic() + timeout
        cv = self._cvs[idx]
        while True:
            with cv:
                if self._stripes[idx]:
                    item = self._stripes[idx].popleft()
                    self._after_pop()
                    return item
            # steal: longest sibling stripe (length reads are unlocked —
            # a heuristic victim choice; the pop itself re-checks under
            # the victim's lock)
            victim = max(
                (j for j in range(self.shards) if j != idx),
                key=lambda j: len(self._stripes[j]),
            )
            if self._stripes[victim]:
                with self._cvs[victim]:
                    if self._stripes[victim]:
                        item = self._stripes[victim].popleft()
                        self.steals += 1
                        self._after_pop()
                        return item
            if self._closed:
                if not any(self._stripes):  # drain before raising
                    raise ClosedError
                continue
            now = time.monotonic()
            if deadline is not None and now >= deadline:
                raise TimeoutError
            wait = STEAL_POLL_S if deadline is None else min(
                STEAL_POLL_S, deadline - now
            )
            with cv:
                if not self._stripes[idx] and not self._closed:
                    cv.wait(wait)

    def __len__(self) -> int:
        with self._size_cv:
            return self._size

    @property
    def fill_fraction(self) -> float:
        return len(self) / self.capacity

    def close(self) -> None:
        with self._size_cv:
            self._closed = True
            self._size_cv.notify_all()
        for cv in self._cvs:
            with cv:
                cv.notify_all()


class BoundedQueue:
    """Short bounded FIFO for Laminar routers / workers (default len 2).

    Waiters are split across two condition variables on one lock: putters
    wait for SPACE, getters wait for an ITEM, and each side notifies
    exactly ONE waiter on the other. With N routing shards blocked in
    ``submit`` on a hot predicate's queue, a worker pop wakes a single
    submitter instead of thundering every blocked shard through the GIL —
    this is the submit-path serialization the sharded eddy core removes."""

    def __init__(self, capacity: int = 2):
        self.capacity = capacity
        self._q: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._item = threading.Condition(self._lock)   # get() waiters
        self._space = threading.Condition(self._lock)  # put() waiters
        self._closed = False

    def put(self, item: Any, timeout: Optional[float] = None) -> bool:
        with self._space:
            ok = self._space.wait_for(
                lambda: self._closed or len(self._q) < self.capacity, timeout
            )
            if self._closed:
                raise ClosedError
            if not ok:
                return False
            self._q.append(item)
            self._item.notify()
            return True

    def try_put(self, item: Any) -> bool:
        with self._lock:
            if self._closed:
                raise ClosedError
            if len(self._q) >= self.capacity:
                return False
            self._q.append(item)
            self._item.notify()
            return True

    def get(self, timeout: Optional[float] = None) -> Any:
        with self._item:
            ok = self._item.wait_for(lambda: self._closed or self._q, timeout)
            if self._q:
                item = self._q.popleft()
                self._space.notify()
                return item
            if self._closed:
                raise ClosedError
            if not ok:
                raise TimeoutError
            raise AssertionError("unreachable")

    def get_many(self, max_items: int) -> list:
        """Non-blocking drain of up to ``max_items`` queued items.

        The micro-batch coalescing path: a worker that dequeued one batch
        opportunistically drains whatever else is already waiting so a
        single fused launch amortizes per-launch overhead.  Never blocks
        and never raises — returns ``[]`` when nothing is queued (a closed
        queue's remaining items are still drained; the caller's next
        blocking ``get`` surfaces ClosedError).  Each popped item wakes one
        blocked putter, exactly like ``get``, so producers refill the
        freed capacity without a thundering herd."""
        if max_items <= 0:
            return []
        with self._lock:
            n = min(max_items, len(self._q))
            items = [self._q.popleft() for _ in range(n)]
            for _ in range(n):
                self._space.notify()
            return items

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._item.notify_all()
            self._space.notify_all()
