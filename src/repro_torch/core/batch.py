"""RoutingBatch — the unit of data flowing through the AQP executor (§3.3).

Each batch carries a unique id (cheaper than hashing multi-dimensional
payloads, exactly as the paper argues), column data, per-row source ids (for
the reuse cache), and the set of predicates already evaluated. Eager
materialization: ``filter`` drops failing rows immediately so later
predicates see only survivors.

COALESCING CONTRACT (``concat`` / ``split_back``): a worker may fuse
several queued batches destined for the same predicate into ONE batch for
a single kernel launch (amortizing per-launch dispatch/trace/probe
overhead — §5.1's utilization argument applied to tiny batches).  The
contract is that fusing is invisible to routing semantics:

* ``concat`` stacks the batches column-wise (``np.concatenate``) and
  records per-batch segment boundaries — each ``BatchSegment`` keeps a
  reference to its ORIGINAL batch plus its ``[start, stop)`` row span in
  the fused payload, so ``(bid, visited, warmup, created_at, sim_ready)``
  survive exactly.
* Predicates are row-wise: evaluating the fused batch yields, row for
  row, the same outputs/mask each batch would have seen alone.
* ``split_back`` slices the fused row mask at the segment boundaries and
  applies each slice to the segment's ORIGINAL batch — so every output
  batch is bit-identical (bid, visited set, surviving row multiset,
  per-row data) to what the uncoalesced path would have produced.  Only
  ``sim_ready`` differs by design under SimClock: every segment inherits
  the single fused launch's finish time (one launch term + summed row
  terms, see core/simclock.py).

The fused batch itself is transient — it exists only between dequeue and
split, never enters a queue, and its fresh ``bid`` is never observed by
the in-flight tracker (which counts the per-``bid`` split outputs).
"""
from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field, replace
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np

_next_id = itertools.count()
_id_lock = threading.Lock()


def _new_id() -> int:
    with _id_lock:
        return next(_next_id)


@dataclass(frozen=True)
class RoutingBatch:
    data: Dict[str, np.ndarray]          # column -> (rows, ...) arrays
    row_ids: np.ndarray                  # (rows,) stable source ids (cache keys)
    bid: int = field(default_factory=_new_id)
    visited: FrozenSet[str] = frozenset()
    warmup: bool = False
    created_at: float = 0.0
    sim_ready: float = 0.0   # virtual arrival time (SimClock runs)
    # predicates whose verdict on this batch is a conservative PASS
    # (quarantined predicate or poison batch, see core/faults.py): the
    # rows were NOT filtered by these predicates, only flagged — consumers
    # needing exact semantics can drop or re-verify flagged batches
    passthrough: FrozenSet[str] = frozenset()

    @property
    def rows(self) -> int:
        return int(self.row_ids.shape[0])

    @property
    def empty(self) -> bool:
        return self.rows == 0

    def mark_visited(self, predicate: str) -> "RoutingBatch":
        return replace(self, visited=self.visited | {predicate})

    def mark_passthrough(self, predicate: str) -> "RoutingBatch":
        """Conservative pass-through verdict for ``predicate`` (fault
        quarantine): counts as VISITED — the termination invariant needs
        every predicate accounted for — but the rows are flagged rather
        than filtered, so no row is dropped on faulty evidence."""
        return replace(self, visited=self.visited | {predicate},
                       passthrough=self.passthrough | {predicate})

    def clear_passthrough(self, predicate: str) -> "RoutingBatch":
        """Lift ``predicate``'s conservative flag after re-verification
        (core/faults.py ReverifyQueue): the caller has ACTUALLY evaluated
        the predicate on these rows and will apply the real filter —
        ``visited`` is untouched, only the audit flag drops."""
        return replace(self, passthrough=self.passthrough - {predicate})

    def filter(self, mask: np.ndarray) -> "RoutingBatch":
        """Eager materialization: keep only rows where mask is True."""
        mask = np.asarray(mask, bool)
        assert mask.shape[0] == self.rows, (mask.shape, self.rows)
        data = {k: v[mask] for k, v in self.data.items()}
        return replace(self, data=data, row_ids=self.row_ids[mask])

    def column(self, name: str) -> np.ndarray:
        return self.data[name]

    def unvisited(self, predicates) -> list:
        return [p for p in predicates if p.name not in self.visited]

    def done(self, predicates) -> bool:
        return all(p.name in self.visited for p in predicates) or self.empty


def make_batch(data: Dict[str, np.ndarray], row_ids: Optional[np.ndarray] = None,
               **kw) -> RoutingBatch:
    rows = len(next(iter(data.values())))
    if row_ids is None:
        row_ids = np.arange(rows)
    return RoutingBatch(data=data, row_ids=np.asarray(row_ids), **kw)


# ------------------------- micro-batch coalescing ------------------------- #
@dataclass(frozen=True)
class BatchSegment:
    """One original batch's row span ``[start, stop)`` inside a fused batch.

    Holding the original ``RoutingBatch`` (not copies of its fields) is what
    makes ``split_back`` trivially bit-exact: the output is produced by
    ``batch.filter`` on the ORIGINAL object, so bid, visited set, warmup
    flag, and created_at are preserved by construction."""

    batch: RoutingBatch
    start: int
    stop: int

    @property
    def rows(self) -> int:
        return self.stop - self.start


def concat(batches: Sequence[RoutingBatch]) -> Tuple[RoutingBatch, List[BatchSegment]]:
    """Fuse ``batches`` into ONE transient batch for a single evaluation.

    Column-wise ``np.concatenate`` over identical schemas; returns the
    fused batch plus the per-batch segment boundaries for ``split_back``.
    Metadata of the fused batch is the conservative combination: visited =
    intersection (a predicate is "already evaluated" only if EVERY fused
    batch evaluated it), ``sim_ready`` = max (the fused launch cannot start
    before its last constituent arrived), ``warmup`` only if all are
    warmup, ``created_at`` = earliest.  A single-batch input is returned
    as-is (no copy)."""
    if not batches:
        raise ValueError("concat needs at least one batch")
    if len(batches) == 1:
        b = batches[0]
        return b, [BatchSegment(b, 0, b.rows)]
    cols = set(batches[0].data)
    for b in batches[1:]:
        if set(b.data) != cols:
            raise ValueError(
                f"cannot fuse batches with different schemas: "
                f"{sorted(cols)} vs {sorted(b.data)}"
            )
    data = {
        k: np.concatenate([b.data[k] for b in batches]) for k in batches[0].data
    }
    row_ids = np.concatenate([np.asarray(b.row_ids) for b in batches])
    fused = RoutingBatch(
        data=data,
        row_ids=row_ids,
        visited=frozenset.intersection(*[frozenset(b.visited) for b in batches]),
        warmup=all(b.warmup for b in batches),
        created_at=min(b.created_at for b in batches),
        sim_ready=max(b.sim_ready for b in batches),
    )
    segments, off = [], 0
    for b in batches:
        segments.append(BatchSegment(b, off, off + b.rows))
        off += b.rows
    return fused, segments


def split_back(
    segments: Sequence[BatchSegment],
    mask: np.ndarray,
    *,
    visit: Optional[str] = None,
    sim_ready: Optional[float] = None,
) -> List[RoutingBatch]:
    """Split a fused evaluation's row mask back into per-bid output batches.

    ``mask`` is the fused batch's boolean keep-mask (pre-filter row count);
    each segment's slice is applied to its ORIGINAL batch, then optionally
    marked ``visit``-ed and stamped with the fused launch's ``sim_ready``
    (the per-segment virtual finish under SimClock is the SHARED fused
    finish — one launch term, summed row terms).  Output order matches the
    segment (dequeue) order, so circulation order is preserved."""
    mask = np.asarray(mask, bool)
    total = segments[-1].stop if segments else 0
    if mask.shape[0] != total:
        raise ValueError(f"mask has {mask.shape[0]} rows, segments cover {total}")
    outs = []
    for seg in segments:
        out = seg.batch.filter(mask[seg.start:seg.stop])
        if visit is not None:
            out = out.mark_visited(visit)
        if sim_ready is not None:
            out = replace(out, sim_ready=sim_ready)
        outs.append(out)
    return outs
