"""Logical query plan + rule-based optimization (§3.1).

Hydro's optimizer does only RULE-based work statically — predicate pushdown,
trivial (non-UDF) predicate ordering, cache/reuse wiring — and hands every
UDF-based conjunct to the AQP executor, whose routing replaces cost-based
static ordering. Mirrors the paper's EvaDB integration at the granularity
this repo needs: Scan -> Apply(UNNEST) -> [trivial filters] -> AQPFilter ->
Project.
"""
from __future__ import annotations

import operator
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np

from repro_torch.core.batch import RoutingBatch, make_batch
from repro_torch.core.cache import ReuseCache
from repro_torch.core.executor import AQPExecutor
from repro_torch.core.udf import Predicate

_OPS = {
    "<=": operator.le, "<": operator.lt, ">=": operator.ge, ">": operator.gt,
    "==": operator.eq, "!=": operator.ne,
}


@dataclass(frozen=True)
class TrivialPredicate:
    """Non-UDF conjunct, e.g. rating <= 1. Free to evaluate -> pushed down."""

    column: str
    op: str
    value: object

    def mask(self, data: Dict[str, np.ndarray]) -> np.ndarray:
        return np.asarray(_OPS[self.op](data[self.column], self.value), bool)


@dataclass
class Query:
    source: Iterable[Dict[str, np.ndarray]]     # scan (+ apply/UNNEST upstream)
    predicates: List[Predicate]                 # UDF-based conjuncts -> AQP
    trivial: List[TrivialPredicate] = field(default_factory=list)
    project: Optional[Sequence[str]] = None
    batch_rows: int = 10                        # paper's routing-batch size


@dataclass
class PhysicalPlan:
    query: Query
    executor: AQPExecutor
    description: List[str]

    def run(self) -> Iterator[RoutingBatch]:
        return self.executor.run(_batches(self.query))

    def collect_rows(self) -> Dict[str, np.ndarray]:
        cols: Dict[str, List[np.ndarray]] = {}
        ids: List[np.ndarray] = []
        keep = self.query.project
        for b in self.executor.run(_batches(self.query)):
            ids.append(b.row_ids)
            for k, v in b.data.items():
                if keep is None or k in keep:
                    cols.setdefault(k, []).append(v)
        out = {k: np.concatenate(v) if v else np.zeros((0,)) for k, v in cols.items()}
        out["_row_id"] = np.concatenate(ids) if ids else np.zeros((0,), np.int64)
        return out


def batches_of(q: Query) -> Iterator[RoutingBatch]:
    """Public scan path: the routing-batch stream for ``q`` (trivial
    pushdown + re-chunking).  The QueryService CLI (launch/serve.py)
    submits this stream directly so single-query and multi-tenant
    execution share one scan implementation."""
    return _batches(q)


def _batches(q: Query) -> Iterator[RoutingBatch]:
    """Scan -> trivial-filter pushdown -> routing batches (eager drop).

    Vectorized: surviving rows are selected with one boolean-mask slice per
    chunk and re-chunked into ``batch_rows``-sized batches by array
    slicing — no per-row Python loop. Batch boundaries are identical to
    the row-at-a-time formulation: rows flow in arrival order and every
    batch except the tail holds exactly ``batch_rows`` rows. Rows from
    chunks without a ``_row_id`` column get their position within the
    emitted batch as a synthesized id (the historical behavior; a source
    may even mix chunks with and without ids)."""
    per = q.batch_rows
    pend_cols: List[Dict[str, np.ndarray]] = []   # filtered chunk slices
    pend_ids: List[Optional[np.ndarray]] = []     # None = synthesize
    pending = 0

    def drain(cols_parts, id_parts, rows, final):
        """Concatenate pending slices; yield full batches (+ tail if final)."""
        data = {k: np.concatenate([p[k] for p in cols_parts])
                for k in cols_parts[0]}
        # Per-part ids: real _row_ids pass through; missing ones become
        # the row's position within its batch. Drains always start at a
        # batch boundary (the carry is < per and goes to the front), so
        # position-in-batch == running-offset % per.
        parts, off = [], 0
        for p, ids in zip(cols_parts, id_parts):
            n = len(next(iter(p.values()))) if p else (
                len(ids) if ids is not None else 0
            )
            parts.append(ids if ids is not None
                         else np.arange(off, off + n, dtype=np.int64) % per)
            off += n
        all_ids = np.concatenate(parts) if parts else np.zeros(0, np.int64)
        out = []
        n_full = rows // per
        for j in range(n_full):
            sl = slice(j * per, (j + 1) * per)
            out.append(make_batch({k: v[sl] for k, v in data.items()},
                                  all_ids[sl]))
        rem = rows - n_full * per
        if rem and final:
            out.append(make_batch(
                {k: v[n_full * per:] for k, v in data.items()},
                all_ids[n_full * per:]))
            rem = 0
        carry_cols = ([{k: v[n_full * per:] for k, v in data.items()}]
                      if rem else [])
        # the carry keeps its (already position-synthesized or real) ids:
        # it sits at position 0.. of the NEXT batch either way
        carry_ids = [all_ids[n_full * per:]] if rem else []
        return out, carry_cols, carry_ids, rem

    for chunk in q.source:
        rows = len(chunk["_row_id"]) if "_row_id" in chunk else len(
            next(iter(chunk.values()))
        )
        mask = np.ones(rows, bool)
        for tp in q.trivial:  # pushdown: trivial predicates run at scan time
            mask &= tp.mask(chunk)
        idx = np.nonzero(mask)[0]
        if not idx.size:
            continue
        pend_cols.append({k: np.asarray(v)[idx] for k, v in chunk.items()
                          if k != "_row_id"})
        pend_ids.append(np.asarray(chunk["_row_id"])[idx].astype(np.int64)
                        if "_row_id" in chunk else None)
        pending += idx.size
        if pending >= per:
            full, pend_cols, pend_ids, pending = drain(
                pend_cols, pend_ids, pending, final=False
            )
            yield from full
    if pending:
        tail, _, _, _ = drain(pend_cols, pend_ids, pending, final=True)
        yield from tail


def optimize(
    q: Query,
    *,
    cache: Optional[ReuseCache] = None,
    aqp: bool = True,
    executor_kwargs: Optional[dict] = None,
) -> PhysicalPlan:
    """Rule-based optimization -> physical plan.

    Rules applied (in order):
      1. TrivialPushdown — non-UDF conjuncts run at scan (lowest cost first;
         the paper's "trivial predicate reordering").
      2. CacheReuse — wire the reuse cache into UDF evaluation when present.
      3. AQPRule — wrap all UDF conjuncts into one AQP executor; disable
         warmup when only one predicate (nothing to reorder).
    """
    desc = []
    trivial = list(q.trivial)  # all trivially free: conjunction order as-is
    if trivial:
        desc.append(f"TrivialPushdown({[t.column + t.op + str(t.value) for t in trivial]})")
    if cache is not None:
        desc.append("CacheReuse(on)")
    kw = dict(executor_kwargs or {})
    if not aqp:
        kw.setdefault("warmup", False)
        from repro_torch.core.policies import EddyPolicy

        class _FixedOrder(EddyPolicy):
            name = "no-reordering"

            def rank(self, batch, preds, stats, cache):
                return preds  # conjunction order, left to right

        kw.setdefault("policy", _FixedOrder())
        desc.append("StaticPlan(no reordering)")
    else:
        desc.append("AQPRule(eddy+laminar)")
    executor = AQPExecutor(q.predicates, cache=cache, **kw)
    return PhysicalPlan(q, executor, desc)
