"""Review triage: a multi-kernel text pipeline through AQP routing, on the card.

SELECT * FROM reviews
WHERE MoERouter(tokens) = expert_0          -- fused top-k gating kernel
  AND SSDScorer(tokens) > 0                 -- Mamba-2 SSD scan kernel
  AND rating <= 2;                          -- trivial, pushed to scan

Both UDF predicates come from ``repro_torch.udfs``: the router gates
mean-pooled token embeddings through the hand-written moe_router kernel;
the scorer runs the SSD state-space scan kernel over the token sequence.
The executor registers launch-timing hooks for the duration of the run, so
the routing statistics show per-kernel launch cost ("moe_router", "ssd")
next to the predicate-level stats the eddy policy ranks on. The two
predicates hold the arbiter labels "cuda:0" and "cuda:1" (the JAX
package's "tpu:0" and "tpu:1"); both run on the one card ``--device``
names. --device cpu runs the plain versions.

  PYTHONPATH=src python -m repro_torch.examples.review_triage --device cuda --policy cost
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Iterator, List, Sequence

import numpy as np

from repro_torch import udfs
from repro_torch.core import Predicate, Query, TrivialPredicate, optimize
from repro_torch.core.policies import EDDY_POLICIES
from repro_torch.data.text import Review, make_reviews

SEQ = 64


def review_table(reviews: Sequence[Review], seq: int = SEQ) -> Dict[str, np.ndarray]:
    """The reviews as columns: ``tokens`` (N, seq) int32, truncated or
    zero-padded, ``rating`` and ``_row_id`` (the review id)."""
    toks = np.zeros((len(reviews), seq), np.int32)
    for j, r in enumerate(reviews):
        toks[j, : min(len(r.tokens), seq)] = r.tokens[:seq]
    return {
        "tokens": toks,
        "rating": np.array([r.rating for r in reviews], np.int32),
        "_row_id": np.array([r.rid for r in reviews], np.int64),
    }


def source(table: Dict[str, np.ndarray], chunk: int = 32) -> Iterator[dict]:
    """The table in ``chunk``-row pieces, as a scan would emit them."""
    n = len(table["_row_id"])
    for i in range(0, n, chunk):
        yield {k: v[i:i + chunk] for k, v in table.items()}


def triage_predicates(*, expert: int = 0, device="cuda") -> List[Predicate]:
    """MoERouter(tokens) = expert and SSDScorer(tokens) > 0."""
    p_topic = udfs.topic_router_predicate(
        expert, n_experts=8, seq=SEQ, device=device, resource="cuda:0",
        name="MoERouter",
    )
    p_score = udfs.ssd_scorer_predicate(
        0.0, seq=SEQ, device=device, resource="cuda:1", name="SSDScorer",
    )
    return [p_topic, p_score]


def build_plan(table, *, policy: str = "hydro", device="cuda",
               expert: int = 0, max_rating: int = 2, max_workers: int = 4):
    """The review-triage query over ``table`` as an adaptive plan."""
    q = Query(
        source=source(table),
        predicates=triage_predicates(expert=expert, device=device),
        trivial=[TrivialPredicate("rating", "<=", max_rating)],
    )
    return q, optimize(q, executor_kwargs=dict(
        policy=EDDY_POLICIES[policy](), max_workers=max_workers,
    ))


def oracle_ids(table, predicates: Sequence[Predicate], *,
               max_rating: int = 2) -> set:
    """The conjunction evaluated once over every kept row: the predicates
    are pure functions of ``tokens``."""
    kept = table["rating"] <= max_rating
    toks = table["tokens"][kept]
    mask = np.ones(len(toks), bool)
    for p in predicates:
        mask &= p.mask_from_outputs(p.udf({"tokens": toks}))
    return set(table["_row_id"][kept][mask].tolist())


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reviews", type=int, default=300)
    ap.add_argument("--policy", default="hydro", choices=sorted(EDDY_POLICIES))
    ap.add_argument("--expert", type=int, default=0)
    ap.add_argument("--max-rating", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    table = review_table(make_reviews(args.reviews))
    q, plan = build_plan(table, policy=args.policy, device=args.device,
                         expert=args.expert, max_rating=args.max_rating)
    print("plan:", " -> ".join(plan.description))
    t0 = time.perf_counter()
    rows = plan.collect_rows()
    dt = time.perf_counter() - t0

    matched = rows["_row_id"].tolist()
    print(f"\ntriaged {len(matched)} low-rated expert-{args.expert} reviews "
          f"in {dt:.2f}s on {args.device}")

    expect = oracle_ids(table, q.predicates, max_rating=args.max_rating)
    if set(matched) != expect:
        raise AssertionError("AQP result must equal oracle filter")
    print("result equals oracle conjunctive evaluation ✓")

    snap = plan.executor.stats_snapshot()
    print("\npredicate routing statistics:")
    for name in ("MoERouter", "SSDScorer"):
        s = snap[name]
        print(f"  {name}: cost/row={s['cost_per_row']*1e3:.2f}ms "
              f"selectivity={s['selectivity']:.3f} score={s['score']*1e3:.2f}")
    print("per-kernel launch cost (launch hooks -> same StatsBoard):")
    for name in ("moe_router", "ssd"):
        if name in snap:
            s = snap[name]
            print(f"  {name}: cost/row={s['cost_per_row']*1e3:.3f}ms "
                  f"launches={int(s['batches'])}")


if __name__ == "__main__":
    main()
