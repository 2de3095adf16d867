"""The review-triage query (MoERouter(tokens) = expert_0 AND SSDScorer(tokens)
> 0 AND rating <= 2) through the port on the CPU, against the JAX
package's executor on the same reviews: the same row ids under every eddy
policy, equal to the port's own whole-table oracle, with launches of both
text kernels on the StatsBoard."""
import numpy as np
import pytest
import torch

import repro.core as jax_core
import repro.udfs as jax_udfs
from repro.core.policies import EDDY_POLICIES
from repro_torch.examples import review_triage as example

# small tensors: one intra-op thread, so these tests do not crowd the
# timing-sensitive executor tests running beside them
torch.set_num_threads(1)

REVIEWS = 300


@pytest.fixture(scope="module")
def table():
    from repro_torch.data.text import make_reviews
    return example.review_table(make_reviews(REVIEWS))


def _jax_rows(table, policy: str) -> set:
    """The JAX package's triage query, as examples/review_triage.py builds
    it, with both predicates on their XLA reference path."""
    p_topic = jax_udfs.topic_router_predicate(
        0, n_experts=8, seq=example.SEQ, impl="xla", resource="tpu:0",
        name="MoERouter")
    p_score = jax_udfs.ssd_scorer_predicate(
        0.0, seq=example.SEQ, impl="xla", resource="tpu:1", name="SSDScorer")
    q = jax_core.Query(
        source=example.source(table), predicates=[p_topic, p_score],
        trivial=[jax_core.TrivialPredicate("rating", "<=", 2)])
    plan = jax_core.optimize(q, executor_kwargs=dict(
        policy=EDDY_POLICIES[policy](), max_workers=2))
    return set(plan.collect_rows()["_row_id"].tolist())


@pytest.mark.parametrize("policy", sorted(EDDY_POLICIES))
def test_port_query_returns_the_reference_rows(table, policy):
    q, plan = example.build_plan(table, policy=policy, device="cpu",
                                 max_workers=2)
    got = set(plan.collect_rows()["_row_id"].tolist())
    assert got == _jax_rows(table, policy)
    assert got == example.oracle_ids(table, q.predicates)
    assert len(got) == 13  # examples/review_triage.py --reviews 300 triages 13
    snap = plan.executor.stats_snapshot()
    assert snap["moe_router"]["batches"] > 0
    assert snap["ssd"]["batches"] > 0


def test_review_table_matches_the_reference_source(table):
    """The port's table holds what the JAX example's source yields."""
    from repro.data.text import make_reviews
    reviews = make_reviews(REVIEWS)
    assert table["_row_id"].tolist() == [r.rid for r in reviews]
    assert table["rating"].tolist() == [r.rating for r in reviews]
    for row, r in zip(table["tokens"], reviews):
        n = min(len(r.tokens), example.SEQ)
        np.testing.assert_array_equal(row[:n], r.tokens[:n])
        assert not row[n:].any()


def test_arbiter_labels_name_two_cards(table):
    preds = example.triage_predicates(device="cpu")
    assert [p.resource for p in preds] == ["cuda:0", "cuda:1"]
    assert [p.name for p in preds] == ["MoERouter", "SSDScorer"]


def test_main_on_the_cpu_passes_its_oracle(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", ["review_triage", "--device", "cpu",
                                     "--reviews", str(REVIEWS),
                                     "--policy", "cost"])
    example.main()
    out = capsys.readouterr().out
    assert "triaged 13 low-rated expert-0 reviews" in out
    assert "result equals oracle conjunctive evaluation" in out
    assert "moe_router: cost/row=" in out and "ssd: cost/row=" in out
