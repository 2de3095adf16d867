"""The port's serving layer (``repro_torch.launch.serve``) against the JAX
package's (``repro.launch.serve``).

* the module is the reference's with only its imports rewritten, but for
  ``build_llm_udf`` and ``main``, written for torch (held to the
  reference by tests/test_torch_llm_serve.py);
* the planted-predicate scenarios of tests/test_serve.py run through both
  packages on the same data: exact per-tenant multisets, admission,
  priority order, deadline expiry, cancel, same-name serialisation, live
  priors and no board leakage;
* the slice as a whole: the review-triage, attention and decode tenants
  served at once on the CPU return the JAX package's rows.

Service threads keep their ``svc-`` names, so the leaked-thread guard of
tests/conftest.py covers the port's too.
"""
import ast
import os
import re
import time
import types
from collections import Counter

import numpy as np
import pytest
import torch

import repro.core as jax_core
import repro.core.statstore as jax_statstore
import repro.launch.serve as jax_serve
import repro_torch.core as port_core
import repro_torch.core.statstore as port_statstore
import repro_torch.launch.serve as port_serve

# small tensors: one intra-op thread, so these tests do not crowd the
# timing-sensitive executor tests running beside them
torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
PACKAGES = {
    "repro": types.SimpleNamespace(core=jax_core, serve=jax_serve,
                                   statstore=jax_statstore),
    "repro_torch": types.SimpleNamespace(core=port_core, serve=port_serve,
                                         statstore=port_statstore),
}
_EXEC_KW = dict(max_workers=2, warmup=False)


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


# --------------------------------------------------------------------------- #
# the module                                                                  #
# --------------------------------------------------------------------------- #
def _statements(path: str, drop=()) -> list:
    """The module's top-level statements as AST dumps, less its docstring
    and the statements named in ``drop`` (functions, imports, __main__)."""
    body = ast.parse(open(path).read()).body[1:]

    def name(node):
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            return node.name
        if isinstance(node, ast.Import):
            return node.names[0].name
        if isinstance(node, ast.If):
            return "__main__"
        return None

    return [ast.dump(n) for n in body if name(n) not in drop]


def test_serve_is_the_reference_with_imports_rewritten(tmp_path):
    ref = open(os.path.join(SRC, "repro", "launch", "serve.py")).read()
    rewritten = tmp_path / "serve.py"
    rewritten.write_text(re.sub(r"^(\s*)(from|import) repro\.",
                                r"\1\2 repro_torch.", ref, flags=re.M))
    # build_llm_udf and main are written for torch (a decoder forward on
    # the card); tests/test_torch_llm_serve.py holds them to the reference
    hand_written = ("build_llm_udf", "main")
    want = _statements(str(rewritten), drop=hand_written)
    got = _statements(os.path.join(SRC, "repro_torch", "launch", "serve.py"),
                      drop=hand_written)
    assert got == want
    doc = ast.get_docstring(ast.parse(open(port_serve.__file__).read()))
    assert "build_llm_udf" in doc and "main" in doc
    assert callable(port_serve.build_llm_udf) and callable(port_serve.main)


def test_review_source_matches_the_reference():
    from repro.data.text import make_reviews as jax_reviews
    from repro_torch.data.text import make_reviews
    got = list(port_serve.review_source(make_reviews(150), chunk=64))
    want = list(jax_serve.review_source(jax_reviews(150), chunk=64))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].dtype == b[k].dtype
    assert got[0]["tokens"].shape == (64, port_serve.MAX_LEN)


# --------------------------------------------------------------------------- #
# the planted-predicate scenarios of tests/test_serve.py, in both packages    #
# --------------------------------------------------------------------------- #
def _pred(core, name, *, keep_mod=2, sleep=0.0, fingerprint=None):
    """Keeps rows whose id is NOT divisible by ``keep_mod``."""

    def fn(d):
        if sleep:
            time.sleep(sleep)
        return d["x"].astype(np.int64) % keep_mod != 0

    udf = core.UDF(name + "_udf", fn=fn, columns=("x",), bucket=False,
                   fingerprint=fingerprint)
    return core.Predicate(name, udf, compare=lambda o: o.astype(bool))


def _batches(core, ids, per=8):
    ids = np.asarray(ids, np.int64)
    return [core.make_batch({"x": ids[i:i + per].astype(np.float64)},
                            ids[i:i + per])
            for i in range(0, len(ids), per)]


def _expected(ids, keep_mod):
    return Counter(int(i) for i in ids if i % keep_mod != 0)


def _blocker(pkg, svc, name="blk", batches=6, sleep=0.05):
    """Submit a slow query and wait until it is RUNNING."""
    ids = np.arange(batches * 8)
    h = svc.submit([_pred(pkg.core, name, sleep=sleep)],
                   iter(_batches(pkg.core, ids)), **_EXEC_KW)
    deadline = time.monotonic() + 10
    while h.state == "PENDING" and time.monotonic() < deadline:
        time.sleep(0.005)
    assert h.state == "RUNNING"
    return h


def _tenants(pkg):
    """Four queries in flight on one shared arbiter; per tenant (name,
    report)."""
    specs = [(f"t{i}m{m}", m, np.arange(i * 1000, i * 1000 + 96))
             for i, m in enumerate((2, 3, 5, 7))]
    with pkg.serve.QueryService(max_concurrent=4, max_pending=8) as svc:
        handles = [(name, m, ids, svc.submit(
            [_pred(pkg.core, name, keep_mod=m)], iter(_batches(pkg.core, ids)),
            **_EXEC_KW)) for name, m, ids in specs]
        return [(name, m, ids, h.result(timeout=60))
                for name, m, ids, h in handles]


def test_concurrent_tenants_give_the_reference_multisets_and_no_leakage():
    by_pkg = {}
    for label, pkg in PACKAGES.items():
        reports = _tenants(pkg)
        for name, m, ids, rep in reports:
            assert rep.state == "DONE"
            assert rep.board_predicates == (name,), rep.board_predicates
            assert Counter(map(int, rep.row_ids)) == _expected(ids, m)
        by_pkg[label] = {name: Counter(map(int, rep.row_ids))
                         for name, _, _, rep in reports}
    assert by_pkg["repro_torch"] == by_pkg["repro"]


def test_submit_and_result_exact_multiset(pkg):
    ids = np.arange(64)
    with pkg.serve.QueryService(max_concurrent=2) as svc:
        h = svc.submit([_pred(pkg.core, "p0", keep_mod=3)],
                       iter(_batches(pkg.core, ids)), **_EXEC_KW)
        rep = h.result(timeout=30)
        snap = svc.snapshot()
    assert isinstance(rep, pkg.serve.QueryReport)
    assert isinstance(h, pkg.serve.QueryHandle)
    assert rep.state == pkg.serve.DONE and h.done()
    assert Counter(map(int, rep.row_ids)) == _expected(ids, 3)
    assert rep.rows == sum(_expected(ids, 3).values())
    assert rep.batches == len(h.output)
    assert rep.queue_time_s >= 0 and rep.eval_time_s > 0
    assert rep.deadline_met is None
    assert rep.board_predicates == ("p0",)
    assert rep.routing and rep.reverify is None
    assert snap["submitted"] == 1 and snap["completed"] == 1
    assert "rebalances" in snap["arbiter"]


def test_failed_query_raises_and_keeps_report(pkg):
    def boom(d):
        raise ValueError("kaboom")

    udf = pkg.core.UDF("b_udf", fn=boom, columns=("x",), bucket=False)
    bad = pkg.core.Predicate("pb", udf, compare=lambda o: o.astype(bool))
    with pkg.serve.QueryService(max_concurrent=1) as svc:
        h = svc.submit([bad], iter(_batches(pkg.core, np.arange(8))),
                       **_EXEC_KW)
        with pytest.raises(RuntimeError, match="kaboom"):
            h.result(timeout=30)
    assert h.report.state == pkg.serve.FAILED
    assert svc.snapshot()["failed"] == 1


def test_admission_rejects_when_pending_full(pkg):
    with pkg.serve.QueryService(max_concurrent=1, max_pending=1) as svc:
        blk = _blocker(pkg, svc)
        q2 = svc.submit([_pred(pkg.core, "p2")],
                        iter(_batches(pkg.core, np.arange(8))), **_EXEC_KW)
        with pytest.raises(pkg.serve.AdmissionError, match="pending queue full"):
            svc.submit([_pred(pkg.core, "p3")],
                       iter(_batches(pkg.core, np.arange(8))), **_EXEC_KW)
        assert svc.snapshot()["rejected"] == 1
        assert blk.result(timeout=30).state == "DONE"
        assert q2.result(timeout=30).state == "DONE"
    with pytest.raises(pkg.serve.AdmissionError, match="closed"):
        svc.submit([_pred(pkg.core, "p4")],
                   iter(_batches(pkg.core, np.arange(8))), **_EXEC_KW)


def test_priority_orders_pending_dispatch(pkg):
    with pkg.serve.QueryService(max_concurrent=1, max_pending=8) as svc:
        blk = _blocker(pkg, svc)
        lo = svc.submit([_pred(pkg.core, "lo")],
                        iter(_batches(pkg.core, np.arange(8))),
                        priority=1.0, **_EXEC_KW)
        hi = svc.submit([_pred(pkg.core, "hi")],
                        iter(_batches(pkg.core, np.arange(8))),
                        priority=5.0, **_EXEC_KW)
        blk.result(timeout=30)
        lo_rep, hi_rep = lo.result(timeout=30), hi.result(timeout=30)
    assert hi_rep.started_at < lo_rep.started_at


def test_pending_query_expires_and_deadline_met_is_recorded(pkg):
    with pkg.serve.QueryService(max_concurrent=1, max_pending=8) as svc:
        blk = _blocker(pkg, svc, batches=8)
        doomed = svc.submit([_pred(pkg.core, "dd")],
                            iter(_batches(pkg.core, np.arange(8))),
                            deadline_s=0.05, **_EXEC_KW)
        rep = doomed.result(timeout=10)
        assert rep.state == pkg.serve.EXPIRED
        assert rep.deadline_met is False
        assert rep.started_at is None and rep.rows == 0
        assert svc.snapshot()["expired"] == 1
        blk.result(timeout=30)
        ok = svc.submit([_pred(pkg.core, "p0")],
                        iter(_batches(pkg.core, np.arange(16))),
                        deadline_s=60.0, **_EXEC_KW)
        assert ok.result(timeout=30).deadline_met is True


def test_cancel_pending_and_running(pkg):
    with pkg.serve.QueryService(max_concurrent=1, max_pending=8) as svc:
        blk = _blocker(pkg, svc, batches=10)
        pend = svc.submit([_pred(pkg.core, "pc")],
                          iter(_batches(pkg.core, np.arange(8))), **_EXEC_KW)
        assert pend.cancel()
        assert pend.result(timeout=10).state == pkg.serve.CANCELLED
        assert blk.cancel()
        rep = blk.result(timeout=30)
        assert rep.state == pkg.serve.CANCELLED
        assert rep.batches < 10
        assert svc.snapshot()["cancelled"] == 2
    assert not blk.cancel()


def test_same_predicate_name_serialized_not_crosswired(pkg):
    """Arbiter registrations are name-keyed: two queries sharing a
    predicate NAME run one after the other, both correctly (the
    reference's behaviour, kept)."""
    ids_a, ids_b = np.arange(32), np.arange(100, 132)
    with pkg.serve.QueryService(max_concurrent=2) as svc:
        h1 = svc.submit([_pred(pkg.core, "shared", sleep=0.02)],
                        iter(_batches(pkg.core, ids_a)), **_EXEC_KW)
        h2 = svc.submit([_pred(pkg.core, "shared")],
                        iter(_batches(pkg.core, ids_b)), **_EXEC_KW)
        r1, r2 = h1.result(timeout=60), h2.result(timeout=60)
    assert r1.state == "DONE" and r2.state == "DONE"
    assert Counter(map(int, r1.row_ids)) == _expected(ids_a, 2)
    assert Counter(map(int, r2.row_ids)) == _expected(ids_b, 2)
    first, second = sorted((r1, r2), key=lambda r: r.started_at)
    assert second.started_at >= first.finished_at


def test_live_priors_flow_between_concurrent_queries(pkg):
    fp = "kernel|shared-probe|cmv=1"
    with pkg.serve.QueryService(max_concurrent=2) as svc:
        a = svc.submit([_pred(pkg.core, "qa", sleep=0.03, fingerprint=fp)],
                       iter(_batches(pkg.core, np.arange(80))), **_EXEC_KW)
        deadline = time.monotonic() + 10
        while a.report.batches < 2 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert a.report.batches >= 2
        b = svc.submit([_pred(pkg.core, "qb", fingerprint=fp)],
                       iter(_batches(pkg.core, np.arange(8))), **_EXEC_KW)
        b.result(timeout=30)
        assert svc.store.get(fp) is not None   # folded from A's LIVE board
        a.result(timeout=60)
    assert svc.store.get(fp)["cost_per_row"] > 0
    p = _pred(pkg.core, "p0")
    with pkg.serve.QueryService(max_concurrent=1) as svc:
        svc.submit([p], iter(_batches(pkg.core, np.arange(32))),
                   **_EXEC_KW).result(timeout=30)
        assert svc.store.get(pkg.statstore.fingerprint_of(p)) is not None


# --------------------------------------------------------------------------- #
# the slice as a whole: three kernel tenants at once                          #
# --------------------------------------------------------------------------- #
REVIEWS = 300


def _kernel_tenants(udfs, core, **device):
    """(predicates, policy) per tenant: the triage conjunction, the
    attention scorer and the decode relevance, each with ``rating <= 2``."""
    triage = [
        udfs.topic_router_predicate(0, n_experts=8, seq=64, name="MoERouter",
                                    **device),
        udfs.ssd_scorer_predicate(0.0, seq=64, name="SSDScorer", **device),
    ]
    return {
        "triage": (triage, "hydro"),
        "attention": ([udfs.attention_scorer_predicate(**device)], "cost"),
        "decode": ([udfs.decode_relevance_predicate(**device)], "selectivity"),
    }


def _serve(pkg, tenants, reviews):
    from repro.core.policies import EDDY_POLICIES as JAX_POLICIES
    from repro_torch.core.policies import EDDY_POLICIES as PORT_POLICIES
    policies = JAX_POLICIES if pkg.core is jax_core else PORT_POLICIES
    out = {}
    with pkg.serve.QueryService(max_concurrent=3) as svc:
        handles = {}
        for name, (preds, policy) in tenants.items():
            q = pkg.core.Query(
                source=pkg.serve.review_source(reviews), predicates=preds,
                trivial=[pkg.core.TrivialPredicate("rating", "<=", 2)])
            handles[name] = svc.submit(
                preds, pkg.core.batches_of(q),
                policy=policies[policy](),
                laminar_policy_factory=pkg.core.policies.DataAware,
                max_workers=2)
        for name, h in handles.items():
            rep = h.result(timeout=120)
            assert rep.state == "DONE"
            out[name] = (set(map(int, rep.row_ids)), rep)
        assert svc.snapshot()["completed"] == 3
    return out


def test_three_kernel_tenants_return_the_reference_rows():
    from repro import udfs as jax_udfs
    from repro.data.text import make_reviews as jax_reviews
    from repro_torch import udfs
    from repro_torch.data.text import make_reviews
    from repro_torch.examples.review_triage import oracle_ids, review_table
    from repro_torch.kernels import decode_attention, flash_attention

    port_t = _kernel_tenants(udfs, port_core, device="cpu")
    before = (flash_attention.launches, decode_attention.launches)
    port = _serve(PACKAGES["repro_torch"], port_t, make_reviews(REVIEWS))
    jax = _serve(PACKAGES["repro"],
                 _kernel_tenants(jax_udfs, jax_core, impl="xla"),
                 jax_reviews(REVIEWS))
    assert (flash_attention.launches, decode_attention.launches) == before
    for name, (preds, _) in port_t.items():
        seq = 64 if name == "triage" else 32
        oracle = oracle_ids(review_table(make_reviews(REVIEWS), seq=seq),
                            preds, max_rating=2)
        rows, rep = port[name]
        assert rows == oracle == jax[name][0], name
        assert rep.board_predicates == tuple(sorted(
            [p.name for p in preds] + [
                {"triage": "moe_router", "attention": "flash_attention",
                 "decode": "decode_attention"}[name]]
            + (["ssd"] if name == "triage" else [])))
    assert all(rows for rows, _ in port.values())
