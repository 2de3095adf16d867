"""The port's on-device short-circuit filter (``core/vectorized.py``) and
its quickstart and UC2 + UC3 (warehouse-safety) examples, against the JAX
package on the CPU.

The same numpy rows go through ``repro.core.vectorized`` (jitted) and
``repro_torch.core.vectorized``: ``compact_indices``' padded indices,
``two_stage_filter`` and ``cascade_filter``'s masks (exact, at any
selectivity and bucket fraction), the rows the expensive predicate sees,
and a cascade over the triage query's router and SSD predicates' kernel
wrappers against their whole-table mask. The examples return the JAX
examples' rows: quickstart's matches, and Q3's unsafe frames under the
cost-driven and reuse-aware policies (with cache hits and HSV launches on
the board). JAX is imported inside fixtures.
"""
import importlib.util
import math
import os
import runpy
import types

import numpy as np
import pytest
import torch

from repro_torch.core import vectorized as vec
from repro_torch.examples import quickstart
from repro_torch.examples import warehouse_safety as ws

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from repro.core import vectorized as jax_vec
    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, vec=jax_vec)


def _jax_mask(jx, fn, x):
    return np.asarray(jx.jax.jit(fn)(jx.jnp.asarray(x)))


def test_compact_indices(jx):
    mask = np.asarray([True, False, True, True, False])
    for bucket, want in ((3, [0, 2, 3]), (5, [0, 2, 3, 5, 5])):
        got = vec.compact_indices(torch.from_numpy(mask), bucket)
        np.testing.assert_array_equal(got.numpy(), want)   # sentinel pad
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            jx.vec.compact_indices(jx.jnp.asarray(mask), bucket)))


def _two_stage_fns(thresh_a, thresh_b):
    def cheap(v):
        return v.sum(-1) > thresh_a

    def expensive(v):
        return (v * v).sum(-1) - 4.0 > thresh_b

    return cheap, expensive


@pytest.mark.parametrize("thresh_a,thresh_b", [
    (-2.0, 0.0), (0.0, 0.5), (1.0, -1.0), (2.5, 2.5),
])
@pytest.mark.parametrize("frac", [0.25, 0.5, 1.0])
def test_two_stage_exact(jx, rng, thresh_a, thresh_b, frac):
    x = rng.standard_normal((64, 4)).astype(np.float32)
    cheap, expensive = _two_stage_fns(thresh_a, thresh_b)
    naive = cheap(x) & expensive(x)
    got = vec.two_stage_filter(cheap, expensive, torch.from_numpy(x),
                               bucket_fraction=frac)
    want = _jax_mask(jx, lambda xx: jx.vec.two_stage_filter(
        cheap, expensive, xx, bucket_fraction=frac), x)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), naive)
    np.testing.assert_array_equal(got.numpy(), want)


CASCADE_FNS = [
    lambda v: v.sum(-1) > -1.0,
    lambda v: v[:, 0] > 0.0,
    lambda v: (v * v).sum(-1) > 2.0,
]


def test_cascade_exact(jx, rng):
    x = rng.standard_normal((128, 4)).astype(np.float32)
    naive = CASCADE_FNS[0](x) & CASCADE_FNS[1](x) & CASCADE_FNS[2](x)
    got = vec.cascade_filter(CASCADE_FNS, torch.from_numpy(x))
    want = _jax_mask(jx, lambda xx: jx.vec.cascade_filter(CASCADE_FNS, xx), x)
    np.testing.assert_array_equal(got.numpy(), naive)
    np.testing.assert_array_equal(got.numpy(), want)


def test_two_stage_evaluates_fewer_rows(rng):
    """The expensive fn sees ceil(survivors / bucket) buckets of 16 rows,
    at most two here, not all 64 (the reference counts its one trace of
    the loop's body; the port, running eagerly, counts every pass)."""
    calls = []
    x = torch.from_numpy(rng.standard_normal((64, 4)).astype(np.float32))

    def cheap(v):
        return v.sum(-1) > 1.5   # very selective

    def expensive(v):
        calls.append(v.shape[0])
        return (v * v).sum(-1) > 0.0

    vec.two_stage_filter(cheap, expensive, x, bucket_fraction=0.25)
    survivors = int(cheap(x).sum())
    assert calls == [16] * math.ceil(survivors / 16)
    assert sum(calls) <= 2 * 16


@pytest.mark.parametrize("frac", [0.25, 1.0])
@pytest.mark.parametrize("selectivity", [0.0, 0.5, 1.0])
def test_exact_mask_at_any_selectivity(jx, rng, selectivity, frac):
    """The cheap predicate passes no row, half of them (by rank) and every
    row: the mask is the naive AND and the JAX package's, and the
    expensive predicate sees no bucket when nothing survives."""
    x = rng.standard_normal((96, 4)).astype(np.float32)
    s = x.sum(-1)
    thresh = {0.0: s.max() + 1.0, 0.5: float(np.median(s)),
              1.0: s.min() - 1.0}[selectivity]
    seen = []

    def cheap(v):
        return v.sum(-1) > thresh

    def expensive(v):
        if isinstance(v, torch.Tensor):
            seen.append(v.shape[0])
        return v[:, 1] > 0.0

    naive = cheap(x) & expensive(x)
    got = vec.two_stage_filter(cheap, expensive, torch.from_numpy(x),
                               bucket_fraction=frac)
    want = _jax_mask(jx, lambda xx: jx.vec.two_stage_filter(
        cheap, expensive, xx, bucket_fraction=frac), x)
    np.testing.assert_array_equal(got.numpy(), naive)
    np.testing.assert_array_equal(got.numpy(), want)
    survivors = int(cheap(x).sum())
    assert survivors == round(selectivity * 96)
    assert len(seen) == math.ceil(survivors / max(1, int(96 * frac)))


def test_cascade_over_the_triage_predicates():
    """The triage query's router (expert 0) and SSD scorer (> 0) through
    their wrappers, as a cascade over the kept rows' token ids: the SSD
    scan runs on compacted buckets (with the zero sentinel row, whose dt
    is 0) and the mask equals the whole-table mask."""
    from repro_torch.data.text import make_reviews
    from repro_torch.examples.review_triage import review_table
    from repro_torch.kernels import moe_router, ssd
    from repro_torch.udfs import library as lib
    table = review_table(make_reviews(400, seed=0))
    kept = table["tokens"][table["rating"] <= 2]
    dev = torch.device("cpu")
    toks = lib.token_ids(kept, 64, 256, dev)
    emb, w_gate = lib.router_tables(device=dev)
    tables = lib.ssd_tables(device=dev)

    def routed(t):
        return moe_router.moe_router_tokens(t, emb, w_gate, 2)[1][:, 0] == 0

    def scored(t):
        y, _ = ssd.ssd_bshp(*lib.ssd_inputs(tables, t), chunk=64)
        return lib.row_mean(y) > 0

    whole = routed(toks) & scored(toks)
    got = vec.cascade_filter([routed, scored], toks)
    assert 0 < int(whole.sum()) < len(kept)
    assert torch.equal(got, whole)


# --------------------------------------------------------------------------- #
# the examples                                                                #
# --------------------------------------------------------------------------- #
def test_quickstart_matches_the_jax_example(jx, capsys):
    want = runpy.run_path(os.path.join(ROOT, "examples", "quickstart.py"))
    got = quickstart.main(["--device", "cpu"])
    assert got["matched"] == want["matched"]
    assert got["matched"] and "matched" in capsys.readouterr().out


def _jax_warehouse_rows(n: int) -> dict:
    """The JAX example's Q3 rows under each policy: its own frame source
    and planted labels, its detectors on the HSV kernel's XLA path."""
    import repro.core as jax_core
    import repro.udfs as jax_udfs
    spec = importlib.util.spec_from_file_location(
        "jax_warehouse_safety",
        os.path.join(ROOT, "examples", "warehouse_safety.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    rng = np.random.default_rng(1)
    person = rng.random(n) < 0.5
    nohat = rng.random(n) < 0.3
    p_obj = jax_udfs.planted_detector("person", person, work_dim=96,
                                      impl="xla")
    p_hat = jax_udfs.planted_detector("no_hardhat", nohat, work_dim=96,
                                      impl="xla")
    out = {}
    for label, policy in (("cost-driven", jax_core.CostDriven()),
                          ("reuse-aware", jax_core.ReuseAware())):
        cache = jax_core.ReuseCache()
        seg = n // 4
        for udf, lo, hi in ((p_obj.udf, 0, 2 * seg), (p_hat.udf, 2 * seg, n)):
            rid = np.arange(lo, hi)
            cache.put(udf.name, rid, udf({"frame": np.zeros(
                (len(rid), 96, 96, 3), np.float32), "rid": rid}))
        ex = jax_core.AQPExecutor([p_obj, p_hat], policy=policy, cache=cache,
                                  max_workers=8, cost_alpha=0.05)
        out[label] = {int(i) for b in ex.run(iter(example.frame_batches(n)))
                      for i in b.row_ids}
    return out


def test_warehouse_safety_matches_the_jax_example(jx):
    n = 80
    got = ws.main(["--device", "cpu", "--frames", str(n)])
    want = _jax_warehouse_rows(n)
    for label in ("cost-driven", "reuse-aware"):
        assert got[label]["rows"] == want[label] == got["expect"], label
        snap = got[label]["stats"]
        assert snap["hsv_color"]["batches"] > 0   # launches on the board
    assert got["reuse-aware"]["stats"]["person"]["cache_hit_rate"] > 0
    assert got["expect"]
