"""The port's text kernels (moe_router, ssd, rglru), their plain versions
and the text predicates against the JAX package.

The same numpy inputs, made from a seed, go through ``repro`` (the
reference) and ``repro_torch``. Plain versions are held to
``repro.kernels.ref`` at the shapes of the JAX package's
tests/test_kernels.py with ``TOL_TIGHT``, and to the Pallas kernels in
interpret mode at small shapes with the JAX suite's own tolerances.
Predicates are held to the JAX predicates on the XLA path at seq 16 and
64, and each test checks that the smallest decision margin in its data
exceeds the tolerance it allows, so a flipped decision cannot pass by
chance. Tests marked ``gpu`` run the CUDA kernels and skip without a card;
JAX is imported inside a fixture, so they also run on a card host that has
no JAX.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch import convert, udfs
from repro_torch.data import text as port_text
from repro_torch.kernels import launch, moe_router, ops, ref, rglru, ssd
from repro_torch.udfs import library as lib

# small tensors: one intra-op thread, so these tests do not crowd the
# timing-sensitive executor tests running beside them
torch.set_num_threads(1)

TOL_TIGHT = dict(rtol=1e-4, atol=1e-5)
SSD_PALLAS_TOL = dict(rtol=3e-2, atol=3e-2)  # tests/test_kernels.py::test_ssd
SCORE_ATOL = 1e-8   # SSD scores: port against reference
RGLRU_RTOL = 1e-3   # RG-LRU scores: relative (see the test)
PROB_ATOL = 1e-6    # router softmax probabilities: port against reference


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules the text tests compare against."""
    jnp = pytest.importorskip("jax.numpy")
    import jax.nn as jnn
    from repro import udfs as jax_udfs
    from repro.data import text as jax_text
    from repro.kernels import moe_router as jax_moe
    from repro.kernels import ops as jax_ops
    from repro.kernels import ref as jax_ref
    from repro.kernels import rglru as jax_rglru
    from repro.kernels import ssd as jax_ssd
    from repro.udfs import library as jax_lib

    return types.SimpleNamespace(
        jnp=jnp, nn=jnn, ref=jax_ref, ops=jax_ops, udfs=jax_udfs, lib=jax_lib,
        text=jax_text, moe=jax_moe, ssd=jax_ssd, rglru=jax_rglru)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def _tokens(n: int, seq: int, seed: int = 0) -> np.ndarray:
    reviews = port_text.make_reviews(n, seed=seed)
    toks = np.zeros((n, seq), np.int32)
    for j, r in enumerate(reviews):
        toks[j, : min(len(r.tokens), seq)] = r.tokens[:seq]
    return toks


def _ssd_inputs(rng, b, s, h, p, g, n, h0_scale=0.0):
    return (
        (rng.standard_normal((b, s, h, p)) * 0.5).astype(np.float32),
        rng.uniform(0.01, 0.2, (b, s, h)).astype(np.float32),
        (-rng.uniform(0.5, 2.0, (h,))).astype(np.float32),
        (rng.standard_normal((b, s, g, n)) * 0.3).astype(np.float32),
        (rng.standard_normal((b, s, g, n)) * 0.3).astype(np.float32),
        (rng.standard_normal((b, h, p, n)) * h0_scale).astype(np.float32),
    )


# --------------------------------------------------------------------------- #
# plain versions against the JAX reference (tests/test_kernels.py shapes)     #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("t,e,k", [(64, 8, 2), (128, 16, 2), (32, 4, 1)])
def test_router_plain_version_matches_reference(jx, rng, t, e, k):
    logits = rng.standard_normal((t, e)).astype(np.float32)
    jw, ji = jx.ref.moe_topk_router(jx.jnp.asarray(logits), k)
    w, idx = ref.moe_topk_router(_t(logits), k)
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_allclose(w.numpy(), _np(jw), **TOL_TIGHT)
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, rtol=1e-5)


def test_router_ties_keep_the_lowest_index(jx):
    logits = np.zeros((5, 8), np.float32)
    logits[1, [2, 5]] = 1.0
    logits[2, 3], logits[2, [1, 6]] = 2.0, 1.0
    logits[3, [0, 7]] = 3.0
    logits[4] = -5.0
    want = [[0, 1], [2, 5], [3, 1], [0, 7], [0, 1]]
    _, idx = ref.moe_topk_router(_t(logits), 2)
    assert idx.tolist() == want
    _, ji = jx.ref.moe_topk_router(jx.jnp.asarray(logits), 2)
    assert np.asarray(ji).tolist() == want


@pytest.mark.parametrize("b,s,w", [(1, 64, 64), (2, 128, 128), (2, 96, 256)])
def test_rglru_plain_version_matches_reference(jx, rng, b, s, w):
    x, r, i = (rng.standard_normal((b, s, w)).astype(np.float32)
               for _ in range(3))
    a = rng.standard_normal(w).astype(np.float32)
    h0 = rng.standard_normal((b, w)).astype(np.float32)
    jo, jh = jx.ref.rglru(*map(jx.jnp.asarray, (x, r, i, a, h0)))
    out, h_last = ref.rglru(*map(_t, (x, r, i, a, h0)))
    np.testing.assert_allclose(out.numpy(), _np(jo), **TOL_TIGHT)
    np.testing.assert_allclose(h_last.numpy(), _np(jh), **TOL_TIGHT)


def test_softplus_and_sigmoid_match_jax(jx):
    z = np.array([-90.0, -20.0, -1.5, -1e-3, 0.0, 1e-3, 0.7, 20.0, 90.0],
                 np.float32)
    np.testing.assert_allclose(ref.softplus(_t(z)).numpy(),
                               _np(jx.nn.softplus(jx.jnp.asarray(z))),
                               rtol=1e-6, atol=1e-30)  # XLA flushes denormals
    np.testing.assert_allclose(ref.sigmoid(_t(z)).numpy(),
                               _np(jx.nn.sigmoid(jx.jnp.asarray(z))),
                               rtol=1e-6, atol=1e-30)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [
    (1, 64, 2, 16, 1, 16, 16),
    (2, 128, 4, 32, 2, 16, 32),
    (1, 128, 4, 64, 1, 32, 64),
])
@pytest.mark.parametrize("h0_scale", [0.0, 1.0])
def test_ssd_plain_version_matches_reference(jx, rng, b, s, h, p, g, n, chunk,
                                             h0_scale):
    args = _ssd_inputs(rng, b, s, h, p, g, n, h0_scale)
    jy, jh = jx.ref.ssd(*map(jx.jnp.asarray, args), chunk=chunk)
    y, h_last = ref.ssd(*map(_t, args), chunk=chunk)
    assert h_last.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), _np(jy), **TOL_TIGHT)
    np.testing.assert_allclose(h_last.numpy(), _np(jh), **TOL_TIGHT)


def test_segsum_matches_reference(jx, rng):
    x = rng.standard_normal((3, 2, 16)).astype(np.float32)
    np.testing.assert_allclose(ref._segsum(_t(x)).numpy(),
                               _np(jx.ref._segsum(jx.jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


def test_ssd_padding_with_zero_dt_leaves_the_state_alone(rng):
    """dt = 0 on padding: appending pads changes neither the outputs at
    live positions nor the final state."""
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(rng, 2, 32, 2, 4, 1, 4, h0_scale=1.0)
    pad = lambda a: np.concatenate([a, np.zeros_like(a)], axis=1)  # noqa: E731
    y, h = ref.ssd(*map(_t, (x, dt, A, Bm, Cm, h0)), chunk=32)
    yp, hp = ref.ssd(*map(_t, (pad(x), pad(dt), A, pad(Bm), pad(Cm), h0)),
                     chunk=16)
    np.testing.assert_allclose(yp[:, :32].numpy(), y.numpy(), **TOL_TIGHT)
    np.testing.assert_allclose(hp.numpy(), h.numpy(), **TOL_TIGHT)


# --------------------------------------------------------------------------- #
# the port's entry points against the Pallas kernels (interpret mode)         #
# --------------------------------------------------------------------------- #
def test_router_matches_pallas_interpret(jx, rng):
    logits = rng.standard_normal((32, 8)).astype(np.float32)
    jw, ji = jx.moe.moe_router_tk(jx.jnp.asarray(logits), 2, block_t=16,
                                  interpret=True)
    w, idx = ops.moe_topk_router(_t(logits), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_allclose(w.numpy(), _np(jw), **TOL_TIGHT)


def test_ssd_matches_pallas_interpret(jx, rng):
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(rng, 1, 32, 2, 4, 1, 4, h0_scale=1.0)
    jy, jh = jx.ops.ssd(*map(jx.jnp.asarray, (x, dt, A, Bm, Cm, h0)),
                        chunk=16, impl="pallas")
    y, h_last = ops.ssd(*map(_t, (x, dt, A, Bm, Cm, h0)), chunk=16)
    np.testing.assert_allclose(y.numpy(), _np(jy), **SSD_PALLAS_TOL)
    np.testing.assert_allclose(h_last.numpy(), _np(jh), **SSD_PALLAS_TOL)


def test_rglru_matches_pallas_interpret(jx, rng):
    b, s, w = 2, 32, 16
    x, r, i = (rng.standard_normal((b, s, w)).astype(np.float32)
               for _ in range(3))
    a = rng.standard_normal(w).astype(np.float32)
    h0 = rng.standard_normal((b, w)).astype(np.float32)
    jo, jh = jx.ops.rglru(*map(jx.jnp.asarray, (x, r, i, a, h0)),
                          impl="pallas", block_s=16, block_w=16)
    out, h_last = ops.rglru(*map(_t, (x, r, i, a, h0)))
    np.testing.assert_allclose(out.numpy(), _np(jo), **TOL_TIGHT)
    np.testing.assert_allclose(h_last.numpy(), _np(jh), **TOL_TIGHT)


# --------------------------------------------------------------------------- #
# the wrappers                                                                #
# --------------------------------------------------------------------------- #
def test_cpu_tensors_take_the_plain_versions_without_a_launch(rng):
    before = (moe_router.launches, ssd.launches, rglru.launches)
    logits = _t(rng.standard_normal((7, 8)).astype(np.float32))
    w, idx = moe_router.moe_router_tk(logits, 2)
    assert torch.equal(idx, ref.moe_topk_router(logits, 2)[1])
    x, dt, A, Bm, Cm, h0 = map(_t, _ssd_inputs(rng, 2, 16, 2, 4, 1, 4))
    y, _ = ssd.ssd_bhcp(x.transpose(1, 2), dt.transpose(1, 2), A,
                        Bm.transpose(1, 2), Cm.transpose(1, 2), h0, chunk=8)
    assert torch.equal(y.transpose(1, 2), ref.ssd(x, dt, A, Bm, Cm, h0,
                                                  chunk=8)[0])
    xs = _t(rng.standard_normal((2, 5, 4)).astype(np.float32))
    out, _ = rglru.rglru_bsw(xs, xs, xs, xs[0, 0], xs[:, 0])
    assert torch.equal(out, ref.rglru(xs, xs, xs, xs[0, 0], xs[:, 0])[0])
    assert (moe_router.launches, ssd.launches, rglru.launches) == before


def test_wrappers_handle_zero_rows_and_reject_bad_shapes():
    w, idx = moe_router.moe_router_tk(torch.zeros((0, 8)), 2)
    assert tuple(w.shape) == (0, 2) and idx.dtype == torch.int32
    with pytest.raises(ValueError):
        moe_router.moe_router_tk(torch.zeros((4, 8)), 9)
    with pytest.raises(ValueError):
        moe_router.moe_router_tk(torch.zeros((4, 8), device="meta"), 2)
    z = torch.zeros
    with pytest.raises(ValueError, match="chunk"):
        ssd.ssd_bhcp(z(1, 2, 48, 4), z(1, 2, 48), z(2), z(1, 1, 48, 4),
                     z(1, 1, 48, 4), z(1, 2, 4, 4), chunk=32)
    with pytest.raises(ValueError, match="h0"):
        ssd.ssd_bhcp(z(1, 2, 32, 4), z(1, 2, 32), z(2), z(1, 1, 32, 4),
                     z(1, 1, 32, 4), z(1, 2, 4, 3), chunk=32)
    with pytest.raises(ValueError):
        rglru.rglru_bsw(z(1, 4, 8), z(1, 4, 8), z(1, 4, 7), z(8), z(1, 8))
    y, h_last = ssd.ssd_bhcp(z(0, 2, 32, 4), z(0, 2, 32), z(2),
                             z(0, 1, 32, 4), z(0, 1, 32, 4), z(0, 2, 4, 4),
                             chunk=32)
    assert tuple(y.shape) == (0, 2, 32, 4) and tuple(h_last.shape) == (0, 2, 4, 4)


# --------------------------------------------------------------------------- #
# tables and the featurizer                                                   #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("kernel", ["moe_router", "ssd", "rglru"])
def test_embedding_tables_are_bit_equal(jx, kernel):
    """The port draws its tables in the JAX package's order: through
    ``convert.embedding_table`` the reference's tables equal the port's."""
    rng = np.random.default_rng({"moe_router": 0, "ssd": 1, "rglru": 2}[kernel])
    draw = lambda dim: jx.lib._embed_table(rng, 256, dim)  # noqa: E731
    if kernel == "moe_router":
        want = [draw(16), rng.standard_normal((16, 8)).astype(np.float32)
                / np.sqrt(16)]
        got = lib.router_tables()
    elif kernel == "ssd":
        want = [draw(8), draw(4), draw(4),
                -np.abs(rng.standard_normal(2)).astype(np.float32)]
        got = lib.ssd_tables()
    else:
        want = [draw(16), draw(16), draw(16),
                rng.standard_normal(16).astype(np.float32)]
        got = lib.rglru_tables()
    for w, g in zip(want, got):
        w = np.asarray(jx.jnp.asarray(w))
        assert w.dtype == np.float32 and g.dtype == torch.float32
        if w.ndim == 2 and not w[0].any():
            w = convert.embedding_table(w, device="cpu")
            assert torch.equal(w, g)
        else:
            np.testing.assert_array_equal(g.numpy(), w)


def test_embedding_table_conversion_checks_the_padding_row():
    table = np.ones((4, 3), np.float32)
    with pytest.raises(ValueError, match="row 0"):
        convert.embedding_table(table, device="cpu")
    with pytest.raises(ValueError, match="vocab, dim"):
        convert.embedding_table(np.zeros(4), device="cpu")
    table[0] = 0.0
    t = convert.embedding_table(table.astype(np.float64), device="cpu")
    assert t.dtype == torch.float32 and tuple(t.shape) == (4, 3)


@pytest.mark.parametrize("n", [1, 5, 16, 64, 512])
def test_fixed_sum_is_a_sum_and_independent_of_the_batch(rng, n):
    x = _t(rng.standard_normal((6, n, 3)).astype(np.float32))
    total = ref.fixed_sum(x, 1)
    np.testing.assert_allclose(total.numpy(), x.double().sum(1).numpy(),
                               rtol=1e-5, atol=1e-5)
    for b in (1, 2, 5):
        assert torch.equal(ref.fixed_sum(x[:b], 1), total[:b])


def test_reviews_match_the_reference(jx):
    want = jx.text.make_reviews(40, seed=3)
    got = port_text.make_reviews(40, seed=3)
    for a, b in zip(got, want):
        assert (a.rid, a.rating, a.topic) == (b.rid, b.rating, b.topic)
        np.testing.assert_array_equal(a.tokens, b.tokens)
        assert port_text.topic_of_tokens(a.tokens) == \
            jx.text.topic_of_tokens(b.tokens)
    assert port_text.FOOD_WORDS == jx.text.FOOD_WORDS
    assert port_text.SERVICE_WORDS == jx.text.SERVICE_WORDS


# --------------------------------------------------------------------------- #
# the predicates against the JAX package's (XLA path)                         #
# --------------------------------------------------------------------------- #
def _jax_router_probs(jx, toks: np.ndarray) -> np.ndarray:
    """The JAX predicate's softmax probabilities (its featurizer, as
    ``topic_router_predicate`` writes it), sorted descending."""
    jnp = jx.jnp
    rng = np.random.default_rng(0)
    emb = jx.lib._embed_table(rng, 256, 16)
    w_gate = jnp.asarray(rng.standard_normal((16, 8)).astype(np.float32)
                         / np.sqrt(16))
    jt = jnp.asarray(toks)
    live = jnp.maximum((jt > 0).sum(1, keepdims=True), 1)
    logits = (emb[jt].sum(1) / live) @ w_gate
    return -np.sort(-np.asarray(jx.nn.softmax(logits)), -1)


@pytest.mark.parametrize("seq", [16, 64])
def test_router_predicate_matches_reference(jx, seq):
    toks = _tokens(400, seq)
    port = udfs.topic_router_predicate(0, seq=seq, device="cpu")
    want = np.asarray(jx.udfs.topic_router_predicate(
        0, seq=seq, impl="xla").udf.fn({"tokens": toks}))
    np.testing.assert_array_equal(port.udf.fn({"tokens": toks}), want)
    # the probabilities behind the decision, and the room the data leaves
    probs = ref.softmax(ref.router_logits(*lib.router_tables(), _t(toks).long()))
    got = probs.sort(-1, descending=True).values.numpy()
    jprobs = _jax_router_probs(jx, toks)
    np.testing.assert_allclose(got, jprobs, rtol=0, atol=PROB_ATOL)
    assert (jprobs[:, 0] - jprobs[:, 1]).min() > 2 * PROB_ATOL


@pytest.mark.parametrize("seq", [16, 64])
def test_ssd_predicate_matches_reference(jx, seq):
    toks = _tokens(400, seq)
    got = udfs.ssd_scorer_predicate(seq=seq, device="cpu").udf.fn(
        {"tokens": toks})
    want = np.asarray(jx.udfs.ssd_scorer_predicate(
        seq=seq, impl="xla").udf.fn({"tokens": toks}))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_ATOL)
    assert np.abs(want).min() > SCORE_ATOL  # no decision within the error
    np.testing.assert_array_equal(got > 0, want > 0)


@pytest.mark.parametrize("seq", [16, 64])
def test_rglru_predicate_matches_reference(jx, seq):
    """RG-LRU scores shrink by the decay of every padding step after a
    short review (down to ~1e-28), so they are compared relatively: an
    error below ``RGLRU_RTOL * |score|`` cannot change the score's sign.
    The score is the mean of 16 states whose sum cancels, so its relative
    error (up to ~4e-5 here) exceeds the states' own."""
    toks = _tokens(400, seq)
    got = udfs.rglru_gate_predicate(seq=seq, device="cpu").udf.fn(
        {"tokens": toks})
    want = np.asarray(jx.udfs.rglru_gate_predicate(
        seq=seq, impl="xla").udf.fn({"tokens": toks}))
    assert np.all(want != 0)
    np.testing.assert_allclose(got, want, rtol=RGLRU_RTOL, atol=0)
    np.testing.assert_array_equal(got > 0, want > 0)


@pytest.mark.parametrize("kernel", ["moe_router", "ssd", "rglru"])
def test_predicate_fingerprints_and_resources(kernel):
    a = udfs.build_predicate(kernel, seq=16, device="cpu")
    b = udfs.build_predicate(kernel, seq=64, device="cpu")
    assert a.udf.fingerprint != b.udf.fingerprint
    assert a.udf.resource == "cuda:0" and a.udf.columns == ("tokens",)
    assert a.udf.proxy({"tokens": np.array([[3, 0, 5, 0]])}) == 2.0


def test_text_predicates_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without a CUDA card")
    for builder in (udfs.topic_router_predicate, udfs.ssd_scorer_predicate,
                    udfs.rglru_gate_predicate):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            builder()


# --------------------------------------------------------------------------- #
# on the card                                                                 #
# --------------------------------------------------------------------------- #
@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 7, 32, 4096])
def test_text_kernels_match_plain_versions_on_card(card, b):
    toks = lib.token_ids(_tokens(b, 64, seed=5), 64, 256, card)
    before = (moe_router.launches, ssd.launches, rglru.launches)
    logits = ref.router_logits(*lib.router_tables(device=card), toks)
    w, idx = moe_router.moe_router_tk(logits, 2)
    w_p, idx_p = ref.moe_topk_router(logits, 2)
    x, dt, A, Bm, Cm = lib.ssd_inputs(lib.ssd_tables(device=card), toks)
    y, h_last = ops.ssd(x, dt, A, Bm, Cm)
    y_p, h_p = ref.ssd(x, dt, A, Bm, Cm)
    emb_x, emb_r, emb_i, a = lib.rglru_tables(device=card)
    out, hl = ops.rglru(emb_x[toks], emb_r[toks], emb_i[toks], a)
    out_p, hl_p = ref.rglru(emb_x[toks], emb_r[toks], emb_i[toks], a)
    torch.cuda.synchronize()
    assert (moe_router.launches, ssd.launches, rglru.launches) == tuple(
        n + 1 for n in before)
    assert torch.equal(idx, idx_p)
    for got, want in ((w, w_p), (y, y_p), (h_last, h_p), (out, out_p),
                      (hl, hl_p)):
        torch.testing.assert_close(got, want, **TOL_TIGHT)
    torch.testing.assert_close(lib.row_mean(y), lib.row_mean(y_p), rtol=0,
                               atol=SCORE_ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["moe_router", "ssd", "rglru"])
def test_predicate_outputs_do_not_depend_on_the_batch(card, kernel):
    """A row's output is bit-equal alone and in batches of 3, 16 and
    4096: the executor's bucketing must not move a decision."""
    toks = _tokens(4096, 64, seed=9)
    fn = udfs.build_predicate(kernel, device=card).udf.fn
    whole = fn({"tokens": toks})
    for b in (1, 3, 16):
        np.testing.assert_array_equal(fn({"tokens": toks[:b]}), whole[:b])
    np.testing.assert_array_equal(fn({"tokens": toks[100:116]}),
                                  whole[100:116])


@pytest.mark.gpu
def test_hooked_text_launches_on_card_report_cuda_backend(card):
    events = []
    p = udfs.ssd_scorer_predicate(device=card)
    with launch.launch_hooks(events.append):
        p.udf({"tokens": _tokens(5, 64)})
    assert [(e.name, e.backend, e.rows) for e in events] == [
        ("ssd", "cuda", 64), ("ssd", "cuda", 8 * 64)]
