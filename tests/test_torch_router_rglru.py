"""The token-fed entry points of the router and RG-LRU kernels, their
plain versions and the arithmetic of the rebuilt kernels, as plain code on
the CPU; and the rebuilt kernels against their plain versions on the card.

On the CPU: ``ref.moe_router_tokens`` and ``ref.rglru_tokens`` equal the
two-step plain paths (the featurizer or gather, then the existing plain
function) bit for bit, and agree with the JAX package's predicates on the
same tokens; a torch emulation of the router kernel's shared-memory
halving equals ``fixed_sum`` bit for bit, and of its whole prologue
``router_logits``; a torch emulation of the staged RG-LRU kernel (terms
formed a chunk at a time, then the chain, h carried across chunks, W in
tiles of 32 with a ragged tail) equals ``ref.rglru`` bit for bit; the
packed arguments, refusals and zero rows; and each predicate's call path:
one launch a call through its token entry. Tests marked ``gpu`` run the
CUDA kernels and skip without a card; JAX is imported inside a fixture,
so they also run on a card host that has no JAX.
"""
import importlib.util
import pathlib
import types

import numpy as np
import pytest
import torch

from repro_torch import udfs
from repro_torch.data import text as port_text
from repro_torch.kernels import launch, moe_router, ops, ref, rglru
from repro_torch.udfs import library as lib

torch.set_num_threads(1)

TOL_TIGHT = dict(rtol=1e-4, atol=1e-5)
PROB_ATOL = 1e-6    # router softmax probabilities: port against reference
TILE, CHUNK = 32, 32  # the RG-LRU kernel's channels a CTA and steps a chunk
BATCHES = (1, 7, 16, 32, 4096)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules the tests compare against."""
    jnn = pytest.importorskip("jax.nn")
    from repro.kernels import ops as jax_ops
    from repro.udfs import library as jax_lib
    return types.SimpleNamespace(nn=jnn, ops=jax_ops, lib=jax_lib)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tokens(n: int, seq: int, seed: int = 0) -> np.ndarray:
    reviews = port_text.make_reviews(n, seed=seed)
    toks = np.zeros((n, seq), np.int32)
    for j, r in enumerate(reviews):
        toks[j, : min(len(r.tokens), seq)] = r.tokens[:seq]
    return toks


def _chip_smoke():
    """The repo's ``chip_smoke.py`` as a module (for its ``OpCount``)."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _table(rng, v: int, w: int) -> torch.Tensor:
    t = rng.standard_normal((v, w)).astype(np.float32)
    t[0] = 0.0
    return _t(t)


# --------------------------------------------------------------------------- #
# the plain versions of the token entries                                     #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("seq", [16, 64, 100])
def test_router_tokens_plain_version_is_the_two_step_path(seq):
    toks = _t(_tokens(300, seq))
    emb, w_gate = lib.router_tables()
    logits = torch.empty((300, 8))
    w, idx = ref.moe_router_tokens(toks, emb, w_gate, 2, logits)
    want_logits = ref.router_logits(emb, w_gate, toks.long())
    w_p, idx_p = ref.moe_topk_router(want_logits, 2)
    assert torch.equal(logits, want_logits)
    assert torch.equal(w, w_p) and torch.equal(idx, idx_p)
    # the wrapper's CPU path is the plain version
    w_o, idx_o = ops.moe_router_tokens(toks, emb, w_gate, 2)
    assert torch.equal(w_o, w_p) and torch.equal(idx_o, idx_p)


@pytest.mark.parametrize("seq", [16, 64, 100])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_tokens_plain_version_is_the_two_step_path(rng, seq, with_h0):
    toks = _t(_tokens(300, seq))
    emb_x, emb_r, emb_i, a = lib.rglru_tables()
    h0 = _t(rng.standard_normal((300, 16)).astype(np.float32)) if with_h0 \
        else None
    out, h_last = ref.rglru_tokens(toks, emb_x, emb_r, emb_i, a, h0)
    t = toks.long()
    out_p, h_p = ref.rglru(emb_x[t], emb_r[t], emb_i[t], a, h0)
    assert torch.equal(out, out_p) and torch.equal(h_last, h_p)
    out_o, h_o = ops.rglru_tokens(toks, emb_x, emb_r, emb_i, a, h0)
    assert torch.equal(out_o, out_p) and torch.equal(h_o, h_p)


# --------------------------------------------------------------------------- #
# against the JAX package's predicates (XLA path)                             #
# --------------------------------------------------------------------------- #
def _reference_predicate(jx, monkeypatch, kernel_fn: str, builder,
                         seq: int, toks: np.ndarray):
    """The JAX package's predicate from ``builder`` (XLA path) on ``toks``,
    with its call of ``ops.<kernel_fn>`` recorded: (the predicate's
    output, the kernel call's arguments, its result). The tables and the
    featurizer are the reference's own."""
    calls = []
    real = getattr(jx.ops, kernel_fn)

    def spy(*args, **kw):
        out = real(*args, **kw)
        calls.append((args, out))
        return out

    monkeypatch.setattr(jx.lib, "ops", types.SimpleNamespace(
        **{**vars(jx.ops), kernel_fn: spy}))
    got = np.asarray(builder(seq=seq, impl="xla").udf.fn({"tokens": toks}))
    assert len(calls) == 1
    return got, *calls[0]


@pytest.mark.parametrize("seq", [16, 64])
def test_router_tokens_match_the_reference(jx, monkeypatch, seq):
    toks = _tokens(400, seq)
    top1, (jlogits, k), (_, jidx) = _reference_predicate(
        jx, monkeypatch, "moe_topk_router", jx.lib.topic_router_predicate,
        seq, toks)
    port = udfs.topic_router_predicate(0, seq=seq, device="cpu")
    np.testing.assert_array_equal(port.udf.fn({"tokens": toks}), top1)
    # both experts of the token entry's plain version, and the
    # probabilities behind them
    logits = torch.empty((400, 8))
    _, idx = ref.moe_router_tokens(_t(toks), *lib.router_tables(), k, logits)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    probs = np.asarray(jx.nn.softmax(jlogits))
    np.testing.assert_allclose(ref.softmax(logits).numpy(), probs, rtol=0,
                               atol=PROB_ATOL)
    # the room the data leaves: each chosen expert's probability stands
    # clear of the next one by more than the port's error
    top = -np.sort(-probs, -1)
    assert (top[:, :2] - top[:, 1:3]).min() > 2 * PROB_ATOL


@pytest.mark.parametrize("seq", [16, 64])
def test_rglru_tokens_match_the_reference(jx, monkeypatch, seq):
    toks = _tokens(400, seq)
    score, _, (_, jh) = _reference_predicate(
        jx, monkeypatch, "rglru", jx.lib.rglru_gate_predicate, seq, toks)
    _, h_last = ops.rglru_tokens(_t(toks), *lib.rglru_tables())
    np.testing.assert_allclose(h_last.numpy(), np.asarray(jh), **TOL_TIGHT)
    port = udfs.rglru_gate_predicate(seq=seq, device="cpu")
    np.testing.assert_array_equal(port.udf.fn({"tokens": toks}) > 0,
                                  score > 0)


# --------------------------------------------------------------------------- #
# emulations of the rebuilt kernels' order of operations                      #
# --------------------------------------------------------------------------- #
def _halve_rows(tile: torch.Tensor) -> torch.Tensor:
    """The router kernel's ``halve_rows`` on an (n, width) tile as its
    shared memory holds it, flat: each level adds the slots half * width
    further on into the first half * width slots (the lanes' shares), then
    moves an odd n's last row to row half. Returns row 0."""
    n, width = tile.shape
    v = tile.reshape(-1).clone()
    while n > 1:
        half = n // 2
        v[:half * width] = v[:half * width] + v[half * width:2 * half * width]
        if n % 2:
            v[half * width:(half + 1) * width] = \
                v[2 * half * width:(2 * half + 1) * width]
        n = half + n % 2
    return v[:width]


@pytest.mark.parametrize("n", [1, 5, 16, 63, 64, 100])
def test_shared_memory_halving_equals_fixed_sum(rng, n):
    x = _t(rng.standard_normal((n, 16)).astype(np.float32))
    assert torch.equal(_halve_rows(x), ref.fixed_sum(x, 0))


@pytest.mark.parametrize("seq,d,e", [(64, 16, 8), (100, 16, 8), (5, 7, 3),
                                     (1, 12, 64)])
def test_router_prologue_emulation_equals_router_logits(rng, seq, d, e):
    """The token entry's prologue, row by row: gather, halve over S, divide
    by the live count, the gate product, halve over D."""
    emb = _table(rng, 40, d)
    w_gate = _t(rng.standard_normal((d, e)).astype(np.float32))
    toks = _t(rng.integers(0, 40, (9, seq)).astype(np.int32))
    toks[3] = 0                       # no live token: the count is 1
    rows = []
    for t in toks:
        pooled = _halve_rows(emb[t]) / float(max(int((t > 0).sum()), 1))
        rows.append(_halve_rows(pooled[:, None] * w_gate))
    assert torch.equal(torch.stack(rows), ref.router_logits(emb, w_gate, toks))


def _staged_rglru(x, r, i, a_param, h0, c=8.0):
    """The rebuilt RG-LRU kernel's order: per row and tile of TILE
    channels (the last one ragged), chunks of CHUNK steps; each chunk's
    terms a_t and m_t formed first, then the chain h = a_t * h + m_t
    walked in order, h carried across chunks."""
    b, s, w = x.shape
    out = torch.empty_like(x)
    h_last = torch.empty((b, w))
    for bi in range(b):
        for w0 in range(0, w, TILE):
            cols = slice(w0, min(w0 + TILE, w))
            nsp = -c * ref.softplus(a_param[cols])
            h = torch.zeros(cols.stop - w0) if h0 is None else h0[bi, cols]
            for t0 in range(0, s, CHUNK):
                steps = slice(t0, min(t0 + CHUNK, s))
                a = torch.exp(nsp * ref.sigmoid(r[bi, steps, cols]))
                gated = ref.sigmoid(i[bi, steps, cols]) * x[bi, steps, cols]
                m = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * gated
                for t in range(steps.stop - t0):
                    h = a[t] * h + m[t]
                    out[bi, t0 + t, cols] = h
            h_last[bi, cols] = h
    return out, h_last


@pytest.mark.parametrize("b,s,w", [(2, 70, 40), (3, 64, 16), (2, 1, 16),
                                   (2, 33, 7), (1, 96, 64)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_staged_rglru_emulation_is_bit_equal(rng, b, s, w, with_h0):
    x, r, i = (_t(rng.standard_normal((b, s, w)).astype(np.float32))
               for _ in range(3))
    a = _t(rng.standard_normal(w).astype(np.float32))
    h0 = _t(rng.standard_normal((b, w)).astype(np.float32)) if with_h0 \
        else None
    out, h_last = _staged_rglru(x, r, i, a, h0)
    out_p, h_p = ref.rglru(x, r, i, a, h0)
    assert torch.equal(out, out_p) and torch.equal(h_last, h_p)


# --------------------------------------------------------------------------- #
# packed arguments, refusals, zero rows                                       #
# --------------------------------------------------------------------------- #
def test_token_entry_argument_sizes_match_the_sources():
    """Each token entry's struct format is its C struct's size (the sources
    static_assert the same numbers; the other entries' sizes are checked
    in tests/test_torch_ssd_layout.py)."""
    assert moe_router.TOKENS_ARGS.size == 72
    assert rglru.TOKENS_ARGS.size == 88


def test_token_entries_refuse_bad_inputs():
    z = torch.zeros
    toks = z((2, 5), dtype=torch.int32)
    emb, w_gate = z((10, 4)), z((4, 3))
    with pytest.raises(ValueError, match="toks"):
        moe_router.moe_router_tokens(toks[0], emb, w_gate, 2)
    with pytest.raises(ValueError, match="w_gate"):
        moe_router.moe_router_tokens(toks, emb, z((5, 3)), 2)
    for k in (0, 4):
        with pytest.raises(ValueError, match="1 <= k <= E"):
            moe_router.moe_router_tokens(toks, emb, w_gate, k)
    with pytest.raises(ValueError, match="logits_out"):
        moe_router.moe_router_tokens(toks, emb, w_gate, 2, z((2, 4)))
    with pytest.raises(ValueError, match="S >= 1"):
        moe_router.moe_router_tokens(z((2, 0), dtype=torch.int32), emb,
                                     w_gate, 2)
    with pytest.raises(ValueError):
        moe_router.moe_router_tokens(toks.to("meta"), emb, w_gate, 2)
    tab = z((10, 4))
    with pytest.raises(ValueError, match="toks"):
        rglru.rglru_tokens(toks[0], tab, tab, tab, z(4))
    with pytest.raises(ValueError, match="tables"):
        rglru.rglru_tokens(toks, tab, z((10, 5)), tab, z(4))
    with pytest.raises(ValueError, match="a_param"):
        rglru.rglru_tokens(toks, tab, tab, tab, z(5))
    with pytest.raises(ValueError, match="h0"):
        rglru.rglru_tokens(toks, tab, tab, tab, z(4), z((3, 4)))
    # ids past the table: the plain versions' indexing raises
    bad = torch.full((2, 5), 10, dtype=torch.int32)
    with pytest.raises(IndexError):
        moe_router.moe_router_tokens(bad, emb, w_gate, 2)
    with pytest.raises(IndexError):
        rglru.rglru_tokens(bad, tab, tab, tab, z(4))


def test_token_entries_handle_zero_rows():
    toks = torch.zeros((0, 64), dtype=torch.int32)
    w, idx = moe_router.moe_router_tokens(toks, *lib.router_tables(), 2)
    assert tuple(w.shape) == (0, 2) and idx.dtype == torch.int32
    out, h_last = rglru.rglru_tokens(toks, *lib.rglru_tables())
    assert tuple(out.shape) == (0, 64, 16) and tuple(h_last.shape) == (0, 16)
    out, h_last = rglru.rglru_tokens(torch.zeros((3, 0), dtype=torch.int32),
                                     *lib.rglru_tables())
    assert tuple(out.shape) == (3, 0, 16) and not h_last.any()


@pytest.mark.parametrize("kernel", ["moe_router", "rglru", "ssd",
                                    "flash_attention", "decode_attention"])
@pytest.mark.parametrize("bad", [-1, 256, 1 << 40])
def test_predicates_refuse_out_of_range_token_ids(kernel, bad):
    """Every text predicate takes its ids through ``library.token_ids``,
    which checks them on the host before the copy: the token entries would
    take such an id as the JAX package's gather does, torch indexing
    raises or wraps (a negative id counts from the end)."""
    toks = _tokens(4, 64).astype(np.int64)
    toks[2, 5] = bad
    p = udfs.build_predicate(kernel, device="cpu", seq=64)
    with pytest.raises(ValueError, match=r"\[0, 256\)"):
        p.udf.fn({"tokens": toks})
    # past the window the ids are cut off and not checked
    short = udfs.build_predicate(kernel, device="cpu", seq=4)
    assert short.udf.fn({"tokens": toks}).shape == (4,)


# --------------------------------------------------------------------------- #
# the predicates' call path                                                   #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("kernel,entry", [("moe_router", "moe_router_tokens"),
                                          ("rglru", "rglru_tokens")])
def test_text_predicates_launch_once_through_the_token_entry(
        monkeypatch, kernel, entry):
    """Each call hands the padded int32 ids to its token entry once (no h0
    for the RG-LRU), and the launch layer sees exactly that one launch."""
    calls = []
    real = getattr(ops, entry)

    def spy(toks, *args, **kw):
        calls.append((toks.dtype, tuple(toks.shape), args[4:] if
                      entry == "rglru_tokens" else ()))
        return real(toks, *args, **kw)

    monkeypatch.setattr(ops, entry, spy)
    p = udfs.build_predicate(kernel, device="cpu", seq=64)
    events = []
    with launch.launch_hooks(events.append):
        out = p.udf.fn({"tokens": _tokens(5, 50)})
    assert out.shape == (5,)
    assert calls == [(torch.int32, (5, 64), ())]
    rows = 5 if kernel == "moe_router" else 5 * 64
    assert [(e.name, e.backend, e.rows) for e in events] == [
        (kernel, "cpu", rows)]


# --------------------------------------------------------------------------- #
# on the card                                                                 #
# --------------------------------------------------------------------------- #
@pytest.mark.gpu
@pytest.mark.parametrize("b", BATCHES)
def test_token_entries_match_plain_versions_on_card(card, b):
    toks = lib.token_ids(_tokens(b, 64, seed=5), 64, 256, card)
    emb, w_gate = lib.router_tables(device=card)
    tables = lib.rglru_tables(device=card)
    before = (moe_router.launches, rglru.launches)
    logits = torch.empty((b, 8), device=card)
    w, idx = moe_router.moe_router_tokens(toks, emb, w_gate, 2, logits)
    out, h_last = rglru.rglru_tokens(toks, *tables)
    torch.cuda.synchronize()
    assert (moe_router.launches, rglru.launches) == (before[0] + 1,
                                                     before[1] + 1)
    want = ref.router_logits(emb, w_gate, toks.long())
    w_p, idx_p = ref.moe_topk_router(want, 2)
    w_tk, idx_tk = moe_router.moe_router_tk(want, 2)
    assert torch.equal(logits, want)
    assert torch.equal(idx, idx_p) and torch.equal(idx, idx_tk)
    assert torch.equal(w, w_tk)   # the same body as moe_router_tk
    torch.testing.assert_close(w, w_p, **TOL_TIGHT)
    out_p, h_p = ref.rglru_tokens(toks.long(), *tables)
    assert torch.equal(out, out_p) and torch.equal(h_last, h_p)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,w,v", [(3, 70, 40, 50), (5, 33, 7, 9),
                                     (2, 1, 16, 256), (4, 0, 16, 256)])
def test_rglru_entries_bit_equal_on_card_at_ragged_shapes(card, b, s, w, v):
    rng = np.random.default_rng(b * s + w)
    tables = [_table(rng, v, w).to(card) for _ in range(3)]
    a = _t(rng.standard_normal(w).astype(np.float32)).to(card)
    toks = _t(rng.integers(0, v, (b, s)).astype(np.int32)).to(card)
    h0 = _t(rng.standard_normal((b, w)).astype(np.float32)).to(card)
    for state in (None, h0):
        got = rglru.rglru_tokens(toks, *tables, a, state)
        want = ref.rglru_tokens(toks, *tables, a, state)
        t = toks.long()
        got_bsw = rglru.rglru_bsw(tables[0][t], tables[1][t], tables[2][t], a,
                                  state)
        torch.cuda.synchronize()
        for g, g_bsw, p in zip(got, got_bsw, want):
            assert torch.equal(g, p) and torch.equal(g_bsw, p)


@pytest.mark.gpu
@pytest.mark.parametrize("seq,d,e,k", [(100, 16, 8, 2), (5, 7, 3, 3),
                                       (1, 12, 64, 1)])
def test_router_tokens_on_card_at_other_shapes(card, seq, d, e, k):
    rng = np.random.default_rng(seq + d + e)
    emb = _table(rng, 40, d).to(card)
    w_gate = _t(rng.standard_normal((d, e)).astype(np.float32)).to(card)
    toks = _t(rng.integers(0, 40, (33, seq)).astype(np.int32)).to(card)
    logits = torch.empty((33, e), device=card)
    w, idx = moe_router.moe_router_tokens(toks, emb, w_gate, k, logits)
    want = ref.router_logits(emb, w_gate, toks)
    w_p, idx_p = ref.moe_topk_router(want, k)
    torch.cuda.synchronize()
    assert torch.equal(logits, want) and torch.equal(idx, idx_p)
    torch.testing.assert_close(w, w_p, **TOL_TIGHT)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["moe_router", "rglru"])
def test_token_entries_are_batch_invariant_on_card(card, kernel):
    toks = lib.token_ids(_tokens(4096, 64, seed=9), 64, 256, card)
    if kernel == "moe_router":
        emb, w_gate = lib.router_tables(device=card)

        def run(t):
            logits = torch.empty((t.shape[0], 8), device=card)
            w, idx = moe_router.moe_router_tokens(t, emb, w_gate, 2, logits)
            return logits, w, idx
    else:
        tables = lib.rglru_tables(device=card)

        def run(t):
            return rglru.rglru_tokens(t, *tables)
    whole = run(toks)
    for lo, hi in ((0, 1), (0, 3), (0, 16), (100, 116), (4090, 4096)):
        for part, full in zip(run(toks[lo:hi]), whole):
            assert torch.equal(part, full[lo:hi])


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["moe_router", "rglru"])
def test_text_predicates_launch_once_a_call_on_card(card, kernel):
    """One hooked launch with the ``cuda`` backend a call, the kernel's
    counter up by one, and (the router) no more than 8 torch operations in
    the whole call: the token copy, two outputs, the copy back."""
    module = moe_router if kernel == "moe_router" else rglru
    p = udfs.build_predicate(kernel, device=card, seq=64)
    p.udf.fn({"tokens": _tokens(5, 64)})   # build and warm
    events = []
    before = module.launches
    with launch.launch_hooks(events.append):
        p.udf.fn({"tokens": _tokens(5, 64)})
    torch.cuda.synchronize()
    rows = 5 if kernel == "moe_router" else 5 * 64
    assert [(e.name, e.backend, e.rows) for e in events] == [
        (kernel, "cuda", rows)]
    assert module.launches == before + 1
    counted = _chip_smoke().OpCount()
    with counted:
        p.udf.fn({"tokens": _tokens(5, 64)})
    if kernel == "moe_router":
        assert len(counted.ops) <= 8, counted.ops
