"""The port's attention kernels (flash_attention, decode_attention), their
plain versions and the two attention predicates against the JAX package.

The same numpy inputs, made from a seed, go through ``repro`` (the
reference) and ``repro_torch``. Plain versions are held to
``repro.kernels.ref`` at the shapes of the JAX package's
tests/test_kernels.py with ``TOL_TIGHT``; the port's entry points to the
Pallas kernels in interpret mode at small shapes with the JAX suite's own
tolerances (2e-2, 8e-2 for bfloat16). Predicates are held to the JAX
predicates on the XLA path at seq 16 and 32, and each such test checks
that the smallest decision margin in its data exceeds the tolerance it
allows. Tests marked ``gpu`` run the CUDA kernels and skip without a card;
JAX is imported inside a fixture, so they also run on a card host that has
no JAX.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch import convert, udfs
from repro_torch.data import text as port_text
from repro_torch.kernels import decode_attention, flash_attention, launch, ops, ref
from repro_torch.udfs import library as lib

# small tensors: one intra-op thread, so these tests do not crowd the
# timing-sensitive executor tests running beside them
torch.set_num_threads(1)

TOL = dict(rtol=2e-2, atol=2e-2)        # tests/test_kernels.py::TOL
TOL_BF16 = dict(rtol=8e-2, atol=8e-2)   # tests/test_kernels.py, bfloat16
TOL_TIGHT = dict(rtol=1e-4, atol=1e-5)
SCORE_ATOL = 1e-7   # attention scores: port against reference (seen: 4.5e-8)

FLASH_SHAPES = [     # tests/test_kernels.py::test_flash_attention_causal
    (1, 128, 4, 4, 32),    # MHA
    (2, 256, 4, 2, 64),    # GQA
    (1, 256, 8, 1, 64),    # MQA
    (2, 200, 4, 2, 32),    # non-block-multiple seq (pad path)
]
DECODE_SHAPES = [(2, 512, 4, 2, 64), (1, 256, 8, 8, 32), (3, 512, 8, 1, 64)]


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules the attention tests compare against."""
    jnp = pytest.importorskip("jax.numpy")
    from repro import udfs as jax_udfs
    from repro.kernels import ops as jax_ops
    from repro.kernels import ref as jax_ref
    from repro.udfs import library as jax_lib

    return types.SimpleNamespace(jnp=jnp, ref=jax_ref, ops=jax_ops,
                                 udfs=jax_udfs, lib=jax_lib)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _qkv(rng, b, s, h, hkv, d):
    return (rng.standard_normal((b, s, h, d)).astype(np.float32),
            rng.standard_normal((b, s, hkv, d)).astype(np.float32),
            rng.standard_normal((b, s, hkv, d)).astype(np.float32))


def _tokens(n: int, seq: int, seed: int = 0) -> np.ndarray:
    reviews = port_text.make_reviews(n, seed=seed)
    toks = np.zeros((n, seq), np.int32)
    for j, r in enumerate(reviews):
        toks[j, : min(len(r.tokens), seq)] = r.tokens[:seq]
    return toks


# --------------------------------------------------------------------------- #
# plain versions against the JAX reference (tests/test_kernels.py shapes)     #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("b,s,h,hkv,d", FLASH_SHAPES)
def test_mha_plain_version_matches_reference(jx, rng, b, s, h, hkv, d):
    q, k, v = _qkv(rng, b, s, h, hkv, d)
    want = jx.ref.mha_attention(*map(jx.jnp.asarray, (q, k, v)))
    got = ref.mha_attention(*map(_t, (q, k, v)))
    np.testing.assert_allclose(_np(got), _np(want), **TOL_TIGHT)


@pytest.mark.parametrize("window", [32, 100, 256])
def test_mha_plain_version_matches_reference_with_window(jx, rng, window):
    q, k, v = _qkv(rng, 2, 256, 4, 2, 32)
    want = jx.ref.mha_attention(*map(jx.jnp.asarray, (q, k, v)), window=window)
    got = ref.mha_attention(*map(_t, (q, k, v)), window=window)
    np.testing.assert_allclose(_np(got), _np(want), **TOL_TIGHT)


@pytest.mark.parametrize("window", [0, 128])
def test_chunked_and_banded_paths_match_reference_and_dense(jx, rng, window):
    """tests/test_kernels.py::test_xla_chunked_matches_dense and
    ::test_xla_chunked_swa_banded: chunks of 256 over S = 1024 (banded
    with a window of 128) against the reference's and the dense result."""
    q, k, v = _qkv(rng, 1, 1024, 2, 1, 32)
    want = jx.ref.mha_attention(*map(jx.jnp.asarray, (q, k, v)),
                                window=window, chunk_q=256)
    chunked = ref.mha_attention(*map(_t, (q, k, v)), window=window,
                                chunk_q=256)
    dense = ref.mha_attention(*map(_t, (q, k, v)), window=window, chunk_q=0)
    np.testing.assert_allclose(_np(chunked), _np(want), **TOL_TIGHT)
    np.testing.assert_allclose(_np(chunked), _np(dense), **TOL_TIGHT)


@pytest.mark.parametrize("b,s,h,hkv,d", DECODE_SHAPES)
def test_decode_plain_version_matches_reference(jx, rng, b, s, h, hkv, d):
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    _, kc, vc = _qkv(rng, b, s, h, hkv, d)
    lens = rng.integers(1, s + 1, (b,)).astype(np.int32)
    want = jx.ref.decode_attention(*map(jx.jnp.asarray, (q, kc, vc, lens)))
    got = ref.decode_attention(*map(_t, (q, kc, vc, lens)))
    np.testing.assert_allclose(_np(got), _np(want), **TOL_TIGHT)


def test_decode_matches_full_attention_at_the_last_position(rng):
    """tests/test_kernels.py::test_decode_attention_matches_full."""
    q, k, v = map(_t, _qkv(rng, 2, 128, 4, 2, 32))
    full = ref.mha_attention(q, k, v, causal=True)[:, -1]
    dec = ref.decode_attention(q[:, -1], k, v,
                               torch.full((2,), 128, dtype=torch.int32))
    np.testing.assert_allclose(_np(dec), _np(full), **TOL_TIGHT)


def test_dense_reference_averages_a_fully_masked_row_as_jax_does(jx, rng):
    """The reference's quirk, kept: with every key masked (-1e30, not
    -inf) the dense softmax is uniform, so a length-0 row averages every
    value row. The kernels' plain versions write 0 there instead."""
    q = rng.standard_normal((2, 4, 16)).astype(np.float32)
    _, kc, vc = _qkv(rng, 2, 8, 4, 2, 16)
    lens = np.array([0, 5], np.int32)
    want = jx.ref.decode_attention(*map(jx.jnp.asarray, (q, kc, vc, lens)))
    got = ref.decode_attention(*map(_t, (q, kc, vc, lens)))
    np.testing.assert_allclose(_np(got), _np(want), **TOL_TIGHT)
    np.testing.assert_allclose(_np(got)[0], vc[0].mean(0).repeat(2, 0),
                               **TOL_TIGHT)
    plain = ref.decode_attention_bkgd(
        _t(q.reshape(4, 2, 16)), _t(kc.transpose(0, 2, 1, 3).reshape(4, 8, 16)),
        _t(vc.transpose(0, 2, 1, 3).reshape(4, 8, 16)), _t(lens),
        num_kv_heads=2)
    assert torch.equal(plain[:2], torch.zeros((2, 2, 16)))
    np.testing.assert_allclose(_np(plain[2:]).reshape(4, 16), _np(got)[1],
                               **TOL_TIGHT)


# --------------------------------------------------------------------------- #
# the port's entry points against the Pallas kernels (interpret mode)         #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("b,s,h,hkv,window", [
    (1, 64, 2, 2, 0),     # MHA
    (2, 64, 4, 2, 0),     # GQA
    (1, 64, 4, 1, 0),     # MQA
    (2, 40, 2, 1, 0),     # S not a multiple of the block: padded
    (2, 64, 2, 1, 16),    # sliding window
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_pallas_interpret(jx, rng, b, s, h, hkv,
                                                  window, dtype):
    q, k, v = _qkv(rng, b, s, h, hkv, 16)
    jd = getattr(jx.jnp, dtype)
    want = jx.ops.flash_attention(
        *(jx.jnp.asarray(a, jd) for a in (q, k, v)), window=window,
        impl="pallas", block_q=32, block_k=32)
    td = getattr(torch, dtype)
    got = ops.flash_attention(*(_t(a).to(td) for a in (q, k, v)),
                              window=window, block_q=32, block_k=32)
    assert got.dtype == td and tuple(got.shape) == (b, s, h, 16)
    np.testing.assert_allclose(_np(got), _np(want),
                               **(TOL if dtype == "float32" else TOL_BF16))


@pytest.mark.parametrize("b,s,h,hkv", [(2, 64, 4, 2), (1, 64, 2, 1),
                                       (3, 32, 4, 4)])
def test_decode_attention_matches_pallas_interpret(jx, rng, b, s, h, hkv):
    q = rng.standard_normal((b, h, 16)).astype(np.float32)
    _, kc, vc = _qkv(rng, b, s, h, hkv, 16)
    lens = rng.integers(1, s + 1, (b,)).astype(np.int32)
    lens[0] = 1
    want = jx.ops.decode_attention(*map(jx.jnp.asarray, (q, kc, vc, lens)),
                                   impl="pallas", block_k=32)
    got = ops.decode_attention(*map(_t, (q, kc, vc, lens)), block_k=32)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


# --------------------------------------------------------------------------- #
# the wrappers                                                                #
# --------------------------------------------------------------------------- #
def test_fully_masked_rows_give_zero_not_nan(rng):
    """A window that hides every key (queries past the keys' end) and a
    decode length of 0 write 0; the other rows keep the dense result."""
    q = _t(rng.standard_normal((2, 64, 8)).astype(np.float32))
    k = _t(rng.standard_normal((1, 32, 8)).astype(np.float32))
    v = _t(rng.standard_normal((1, 32, 8)).astype(np.float32))
    out = flash_attention.flash_attention_bhsd(q, k, v, group=2, causal=True,
                                               window=8)
    assert not torch.isnan(out).any()
    hidden = torch.arange(64) - 8 >= 31   # no key j with j > i - 8 and j < 32
    assert hidden.sum() == 25
    assert torch.equal(out[:, hidden], torch.zeros_like(out[:, hidden]))
    # the visible rows against a softmax over their visible keys
    qn, kn, vn = q.numpy(), k[0].numpy(), v[0].numpy()
    for i in np.nonzero(~hidden.numpy())[0]:
        j = np.arange(max(i - 7, 0), min(i, 31) + 1)
        logits = qn[:, i] @ kn[j].T * 8 ** -0.5
        p = np.exp(logits - logits.max(-1, keepdims=True))
        want = (p / p.sum(-1, keepdims=True)) @ vn[j]
        np.testing.assert_allclose(out[:, i].numpy(), want, **TOL_TIGHT)

    qd = _t(rng.standard_normal((4, 2, 8)).astype(np.float32))
    kc = _t(rng.standard_normal((4, 16, 8)).astype(np.float32))
    lens = torch.tensor([0, 7], dtype=torch.int32)
    dec = decode_attention.decode_attention_bkgd(qd, kc, kc, lens,
                                                 num_kv_heads=2)
    assert torch.equal(dec[:2], torch.zeros((2, 2, 8)))
    assert not torch.isnan(dec).any() and dec[2:].abs().sum() > 0


def test_zero_rows_and_empty_caches():
    z = torch.zeros
    assert tuple(flash_attention.flash_attention_bhsd(
        z(0, 32, 8), z(0, 32, 8), z(0, 32, 8), group=1).shape) == (0, 32, 8)
    assert tuple(ops.flash_attention(z(0, 32, 2, 8), z(0, 32, 1, 8),
                                     z(0, 32, 1, 8), block_q=32,
                                     block_k=32).shape) == (0, 32, 2, 8)
    assert tuple(decode_attention.decode_attention_bkgd(
        z(0, 2, 8), z(0, 16, 8), z(0, 16, 8), z(0, dtype=torch.int32),
        num_kv_heads=1).shape) == (0, 2, 8)
    assert tuple(ops.decode_attention(z(0, 2, 8), z(0, 16, 1, 8),
                                      z(0, 16, 1, 8),
                                      z(0, dtype=torch.int32)).shape) == (0, 2, 8)
    # no keys at all: every row is fully masked
    out = flash_attention.flash_attention_bhsd(z(2, 4, 8), z(2, 0, 8),
                                               z(2, 0, 8), group=1)
    assert torch.equal(out, z(2, 4, 8))


def test_wrappers_reject_bad_shapes_and_types():
    z = torch.zeros
    with pytest.raises(ValueError, match="group"):
        flash_attention.flash_attention_bhsd(z(4, 8, 8), z(3, 8, 8),
                                             z(3, 8, 8), group=2)
    with pytest.raises(ValueError, match="dtype"):
        flash_attention.flash_attention_bhsd(z(2, 8, 8), z(2, 8, 8),
                                             z(2, 8, 8, dtype=torch.float64),
                                             group=1)
    with pytest.raises(ValueError, match="3-d"):
        flash_attention.flash_attention_bhsd(z(2, 8), z(2, 8), z(2, 8), group=1)
    with pytest.raises(ValueError, match="cpu or cuda"):
        flash_attention.flash_attention_bhsd(
            *(z(2, 8, 8, device="meta") for _ in range(3)), group=1)
    with pytest.raises(ValueError, match="non-causal"):
        ops.flash_attention(z(1, 40, 2, 8), z(1, 40, 1, 8), z(1, 40, 1, 8),
                            causal=False, block_q=32, block_k=32)
    with pytest.raises(ValueError, match="Hkv must divide H"):
        ops.flash_attention(z(1, 32, 3, 8), z(1, 32, 2, 8), z(1, 32, 2, 8),
                            block_q=32, block_k=32)
    with pytest.raises(ValueError, match="lengths"):
        decode_attention.decode_attention_bkgd(
            z(4, 2, 8), z(4, 16, 8), z(4, 16, 8), z(4, dtype=torch.int32),
            num_kv_heads=2)
    with pytest.raises(ValueError, match="integers"):
        decode_attention.decode_attention_bkgd(
            z(2, 2, 8), z(2, 16, 8), z(2, 16, 8), z(2), num_kv_heads=1)
    with pytest.raises(ValueError, match="caches"):
        decode_attention.decode_attention_bkgd(
            z(2, 2, 8), z(2, 16, 8), z(2, 15, 8), z(2, dtype=torch.int32),
            num_kv_heads=1)
    with pytest.raises(ValueError, match="multiple"):
        ops.decode_attention(z(1, 2, 8), z(1, 48, 1, 8), z(1, 48, 1, 8),
                             torch.ones(1, dtype=torch.int32), block_k=32)
    with pytest.raises(ValueError, match="Hkv must divide H"):
        ops.decode_attention(z(1, 3, 8), z(1, 32, 2, 8), z(1, 32, 2, 8),
                             torch.ones(1, dtype=torch.int32))


def test_non_causal_aligned_and_custom_scale(rng):
    """A non-causal call with S a multiple of the block runs; ``scale``
    reaches the plain version (it defaults to D ** -0.5 on the true D)."""
    q, k, v = map(_t, _qkv(rng, 1, 32, 2, 1, 8))
    a = ops.flash_attention(q, k, v, causal=False, block_q=32, block_k=32)
    dense = ref.mha_attention(q, k, v, causal=False, chunk_q=0)
    np.testing.assert_allclose(_np(a), _np(dense), **TOL_TIGHT)
    qf, kf, vf = (t.transpose(1, 2).reshape(-1, 32, 8) for t in (q, k, v))
    base = flash_attention.flash_attention_bhsd(qf, kf, vf, group=2,
                                                causal=False)
    same = flash_attention.flash_attention_bhsd(qf, kf, vf, group=2,
                                                causal=False, scale=8 ** -0.5)
    assert torch.equal(base, same)
    sharp = flash_attention.flash_attention_bhsd(qf, kf, vf, group=2,
                                                 causal=False, scale=1.0)
    assert not torch.allclose(base, sharp)


def test_cpu_tensors_take_the_plain_versions_without_a_launch(rng):
    before = (flash_attention.launches, decode_attention.launches)
    q, k, v = map(_t, _qkv(rng, 2, 32, 4, 2, 8))
    out = ops.flash_attention(q, k, v, block_q=32, block_k=32)
    np.testing.assert_allclose(_np(out), _np(ref.mha_attention(q, k, v)),
                               **TOL_TIGHT)
    lens = torch.tensor([3, 32])
    dec = ops.decode_attention(q[:, 0], k, v, lens)
    np.testing.assert_allclose(_np(dec), _np(ref.decode_attention(
        q[:, 0], k, v, lens)), **TOL_TIGHT)
    assert (flash_attention.launches, decode_attention.launches) == before


def test_launches_are_hooked_under_their_names(rng):
    q, k, v = map(_t, _qkv(rng, 2, 40, 4, 2, 8))
    events = []
    with launch.launch_hooks(events.append):
        ops.flash_attention(q, k, v, block_q=32, block_k=32)   # S = 40, unpadded
        ops.decode_attention(q[:, 0], k[:, :32], v[:, :32],
                             torch.tensor([1, 9]), block_k=32)
    assert [(e.name, e.backend, e.rows) for e in events] == [
        ("flash_attention", "cpu", 2 * 4 * 40), ("decode_attention", "cpu", 8)]


# --------------------------------------------------------------------------- #
# tables and the predicates                                                   #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("kernel", ["flash_attention", "decode_attention"])
def test_attention_tables_are_bit_equal(jx, kernel):
    """The port draws its tables in the JAX package's order (q, k, v; then
    k, v and the query): through ``convert.embedding_table`` the
    reference's tables equal the port's, and the query vector is equal."""
    if kernel == "flash_attention":
        rng = np.random.default_rng(3)
        want = [jx.lib._embed_table(rng, 256, 16) for _ in range(3)]
        got = lib.attention_tables()
    else:
        rng = np.random.default_rng(4)
        want = [jx.lib._embed_table(rng, 256, 8),
                jx.lib._embed_table(rng, 256, 8),
                rng.standard_normal((2, 8)).astype(np.float32)]
        got = lib.decode_tables()
    assert len(got) == len(want)
    for w, g in zip(want, got):
        w = np.asarray(jx.jnp.asarray(w))
        assert w.dtype == np.float32 and g.dtype == torch.float32
        if kernel == "decode_attention" and w.shape == (2, 8):
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            assert torch.equal(convert.embedding_table(w, device="cpu"), g)


@pytest.mark.parametrize("seq", [16, 32])
@pytest.mark.parametrize("kernel", ["flash_attention", "decode_attention"])
def test_attention_predicates_match_reference(jx, kernel, seq):
    toks = _tokens(400, seq)
    got = udfs.build_predicate(kernel, seq=seq, device="cpu").udf.fn(
        {"tokens": toks})
    builder = (jx.udfs.attention_scorer_predicate if kernel == "flash_attention"
               else jx.udfs.decode_relevance_predicate)
    want = np.asarray(builder(seq=seq, impl="xla").udf.fn({"tokens": toks}))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_ATOL)
    assert np.abs(want).min() > SCORE_ATOL  # no decision within the error
    np.testing.assert_array_equal(got > 0, want > 0)
    assert 0 < (got > 0).sum() < len(got)


@pytest.mark.parametrize("kernel", ["flash_attention", "decode_attention"])
def test_attention_predicate_fingerprints_resources_and_bucketing(kernel):
    a = udfs.build_predicate(kernel, seq=16, device="cpu")
    b = udfs.build_predicate(kernel, seq=32, device="cpu")
    assert a.udf.fingerprint != b.udf.fingerprint
    assert a.udf.resource == "cuda:0" and a.udf.columns == ("tokens",)
    assert a.udf.proxy({"tokens": np.array([[3, 0, 5, 0]])}) == 2.0
    toks = _tokens(5, 16, seed=3)   # 5 rows -> bucketed to 8
    events = []
    with launch.launch_hooks(events.append):
        bucketed = a.udf({"tokens": toks})
    rows = [e.rows for e in events if e.name == kernel]
    assert rows[-1] == (8 * 2 * 16 if kernel == "flash_attention" else 8 * 2)
    a.udf.bucket = False
    np.testing.assert_allclose(bucketed, a.udf({"tokens": toks}), rtol=0,
                               atol=SCORE_ATOL)


def test_attention_predicates_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without a CUDA card")
    for builder in (udfs.attention_scorer_predicate,
                    udfs.decode_relevance_predicate):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            builder()


# --------------------------------------------------------------------------- #
# on the card                                                                 #
# --------------------------------------------------------------------------- #
@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 7, 32, 4096])
def test_attention_kernels_match_plain_versions_on_card(card, b):
    torch.backends.cuda.matmul.allow_tf32 = False
    toks = lib.token_ids(_tokens(b, 32, seed=5), 32, 256, card)
    before = (flash_attention.launches, decode_attention.launches)
    q, k, v = lib.attention_inputs(lib.attention_tables(device=card), toks)
    out = ops.flash_attention(q, k, v, block_q=32, block_k=32)
    qf, kf, vf = (t.transpose(1, 2).reshape(-1, 32, 8) for t in (q, k, v))
    out_p = ref.flash_attention_bhsd(qf, kf, vf, group=1).reshape(
        b, 2, 32, 8).transpose(1, 2)
    dq, kc, vc, lens = lib.decode_inputs(lib.decode_tables(device=card), toks)
    dec = ops.decode_attention(dq, kc, vc, lens, block_k=32)
    dec_p = ref.decode_attention_bkgd(
        dq.reshape(b, 2, 8), kc.transpose(1, 2).reshape(b, 32, 8),
        vc.transpose(1, 2).reshape(b, 32, 8), lens, num_kv_heads=1)
    torch.cuda.synchronize()
    assert (flash_attention.launches, decode_attention.launches) == tuple(
        n + 1 for n in before)
    torch.testing.assert_close(out, out_p, **TOL_TIGHT)
    torch.testing.assert_close(dec, dec_p.reshape(b, 2, 8), **TOL_TIGHT)
    torch.testing.assert_close(lib.row_mean(out), lib.row_mean(out_p), rtol=0,
                               atol=SCORE_ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,hkv,d", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain_version_on_card(card, rng, b, s, h, hkv,
                                                    d, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = (_t(a).to(card, dtype) for a in _qkv(rng, b, s, h, hkv, d))
    got = ops.flash_attention(q, k, v)
    want = ref.mha_attention(q, k, v)
    torch.testing.assert_close(got.float(), want.float(),
                               **(TOL_TIGHT if dtype == torch.float32
                                  else TOL_BF16))


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,hkv,d", DECODE_SHAPES)
def test_decode_kernel_matches_plain_version_on_card(card, rng, b, s, h, hkv,
                                                     d):
    torch.backends.cuda.matmul.allow_tf32 = False
    q = _t(rng.standard_normal((b, h, d)).astype(np.float32)).to(card)
    _, kc, vc = (_t(a).to(card) for a in _qkv(rng, b, s, h, hkv, d))
    lens = _t(rng.integers(0, s + 1, (b,)).astype(np.int32)).to(card)
    lens[0] = 0
    got = ops.decode_attention(q, kc, vc, lens)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    want = ref.decode_attention_bkgd(
        q.reshape(b * hkv, h // hkv, d),
        kc.transpose(1, 2).reshape(b * hkv, s, d),
        vc.transpose(1, 2).reshape(b * hkv, s, d), lens, num_kv_heads=hkv)
    torch.testing.assert_close(got, want.reshape(b, h, d), **TOL_TIGHT)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["flash_attention", "decode_attention"])
def test_attention_predicate_outputs_do_not_depend_on_the_batch(card, kernel):
    """A row's score is bit-equal alone and in batches of 3, 16 and 4096:
    the executor's bucketing must not move a decision."""
    toks = _tokens(4096, 32, seed=9)
    fn = udfs.build_predicate(kernel, device=card).udf.fn
    whole = fn({"tokens": toks})
    for b in (1, 3, 16):
        np.testing.assert_array_equal(fn({"tokens": toks[:b]}), whole[:b])
    np.testing.assert_array_equal(fn({"tokens": toks[100:116]}),
                                  whole[100:116])


@pytest.mark.gpu
def test_plain_attention_refuses_tf32_on_card(card):
    q = torch.zeros((1, 4, 8), device=card)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="float32 products"):
            ref.flash_attention_bhsd(q, q, q, group=1)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
