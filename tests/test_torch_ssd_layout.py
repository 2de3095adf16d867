"""The SSD kernel's strided entry points, its order of summation and its
packed arguments, as plain code on the CPU; and the rebuilt kernel against
its plain version on the card.

On the CPU: ``ops.ssd`` on the predicate's own layout (a dt broadcast over
heads, a non-contiguous x, no h0) equals the JAX package's ``ops.ssd``
(plain and Pallas in interpret mode); ``ssd_bshp`` and ``ssd_bhcp`` agree;
the strides the wrappers pack address exactly the elements of each
operand; and a numpy emulation of the kernel's arithmetic, in its order
(the warp scan of dt * A, each row's (row, m) steps in index order, the
xor butterfly of the state), stays within ``TOL_TIGHT`` of ``ref.ssd`` and
its scores within ``SCORE_ATOL`` over 2,048 rows of the triage table at
the library's shapes, with every decision kept. Tests marked ``gpu`` run
the CUDA kernel and skip without a card.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.data import text as port_text
from repro_torch.kernels import hsv_color, moe_router, ops, ref, rglru, ssd
from repro_torch.udfs import library as lib

torch.set_num_threads(1)

TOL_TIGHT = dict(rtol=1e-4, atol=1e-5)
SSD_PALLAS_TOL = dict(rtol=3e-2, atol=3e-2)  # tests/test_kernels.py::test_ssd
SCORE_ATOL = 1e-8   # SSD scores: kernel against plain version
F32 = np.float32


@pytest.fixture(scope="module")
def jx():
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops as jax_ops
    from repro.kernels import ref as jax_ref
    return types.SimpleNamespace(jnp=jnp, ops=jax_ops, ref=jax_ref)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, F32))


def _triage_tokens(n: int, seq: int = 64) -> np.ndarray:
    """The first ``n`` rows of the triage query's kept table (rating <=
    2), padded to ``seq``."""
    reviews = port_text.make_reviews(4 * n, seed=0)
    kept = [r for r in reviews if r.rating <= 2][:n]
    toks = np.zeros((len(kept), seq), np.int32)
    for j, r in enumerate(kept):
        toks[j, :min(len(r.tokens), seq)] = r.tokens[:seq]
    return toks


def _inputs(rng, b, s, h, p, g, n):
    """(x, dt, A, Bm, Cm, h0) in the model layout, float32 numpy."""
    return ((rng.standard_normal((b, s, h, p)) * 0.5).astype(F32),
            rng.uniform(0.01, 0.2, (b, s, h)).astype(F32),
            (-rng.uniform(0.5, 2.0, (h,))).astype(F32),
            (rng.standard_normal((b, s, g, n)) * 0.3).astype(F32),
            (rng.standard_normal((b, s, g, n)) * 0.3).astype(F32),
            rng.standard_normal((b, h, p, n)).astype(F32))


def strided_views(x, dt, Bm, Cm, *, heads: int):
    """The same values as views the kernel must read through strides: x
    every other column of a wider array, dt one column broadcast over the
    heads (stride 0), B and C rows of a wider array."""
    b, s, h, p = x.shape
    xw = torch.zeros((b, s, h, 2 * p), device=x.device)
    xw[..., ::2] = x
    bc = torch.zeros((b, s, 3, Bm.shape[2], Bm.shape[3]), device=x.device)
    bc[:, :, 0], bc[:, :, 2] = Bm, Cm
    return (xw[..., ::2], dt[..., :1].expand(b, s, heads), bc[:, :, 0],
            bc[:, :, 2])


# --------------------------------------------------------------------------- #
# the kernel's order of summation, emulated in numpy                          #
# --------------------------------------------------------------------------- #
def warp_scan(e: np.ndarray) -> np.ndarray:
    """(..., L <= 64) -> inclusive sum in the kernel's order: lane i adds
    elements 2i and 2i + 1, a Hillis-Steele scan over the 32 pair sums,
    element 2i is the exclusive prefix plus its own value."""
    L = e.shape[-1]
    pad = np.zeros(e.shape[:-1] + (64,), F32)
    pad[..., :L] = e
    e0, e1 = pad[..., 0::2], pad[..., 1::2]
    v = e0 + e1
    for d in (1, 2, 4, 8, 16):
        up = np.zeros_like(v)
        up[..., d:] = v[..., :-d]
        v = np.where(np.arange(32) >= d, v + up, v)
    excl = np.zeros_like(v)
    excl[..., 1:] = v[..., :-1]
    out = np.empty_like(pad)
    out[..., 0::2] = excl + e0
    out[..., 1::2] = v
    return out[..., :L]


def butterfly_state(term: np.ndarray) -> np.ndarray:
    """(R, L, P, N) per-row shares of the state -> (R, P, N) as the kernel
    adds them: lane i sums rows i and L-1-i, then xor-shuffles 16, 8, 4,
    2, 1 add the lanes."""
    L = term.shape[1]
    lanes = np.zeros((term.shape[0], 32) + term.shape[2:], F32)
    for lane in range((L + 1) // 2):
        lanes[:, lane] = term[:, lane]
        if L - 1 - lane > lane:
            lanes[:, lane] = lanes[:, lane] + term[:, L - 1 - lane]
    for d in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, np.arange(32) ^ d]
    return lanes[:, 0]


def emulate_kernel(x, dt, A, Bm, Cm, h0, chunk: int):
    """The kernel's arithmetic on float32 numpy (model layout), operation
    for operation and in its order, with numpy's exp for expf."""
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    y = np.zeros((b, s, h, p), F32)
    state = (np.zeros((b, h, p, n), F32) if h0 is None
             else h0.astype(F32).copy())
    L = chunk
    lower = np.tril(np.ones((L, L), bool))
    for hi in range(h):
        gi = hi // (h // g)
        for base in range(0, s, L):
            xc = x[:, base:base + L, hi]
            dtc = dt[:, base:base + L, hi]
            bc = Bm[:, base:base + L, gi]
            cc = Cm[:, base:base + L, gi]
            cum = warp_scan(dtc * A[hi])                        # (R, L)
            sc = np.zeros((b, L, L), F32)
            for j in range(n):                                  # C_l . B_m
                sc = sc + cc[:, :, None, j] * bc[:, None, :, j]
            seg = np.where(lower, cum[:, :, None] - cum[:, None, :], 0)
            att = sc * np.exp(seg) * dtc[:, None, :]
            acc = np.zeros((b, L, p), F32)
            for m in range(L):                                  # index order
                add = acc + att[:, :, m, None] * xc[:, None, m, :]
                acc = np.where((np.arange(L) >= m)[None, :, None], add, acc)
            ch = np.zeros((b, L, p), F32)
            for j in range(n):
                ch = ch + cc[:, :, None, j] * state[:, hi, None, :, j]
            y[:, base:base + L, hi] = acc + np.exp(cum)[:, :, None] * ch
            last = cum[:, -1:]
            w = dtc * np.exp(last - cum)
            term = (xc * w[:, :, None])[:, :, :, None] * bc[:, :, None, :]
            state[:, hi] = np.exp(last)[:, :, None] * state[:, hi] \
                + butterfly_state(term)
    return y, state


def test_warp_scan_is_a_cumulative_sum(rng):
    e = rng.standard_normal((5, 64)).astype(F32)
    np.testing.assert_allclose(warp_scan(e), np.cumsum(e, -1, dtype=np.float64),
                               rtol=1e-5, atol=1e-5)
    for L in (1, 7, 33):   # a ragged chunk: the padding adds nothing
        np.testing.assert_array_equal(warp_scan(e[:, :L]), warp_scan(e)[:, :L])


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [
    (2, 64, 2, 4, 1, 4, 64),     # the predicate's shapes
    (2, 256, 2, 4, 1, 4, 64),    # four chunks
    (1, 64, 4, 16, 2, 8, 16),    # G < H, the generic instance
    (2, 48, 2, 6, 1, 3, 24),     # ragged P and N, an even chunk under 32
    (1, 45, 2, 4, 1, 4, 15),     # an odd chunk: a middle row
])
def test_kernel_order_matches_plain_version(rng, b, s, h, p, g, n, chunk):
    x, dt, A, Bm, Cm, h0 = _inputs(rng, b, s, h, p, g, n)
    y, hl = emulate_kernel(x, dt, A, Bm, Cm, h0, chunk)
    y_p, h_p = ref.ssd(*map(_t, (x, dt, A, Bm, Cm, h0)), chunk=chunk)
    np.testing.assert_allclose(y, y_p.numpy(), **TOL_TIGHT)
    np.testing.assert_allclose(hl, h_p.numpy(), **TOL_TIGHT)


def test_kernel_order_keeps_triage_scores_and_decisions():
    """2,048 kept triage rows at the library's shapes (H = 2, P = N = 4,
    S = chunk = 64, no h0): the emulated kernel's scores are within
    SCORE_ATOL of the plain version's, under the smallest decision
    margin."""
    toks = torch.from_numpy(_triage_tokens(2048)).long()
    assert len(toks) == 2048
    x, dt, A, Bm, Cm = lib.ssd_inputs(lib.ssd_tables(), toks)
    y_p, h_p = ref.ssd(x, dt, A, Bm, Cm, None, chunk=64)
    y, hl = emulate_kernel(*(t.contiguous().numpy() for t in (x, dt, A, Bm, Cm)),
                           None, 64)
    np.testing.assert_allclose(y, y_p.numpy(), **TOL_TIGHT)
    np.testing.assert_allclose(hl, h_p.numpy(), **TOL_TIGHT)
    score = lib.row_mean(torch.from_numpy(y)).numpy()
    score_p = lib.row_mean(y_p).numpy()
    np.testing.assert_allclose(score, score_p, rtol=0, atol=SCORE_ATOL)
    assert np.abs(score_p).min() > SCORE_ATOL
    np.testing.assert_array_equal(score > 0, score_p > 0)


# --------------------------------------------------------------------------- #
# entry points and layouts                                                    #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_ops_ssd_on_the_predicates_layout_matches_reference(jx, rng, impl):
    x, dt, A, Bm, Cm, _ = _inputs(rng, 2, 32, 2, 4, 1, 4)
    dt[..., 1] = dt[..., 0]   # one dt for both heads, as ssd_inputs makes it
    xs, dts, bs, cs = strided_views(*map(_t, (x, dt, Bm, Cm)), heads=2)
    assert not xs.is_contiguous() and dts.stride(-1) == 0
    y, h_last = ops.ssd(xs, dts, _t(A), bs, cs, chunk=16)
    jy, jh = jx.ops.ssd(*map(jx.jnp.asarray, (x, dt, A, Bm, Cm)), chunk=16,
                        impl=impl)
    tol = TOL_TIGHT if impl == "xla" else SSD_PALLAS_TOL
    np.testing.assert_allclose(y.numpy(), np.asarray(jy, F32), **tol)
    np.testing.assert_allclose(h_last.numpy(), np.asarray(jh, F32), **tol)
    assert tuple(y.shape) == (2, 32, 2, 4) and h_last.dtype == torch.float32


def test_bshp_and_bhcp_agree(rng):
    x, dt, A, Bm, Cm, h0 = map(_t, _inputs(rng, 2, 64, 4, 8, 2, 4))
    for h in (h0, None):
        y, hl = ssd.ssd_bshp(x, dt, A, Bm, Cm, h, chunk=32)
        zero = torch.zeros_like(h0) if h is None else h
        y2, hl2 = ssd.ssd_bhcp(x.transpose(1, 2), dt.transpose(1, 2), A,
                               Bm.transpose(1, 2), Cm.transpose(1, 2), zero,
                               chunk=32)
        assert torch.equal(y, y2.transpose(1, 2)) and torch.equal(hl, hl2)


def _gather(t: torch.Tensor, strides: tuple, shape: tuple) -> torch.Tensor:
    """The (b, s, h[, last]) elements the kernel reads from t's storage
    through ``strides``."""
    return torch.as_strided(t, shape, strides, t.storage_offset())


def test_packed_strides_address_each_operand(rng):
    x, dt, A, Bm, Cm, _ = map(_t, _inputs(rng, 3, 16, 2, 4, 1, 4))
    xs, dts, bs, cs = strided_views(x, dt, Bm, Cm, heads=2)
    for t, want in ((xs, x), (dts, dt[..., :1].expand(3, 16, 2)), (bs, Bm),
                    (cs, Cm)):
        assert torch.equal(_gather(t, t.stride(), tuple(t.shape)), want)
        tt = t.transpose(1, 2)   # the (B, H, S[, last]) layout of ssd_bhcp
        assert torch.equal(_gather(tt, ssd.bhsp_strides(tt), tuple(t.shape)),
                           want)


def test_packed_argument_sizes_match_the_sources():
    """Each wrapper's struct format is the C struct's size (the sources
    static_assert the same numbers)."""
    assert ssd.ARGS.size == 248
    assert hsv_color.ARGS.size == 56
    assert moe_router.ARGS.size == 40
    assert rglru.ARGS.size == 72


def test_entry_point_refusals():
    z = torch.zeros
    with pytest.raises(ValueError, match="chunk"):
        ssd.ssd_bshp(z(1, 48, 2, 4), z(1, 48, 2), z(2), z(1, 48, 1, 4),
                     z(1, 48, 1, 4), chunk=32)
    with pytest.raises(ValueError, match="h0"):
        ssd.ssd_bshp(z(1, 32, 2, 4), z(1, 32, 2), z(2), z(1, 32, 1, 4),
                     z(1, 32, 1, 4), z(1, 2, 4, 3), chunk=32)
    with pytest.raises(ValueError, match="dt"):
        ssd.ssd_bshp(z(1, 32, 2, 4), z(1, 32, 3), z(2), z(1, 32, 1, 4),
                     z(1, 32, 1, 4), chunk=32)
    with pytest.raises(ValueError):
        ssd.ssd_bshp(z(1, 32, 2, 4, device="meta"), z(1, 32, 2, device="meta"),
                     z(2, device="meta"), z(1, 32, 1, 4, device="meta"),
                     z(1, 32, 1, 4, device="meta"), chunk=32)
    y, hl = ssd.ssd_bshp(z(0, 32, 2, 4), z(0, 32, 2), z(2), z(0, 32, 1, 4),
                         z(0, 32, 1, 4), chunk=32)
    assert tuple(y.shape) == (0, 32, 2, 4) and tuple(hl.shape) == (0, 2, 4, 4)


# --------------------------------------------------------------------------- #
# on the card                                                                 #
# --------------------------------------------------------------------------- #
def _close(got, want, **tol):
    torch.testing.assert_close(got, want, **(tol or TOL_TIGHT))
    assert not bool(torch.isnan(got).any())


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,p,g,n,chunk,h0_scale", [
    (2, 256, 2, 4, 1, 4, 64, 1.0),     # four chunks with a state
    (3, 64, 4, 16, 2, 16, 16, 1.0),    # the generic instance
    (2, 48, 2, 6, 1, 3, 24, 1.0),      # ragged P and N (scalar copies)
    (1, 45, 2, 4, 1, 4, 15, 0.0),      # an odd chunk
    (1, 128, 4, 64, 1, 32, 64, 1.0),   # tests/test_kernels.py's largest
    (1, 64, 2, 64, 1, 128, 64, 1.0),   # mamba2-370m's P and N: 115 KB a warp
])
def test_kernel_matches_plain_version_on_card(card, b, s, h, p, g, n, chunk,
                                             h0_scale):
    rng = np.random.default_rng(b * s + p)
    x, dt, A, Bm, Cm, h0 = (t.to(card) for t in map(
        _t, _inputs(rng, b, s, h, p, g, n)))
    h0 = h0 * h0_scale
    before = ssd.launches
    y, hl = ssd.ssd_bshp(x, dt, A, Bm, Cm, h0, chunk=chunk)
    y2, hl2 = ssd.ssd_bhcp(x.transpose(1, 2), dt.transpose(1, 2), A,
                           Bm.transpose(1, 2), Cm.transpose(1, 2), h0,
                           chunk=chunk)
    y_p, h_p = ref.ssd(x, dt, A, Bm, Cm, h0, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd.launches == before + 2
    _close(y, y_p)
    _close(hl, h_p)
    assert torch.equal(y2.transpose(1, 2), y) and torch.equal(hl2, hl)


@pytest.mark.gpu
def test_predicate_layout_is_one_launch_and_no_copy(card):
    """ops.ssd on ssd_inputs' own views (stride-0 dt, no h0) launches once
    and allocates only y and h_last; strided views give the same bits."""
    toks = lib.token_ids(_triage_tokens(64), 64, 256, card)
    x, dt, A, Bm, Cm = lib.ssd_inputs(lib.ssd_tables(device=card), toks)
    assert dt.stride(-1) == 0
    ops.ssd(x, dt, A, Bm, Cm)   # warm: the library is loaded
    torch.cuda.synchronize()
    stats = torch.cuda.memory_stats
    before = (ssd.launches, stats()["allocation.all.allocated"])
    y, hl = ops.ssd(x, dt, A, Bm, Cm)
    after = (ssd.launches, stats()["allocation.all.allocated"])
    assert after[0] == before[0] + 1 and after[1] - before[1] == 2
    y_p, h_p = ref.ssd(x, dt, A, Bm, Cm, None)
    _close(y, y_p)
    _close(hl, h_p)
    torch.testing.assert_close(lib.row_mean(y), lib.row_mean(y_p), rtol=0,
                               atol=SCORE_ATOL)
    xs, dts, bs, cs = strided_views(x, dt, Bm, Cm, heads=2)
    ys, hs = ops.ssd(xs, dts, A, bs, cs)
    assert torch.equal(ys, y) and torch.equal(hs, hl)


@pytest.mark.gpu
def test_rows_do_not_depend_on_the_batch(card):
    toks = lib.token_ids(_triage_tokens(4096), 64, 256, card)
    tables = lib.ssd_tables(device=card)
    whole, whole_h = ssd.ssd_bshp(*lib.ssd_inputs(tables, toks))
    for lo, hi in ((0, 1), (7, 8), (100, 116), (4095, 4096)):
        y, hl = ssd.ssd_bshp(*lib.ssd_inputs(tables, toks[lo:hi]))
        assert torch.equal(y, whole[lo:hi]) and torch.equal(hl, whole_h[lo:hi])
