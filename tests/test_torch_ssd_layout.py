"""The SSD kernel's strided entry points, its orders of summation and its
packed arguments, as plain code on the CPU; and the kernel against its
plain version on the card.

On the CPU: ``ops.ssd`` on the predicate's own layout (a dt broadcast over
heads, a non-contiguous x, no h0) equals the JAX package's ``ops.ssd``
(plain and Pallas in interpret mode); ``ssd_bshp`` and ``ssd_bhcp`` agree;
the strides the wrappers pack address exactly the elements of each
operand. Numpy emulations of the kernel's two designs, in their orders:
at P = N = 4 (``emulate_kernel``: the warp scan of dt * A, each row's
(row, m) steps in index order, the xor butterfly of the state) within
``TOL_TIGHT`` of ``ref.ssd``, and its scores within ``SCORE_ATOL`` over
2,048 rows of the triage table at the library's shapes, with every
decision kept; at every other shape (``emulate_stages``: cum in order,
the chunk states, the pass over the chunks, the per-chunk outputs, every
product as 3xTF32) within ``TOL_TIGHT`` of ``ref.ssd`` and of the JAX
package's scan, and on the card check's inputs at mamba2's full scan,
while one TF32 product a pair misses it at mamba2's P and N; the counts
of operations and scratch the wrappers give. Tests marked ``gpu`` run the
CUDA kernel and skip without a card. Run as a script, it prints the
stages' largest share of ``TOL_TIGHT``'s limit on both sets of inputs.
"""
import pathlib
import re
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


def tf32_round(a: np.ndarray) -> np.ndarray:
    """float32 -> TF32 as the kernel's ``to_tf32`` rounds it: add half of
    the 13 dropped bits' unit, then drop them."""
    u = np.ascontiguousarray(a, F32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(F32)


def tf32_trunc(a: np.ndarray) -> np.ndarray:
    """float32 -> TF32 as the tensor cores read an operand: the top 19
    bits."""
    u = np.ascontiguousarray(a, F32).view(np.uint32)
    return (u & np.uint32(0xFFFFE000)).view(F32)


def product_3xtf32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a @ b (float32, batched) as the kernel's ``mma3``: each operand split
    into hi (TF32, rounded) and lo (the rest, truncated to TF32 by the
    tensor cores), hi.hi summed apart from lo.hi + hi.lo."""
    ah, bh = tf32_round(a), tf32_round(b)
    al, bl = tf32_trunc(a - ah), tf32_trunc(b - bh)
    return (ah @ bh) + (al @ bh + ah @ bl)


def product_1xtf32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a @ b with one TF32 product (hi.hi alone): the kernel with the
    split's corrections dropped."""
    return tf32_round(a) @ tf32_round(b)


def emulate_stages(x, dt, A, Bm, Cm, h0, chunk: int,
                   product=product_3xtf32):
    """The stage design's arithmetic on float32 numpy (model layout), in
    its order: cum summed in order; stage 1's S_c = (ex dt x)^T B; stage
    2's pass h_in(c + 1) = exp(cum_L) h_in(c) + S_c from h0 (or 0); stage
    3's y = ((C B^T) o W) x + e (C h_in^T), W_lm = exp(cum_l - cum_m) dt_m
    on m <= l (exp taken there only) and e_l = exp(cum_l). Every product
    goes through ``product``; numpy's exp for expf. Returns (y, h_last)."""
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    L, nc, rep = chunk, s // chunk, h // g

    def per_chunk(t, last):      # (B, S, H, last) -> (B, H, NC, L, last)
        return t.reshape(b, nc, L, h, last).transpose(0, 3, 1, 2, 4)

    xc = per_chunk(x, p)
    dtc = dt.reshape(b, nc, L, h).transpose(0, 3, 1, 2)          # (B,H,NC,L)
    bc = per_chunk(np.repeat(Bm, rep, axis=2), n)
    cc = per_chunk(np.repeat(Cm, rep, axis=2), n)
    cum = np.empty_like(dtc)
    run = np.zeros(dtc.shape[:-1], F32)
    for l in range(L):
        run = run + dtc[..., l] * A[None, :, None]
        cum[..., l] = run
    ex_dt = np.exp(cum[..., -1:] - cum) * dtc
    states = product(np.swapaxes(xc * ex_dt[..., None], -1, -2), bc)
    state = (np.zeros((b, h, p, n), F32) if h0 is None
             else h0.astype(F32).copy())
    h_in = np.empty_like(states)
    for c in range(nc):
        h_in[:, :, c] = state
        state = np.exp(cum[:, :, c, -1])[..., None, None] * state \
            + states[:, :, c]
    lower = np.tril(np.ones((L, L), bool))
    seg = np.where(lower, cum[..., :, None] - cum[..., None, :], 0)
    wts = np.where(lower, np.exp(seg), 0).astype(F32)
    m = product(cc, np.swapaxes(bc, -1, -2)) * wts * dtc[..., None, :]
    ch = product(cc, np.swapaxes(h_in, -1, -2))
    y = product(m, xc) + np.exp(cum)[..., None] * ch
    return y.transpose(0, 2, 3, 1, 4).reshape(b, s, h, p), state


def emulate(x, dt, A, Bm, Cm, h0, chunk: int):
    """The emulation of the design the kernel takes at these shapes."""
    fn = emulate_kernel if Bm.shape[3] == 4 and x.shape[3] == 4 \
        else emulate_stages
    return fn(x, dt, A, Bm, Cm, h0, chunk)


def test_warp_scan_is_a_cumulative_sum(rng):
    e = rng.standard_normal((5, 64)).astype(F32)
    np.testing.assert_allclose(warp_scan(e), np.cumsum(e, -1, dtype=np.float64),
                               rtol=1e-5, atol=1e-5)
    for L in (1, 7, 33):   # a ragged chunk: the padding adds nothing
        np.testing.assert_array_equal(warp_scan(e[:, :L]), warp_scan(e)[:, :L])


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [
    (2, 64, 2, 4, 1, 4, 64),     # the predicate's shapes
    (2, 256, 2, 4, 1, 4, 64),    # four chunks
    (1, 64, 4, 16, 2, 8, 16),    # G < H: the stages
    (2, 48, 2, 6, 1, 3, 24),     # ragged P and N, an even chunk under 32
    (1, 45, 2, 4, 1, 4, 15),     # an odd chunk: a middle row
])
def test_kernel_order_matches_plain_version(rng, b, s, h, p, g, n, chunk):
    x, dt, A, Bm, Cm, h0 = _inputs(rng, b, s, h, p, g, n)
    y, hl = emulate(x, dt, A, Bm, Cm, h0, chunk)
    y_p, h_p = ref.ssd(*map(_t, (x, dt, A, Bm, Cm, h0)), chunk=chunk)
    np.testing.assert_allclose(y, y_p.numpy(), **TOL_TIGHT)
    np.testing.assert_allclose(hl, h_p.numpy(), **TOL_TIGHT)


MAMBA2_PN = (1, 128, 2, 64, 1, 128, 64)   # mamba2-370m's P and N, two chunks
STAGE_CASES = [
    (1, 64, 4, 16, 2, 8, 16),    # G = 2
    (2, 48, 2, 6, 1, 3, 24),     # ragged P and N
    (1, 45, 2, 6, 1, 5, 15),     # an odd chunk, ragged P and N
    (2, 128, 2, 16, 1, 32, 64),  # chunks of 64
    MAMBA2_PN,
]


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("b,s,h,p,g,n,chunk", STAGE_CASES)
def test_stage_order_matches_plain_version_and_jax(jx, rng, impl, b, s, h, p,
                                                   g, n, chunk):
    """emulate_stages (with an h0) within TOL_TIGHT of ref.ssd and of the
    JAX package's scan: its plain version (xla) and ssd_bhcp, the Pallas
    kernel in interpret mode (pallas)."""
    x, dt, A, Bm, Cm, h0 = _inputs(rng, b, s, h, p, g, n)
    y, hl = emulate_stages(x, dt, A, Bm, Cm, h0, chunk)
    y_p, h_p = ref.ssd(*map(_t, (x, dt, A, Bm, Cm, h0)), chunk=chunk)
    np.testing.assert_allclose(y, y_p.numpy(), **TOL_TIGHT)
    np.testing.assert_allclose(hl, h_p.numpy(), **TOL_TIGHT)
    jy, jh = jx.ops.ssd(*map(jx.jnp.asarray, (x, dt, A, Bm, Cm, h0)),
                        chunk=chunk, impl=impl)
    np.testing.assert_allclose(y, np.asarray(jy, F32), **TOL_TIGHT)
    np.testing.assert_allclose(hl, np.asarray(jh, F32), **TOL_TIGHT)


def test_one_tf32_product_misses_the_rule_at_mamba2_widths(rng):
    """The stages with one TF32 product a pair (the kernel without the
    split's corrections) fall outside TOL_TIGHT of ref.ssd at mamba2's P
    and N, so the rule that holds the kernel can refuse that mutant."""
    x, dt, A, Bm, Cm, h0 = _inputs(rng, *MAMBA2_PN[:6])
    y_p, h_p = ref.ssd(*map(_t, (x, dt, A, Bm, Cm, h0)), chunk=MAMBA2_PN[6])
    y, hl = emulate_stages(x, dt, A, Bm, Cm, h0, MAMBA2_PN[6],
                           product=product_1xtf32)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(y, y_p.numpy(), **TOL_TIGHT)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(hl, h_p.numpy(), **TOL_TIGHT)


def mamba2_card_inputs(h0: bool = True):
    """(x, dt, A, Bm, Cm, h0) at mamba2-370m's scan (4, 512, 32, 64, G 1,
    N 128), drawn as ``chip_smoke.py``'s phase 3 draws them (x, B and C as
    silu outputs, dt softplus(~0), seeds 21 and 22), float32 numpy."""
    rng = np.random.default_rng(21)
    b, s, h, p, g, n = 4, 512, 32, 64, 1, 128
    x = (rng.standard_normal((b, s, h, p)) * 0.5).astype(F32)
    dt = rng.uniform(0.5, 1.0, (b, s, h)).astype(F32)
    A = (-np.exp(np.full(h, 0.1))).astype(F32)
    Bm = (rng.standard_normal((b, s, g, n)) * 0.3).astype(F32)
    Cm = (rng.standard_normal((b, s, g, n)) * 0.3).astype(F32)
    init = np.random.default_rng(22).standard_normal(
        (b, h, p, n)).astype(F32) if h0 else None
    return x, dt, A, Bm, Cm, init


def share_of_rule(inputs, chunk: int = 64) -> float:
    """The largest share of TOL_TIGHT's limit that an element of
    emulate_stages' y or h_last takes against ref.ssd's."""
    got = emulate_stages(*inputs, chunk)
    want = ref.ssd(*(None if a is None else _t(a) for a in inputs),
                   chunk=chunk)
    share = 0.0
    for g, w in zip(got, want):
        w = w.numpy().astype(np.float64)
        limit = TOL_TIGHT["atol"] + TOL_TIGHT["rtol"] * np.abs(w)
        share = max(share, float((np.abs(g - w) / limit).max()))
    return share


@pytest.mark.parametrize("h0", [True, False])
def test_stage_order_within_the_rule_on_the_cards_inputs(h0):
    """emulate_stages within TOL_TIGHT of ref.ssd on the inputs the card's
    check holds the kernel to at mamba2's full scan."""
    assert share_of_rule(mamba2_card_inputs(h0)) <= 1.0


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
    assert rglru.ARGS.size == 96
    # RglruArgs: the source's static_assert names the same size and format
    src = (pathlib.Path(rglru.__file__).parent / "csrc" / "rglru.cu").read_text()
    size, fmt = re.search(r'static_assert\(sizeof\(RglruArgs\) == (\d+),\s*'
                          r'"RglruArgs must match (\S+)"', src).groups()
    assert int(size) == rglru.ARGS.size and fmt == rglru.ARGS.format


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (4, 512, 32, 64, 128, 64),   # mamba2-370m's scan
    (4, 64, 2, 4, 4, 64),        # the predicate's
    (2, 45, 2, 6, 5, 15),        # an odd chunk
])
def test_flops_count_the_chunked_work(b, s, h, p, n, chunk):
    """ssd.flops is the stages' multiply-adds, row by row, two operations
    each: a row adds x_l B_l^T to its chunk's state and forms C_l h_in^T
    (P N each), and takes C_l . B_m and its share of x_m for every m <= l
    of its chunk (N + P each)."""
    per_chunk = sum(2 * p * n + (l + 1) * (n + p) for l in range(chunk))
    assert ssd.flops(b, s, h, p, n, chunk) == \
        2 * b * h * (s // chunk) * per_chunk
    if (p, n) == (64, 128):
        assert ssd.flops(b, s, h, p, n, chunk) == 2_965_372_928


def test_scratch_is_the_stages_but_at_the_predicates_shapes():
    """One forward call's scratch: none at P = N = 4 (one launch), else the
    chunk states then each chunk's cum (``launch_stages``)."""
    assert ssd.scratch_floats(4, 2, 64, 4, 4, 64) == 0
    assert ssd.stage_floats(4, 2, 64, 4, 4, 64) == 4 * 2 * 4 * 4 + 4 * 2 * 64
    assert ssd.scratch_floats(4, 32, 512, 64, 128, 64) == \
        ssd.stage_floats(4, 32, 512, 64, 128, 64) == \
        4 * 32 * 8 * 64 * 128 + 4 * 32 * 512


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
@pytest.mark.parametrize("b,s,h,p,g,n,chunk,h0_scale,strided", [
    (2, 256, 2, 4, 1, 4, 64, 1.0, False),     # four chunks with a state
    (3, 64, 4, 16, 2, 16, 16, 1.0, False),    # G < H: the stages
    (2, 48, 2, 6, 1, 3, 24, 1.0, False),      # ragged P and N (scalar copies)
    (1, 45, 2, 4, 1, 4, 15, 0.0, False),      # an odd chunk
    (1, 128, 4, 64, 1, 32, 64, 1.0, False),   # tests/test_kernels.py's largest
    (1, 64, 2, 64, 1, 128, 64, 1.0, False),   # mamba2-370m's P and N
    (4, 512, 32, 64, 1, 128, 64, 1.0, False),   # mamba2-370m's scan, an h0
    (4, 512, 32, 64, 1, 128, 64, None, False),  # and no h0, as the model
    (2, 512, 8, 64, 2, 128, 64, 1.0, True),   # G = 2 on strided views
    (2, 128, 4, 72, 2, 136, 32, 1.0, False),  # P, N past a block, not x 16
])
def test_kernel_matches_plain_version_on_card(card, b, s, h, p, g, n, chunk,
                                             h0_scale, strided):
    """Both entry points against ref.ssd within TOL_TIGHT, one count a
    call, and the same bits from the (B, H, S, P) layout and on a
    rerun."""
    rng = np.random.default_rng(b * s + p)
    x, dt, A, Bm, Cm, h0 = (t.to(card) for t in map(
        _t, _inputs(rng, b, s, h, p, g, n)))
    h0 = None if h0_scale is None else h0 * h0_scale
    if strided:
        x, dt, Bm, Cm = strided_views(x, dt, Bm, Cm, heads=h)
    before = ssd.launches
    y, hl = ssd.ssd_bshp(x, dt, A, Bm, Cm, h0, chunk=chunk)
    y2, hl2 = ssd.ssd_bhcp(x.transpose(1, 2), dt.transpose(1, 2), A,
                           Bm.transpose(1, 2), Cm.transpose(1, 2), h0,
                           chunk=chunk)
    y3, hl3 = ssd.ssd_bshp(x, dt, A, Bm, Cm, h0, chunk=chunk)
    y_p, h_p = ref.ssd(x, dt, A, Bm, Cm, h0, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd.launches == before + 3
    _close(y, y_p)
    _close(hl, h_p)
    assert torch.equal(y2.transpose(1, 2), y) and torch.equal(hl2, hl)
    assert torch.equal(y3, y) and torch.equal(hl3, hl)


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


if __name__ == "__main__":
    # Where the stage design's error sits against TOL_TIGHT: the largest
    # share of the limit on the card's inputs at mamba2's scan and on this
    # file's inputs, each at the full shape and at MAMBA2_PN's (1, 128, 2).
    # Run as PYTHONPATH=src python tests/test_torch_ssd_layout.py.
    card_in = mamba2_card_inputs()
    test_in = _inputs(np.random.default_rng(0), 4, 512, 32, 64, 1, 128)
    for name, full in (("card's inputs", card_in), ("test inputs", test_in)):
        x, dt, A, Bm, Cm, h0 = full
        small = (x[:1, :128, :2], dt[:1, :128, :2], A[:2], Bm[:1, :128],
                 Cm[:1, :128], h0[:1, :2])
        print(f"{name}: full {share_of_rule(full)!r}, (1, 128, 2) "
              f"{share_of_rule(small)!r}")
