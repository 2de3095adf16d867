"""The SSD scan's gradient in the port against the JAX package.

The same numpy draws go through ``repro`` (the reference differentiates
its plain scan, ``repro.kernels.ref.ssd``, with ``jax.grad``) and
``repro_torch`` on the CPU:

* ``ref.ssd_bwd`` (the closed form, in the stages of the gradient kernel)
  against ``jax.grad`` of the reference's ``ref.ssd`` and against torch's
  autograd through the port's ``ref.ssd``, with and without h0 and a
  cotangent of the last state, at (2, 128, 4, 8, G 2, N 16) with chunk 64
  and at the predicates' P = N = 4;
* the autograd function ``kernels.ssd.Ssd`` behind ``ssd_bshp`` and
  ``ssd_bhcp``: its gradients are ``ref.ssd_bwd``'s on the CPU, in the
  inputs' dtypes, and a cotangent autograd leaves out is zero;
* a shape the gradient kernel refuses raises ``ValueError`` before the
  forward runs, on the CPU too.

dt's gradient is a difference of large terms (an element of 0.03 formed
from terms up to 200), so it is held to 1e-4 |want| + 1e-5 max |want|
(scaled), as the flash gradient's float32 check is; everything else
to ``TOL_TIGHT``. Tests marked ``gpu`` hold the gradient kernel
(``csrc/ssd_bwd.cu``, 3xTF32 products on the tensor cores) to the plain
version at ragged shapes and with one cotangent only, every gradient to
that scaled rule (at mamba2's widths the float32 plain version itself
misses ``TOL_TIGHT`` against a float64 evaluation on a few hundred
elements: sums of ~100 terms that cancel), at mamba2's widths to a
float64 evaluation no worse than the plain version (``float64_shares``),
and to its own bits on a rerun, and skip without a card. JAX is imported
inside a fixture.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref, ssd

torch.set_num_threads(1)

TOL_TIGHT = dict(rtol=1e-4, atol=1e-5)
NAMES = ("dx", "ddt", "dA", "dB", "dC", "dh0")


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from repro.kernels import ref as jax_ref
    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, ref=jax_ref)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _draws(seed, b, s, h, p, g, n):
    """x, dt (softplus of a normal: positive), A (negative), B, C, h0 and
    the cotangents of y and of the last state, float32 numpy."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    x = normal(b, s, h, p)
    dt = np.log1p(np.exp(normal(b, s, h) - 1.0)).astype(np.float32)
    A = -np.exp(normal(h)).astype(np.float32)
    return (x, dt, A, normal(b, s, g, n), normal(b, s, g, n),
            normal(b, h, p, n), normal(b, s, h, p), normal(b, h, p, n))


def float64_shares(got, want, exact):
    """Phase 3's float64 rule: per gradient, the kernel's largest share of
    1e-4 |exact| + 1e-5 max |exact| and the float32 plain version's; the
    kernel's may be no more than twice the plain version's, or 0.1."""
    def share(a, e):
        a, e = a.double(), e.double()
        lim = 1e-4 * e.abs() + 1e-5 * e.abs().max()
        return float(((a - e).abs() / lim).max())
    return {name: (share(g, e), share(w, e))
            for name, g, w, e in zip(NAMES, got, want, exact) if e is not None}


def assert_grads_close(got, want, what="", scaled=("ddt",)):
    """Each gradient within ``TOL_TIGHT``, those named in ``scaled`` within
    1e-4 |want| + 1e-5 max |want|; a None where the other is None."""
    for name, g, w in zip(NAMES, got, want):
        if w is None:
            assert g is None, name
            continue
        g = np.asarray(g.detach().float().cpu() if torch.is_tensor(g) else g)
        w = np.asarray(w.detach().float().cpu() if torch.is_tensor(w) else w)
        assert g.shape == w.shape, name
        if name in scaled:
            lim = 1e-4 * np.abs(w) + 1e-5 * np.abs(w).max()
            assert (np.abs(g - w) <= lim).all(), f"{what} {name}"
        else:
            np.testing.assert_allclose(g, w, **TOL_TIGHT,
                                       err_msg=f"{what} {name}")


# (B, S, H, P, G, N), chunk 64; (with h0, with a cotangent of h_last)
GRAD_SHAPES = {"(2, 128, 4, 8, G 2, N 16)": (2, 128, 4, 8, 2, 16),
               "predicate P = N = 4": (2, 64, 2, 4, 1, 4)}
COTANGENTS = [(True, True), (True, False), (False, True), (False, False)]


def _jax_grads(jx, x, dt, A, Bm, Cm, h0, dy, dh_last):
    def loss(x, dt, A, Bm, Cm, *h):
        y, last = jx.ref.ssd(x, dt, A, Bm, Cm, h[0] if h else None,
                             chunk=64)
        extra = 0.0 if dh_last is None else jx.jnp.sum(last * dh_last)
        return jx.jnp.sum(y * dy) + extra

    args = (x, dt, A, Bm, Cm) + (() if h0 is None else (h0,))
    grads = jx.jax.grad(loss, argnums=tuple(range(len(args))))(*args)
    return [np.asarray(g) for g in grads] + ([None] if h0 is None else [])


def _case(seed, shape, with_h0, with_dh_last):
    x, dt, A, Bm, Cm, h0, dy, dh_last = _draws(seed, *shape)
    return (x, dt, A, Bm, Cm, h0 if with_h0 else None, dy,
            dh_last if with_dh_last else None)


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("with_h0,with_dh_last", COTANGENTS)
@pytest.mark.parametrize("shape", sorted(GRAD_SHAPES))
def test_ssd_bwd_matches_jax(jx, shape, with_h0, with_dh_last):
    args = _case(3, GRAD_SHAPES[shape], with_h0, with_dh_last)
    got = ref.ssd_bwd(*map(_t, args), chunk=64)
    assert (got[5] is None) == (not with_h0)
    assert_grads_close(got, _jax_grads(jx, *args), shape)


@pytest.mark.parametrize("with_h0,with_dh_last", COTANGENTS)
@pytest.mark.parametrize("shape", sorted(GRAD_SHAPES))
def test_ssd_bwd_matches_torch_autograd(shape, with_h0, with_dh_last):
    x, dt, A, Bm, Cm, h0, dy, dh_last = map(
        _t, _case(4, GRAD_SHAPES[shape], with_h0, with_dh_last))
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, Bm, Cm)]
    h = None if h0 is None else h0.clone().requires_grad_()
    y, last = ref.ssd(*leaves, h, chunk=64)
    outs, cots = [y], [dy]
    if dh_last is not None:
        outs.append(last)
        cots.append(dh_last)
    want = list(torch.autograd.grad(outs, leaves + ([] if h is None else [h]),
                                    cots)) + ([None] if h is None else [])
    assert_grads_close(ref.ssd_bwd(x, dt, A, Bm, Cm, h0, dy, dh_last,
                                   chunk=64), want, shape)


def _through(layout: str, leaves, h0, chunk: int):
    """(y, h_last) of the wrapper ``layout`` on the (B, S, H, P) leaves
    (``ssd_bhcp`` on their (B, H, S, P) views), y back in (B, S, H, P)."""
    if layout == "bshp":
        return ssd.ssd_bshp(*leaves, h0, chunk=chunk)
    x, dt, A, Bm, Cm = leaves
    y, last = ssd.ssd_bhcp(x.transpose(1, 2), dt.transpose(1, 2), A,
                           Bm.transpose(1, 2), Cm.transpose(1, 2), h0,
                           chunk=chunk)
    return y.transpose(1, 2), last


@pytest.mark.parametrize("with_h0,with_dh_last", [(True, True),
                                                  (False, False)])
@pytest.mark.parametrize("layout", ["bshp", "bhcp"])
def test_autograd_function_gives_ref_ssd_bwd(layout, with_h0, with_dh_last):
    """On the CPU ``Ssd``'s gradients are ``ref.ssd_bwd``'s bit for bit,
    through either layout, and nothing is launched."""
    x, dt, A, Bm, Cm, h0, dy, dh_last = map(
        _t, _case(5, (2, 96, 4, 8, 2, 16), with_h0, with_dh_last))
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, Bm, Cm)]
    h = None if h0 is None else h0.clone().requires_grad_()
    before = (ssd.launches, ssd.backward_launches)
    y, last = _through(layout, leaves, h, 32)
    with torch.no_grad():
        plain = ref.ssd(x, dt, A, Bm, Cm, h0, chunk=32)
    assert torch.equal(y, plain[0]) and torch.equal(last, plain[1])
    outs, cots = [y], [dy]
    if dh_last is not None:
        outs.append(last)
        cots.append(dh_last)
    got = torch.autograd.grad(outs, leaves + ([] if h is None else [h]),
                              cots)
    assert (ssd.launches, ssd.backward_launches) == before   # the CPU
    want = ref.ssd_bwd(x, dt, A, Bm, Cm, h0, dy, dh_last, chunk=32)
    for name, g, w in zip(NAMES, got, want):
        assert torch.equal(g, w), name


def test_autograd_dtypes_and_missing_cotangents():
    """bf16 x, B and C beside float32 dt, A and h0: y bf16, h_last
    float32, each gradient in its input's dtype (the float32 gradient
    rounded once); h_last left out of the loss, then y, is a zero
    cotangent."""
    x, dt, A, Bm, Cm, h0, dy, dh_last = map(
        _t, _draws(6, 2, 64, 4, 8, 1, 16))
    bf = torch.bfloat16
    leaves = [x.to(bf).requires_grad_(), dt.clone().requires_grad_(),
              A.clone().requires_grad_(), Bm.to(bf).requires_grad_(),
              Cm.to(bf).requires_grad_(), h0.clone().requires_grad_()]
    y, last = ssd.ssd_bshp(*leaves, chunk=64)
    assert (y.dtype, last.dtype) == (bf, torch.float32)
    f32 = [t.detach().float() for t in leaves]
    for outs, cots, dyw, dhw in (([y], [dy.to(bf)], dy.to(bf).float(), None),
                                 ([last], [dh_last], None, dh_last)):
        grads = torch.autograd.grad(outs, leaves, cots, retain_graph=True)
        assert [g.dtype for g in grads] == [t.dtype for t in leaves]
        want = ref.ssd_bwd(*f32, dyw, dhw, chunk=64)
        for name, g, w in zip(NAMES, grads, want):
            assert torch.equal(g, w.to(g.dtype)), name


@pytest.mark.parametrize("layout", ["bshp", "bhcp"])
@pytest.mark.parametrize("shape,chunk", [((1, 64, 2, 128, 1, 128), 64),
                                         ((1, 128, 2, 4, 1, 4), 128)])
def test_gradient_refuses_a_shape_before_the_forward(layout, shape, chunk,
                                                     monkeypatch):
    """P = N = 128 (the gradient's tiles outgrow a CTA's shared memory) and
    chunk 128 (past the kernel's 64): the forward takes both, the
    gradient neither, and the CPU refuses it as the card does, before
    the forward runs."""
    x, dt, A, Bm, Cm, h0, _, _ = map(_t, _draws(7, *shape))
    leaves = [x, dt, A, Bm, Cm]
    with torch.no_grad():
        _through(layout, leaves, h0, chunk)   # the forward takes it
    leaves[0] = x.clone().requires_grad_()
    before = ssd.launches
    calls = []
    plain = ref.ssd
    monkeypatch.setattr(ref, "ssd",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    with pytest.raises(ValueError, match="ssd gradient"):
        _through(layout, leaves, h0, chunk)
    assert not calls and ssd.launches == before


def test_ssd_bwd_evaluates_float64_inputs_in_float64():
    """The yardstick the card's checks can take: float64 inputs give
    float64 gradients, and the float32 evaluation lies within the scaled
    rule of them."""
    args = _case(10, (2, 128, 4, 8, 2, 16), True, True)
    got = ref.ssd_bwd(*(torch.from_numpy(a.astype(np.float64)) for a in args),
                      chunk=64)
    assert {g.dtype for g in got} == {torch.float64}
    assert_grads_close(ref.ssd_bwd(*map(_t, args), chunk=64), got,
                       scaled=NAMES)


def test_grad_smem_bytes_at_the_model_shapes():
    """mamba2 (chunk 64, P 64, N 128), the reduced configs (16, 16) and
    the predicates (4, 4) fit a CTA's 227 KB; P = N = 128 does not. The
    tiles are rounded up to the fragments' multiples (L and P to 16, N to
    32) and each row is 4 floats longer."""
    for p, n in ((64, 128), (16, 16), (4, 4), (64, 64)):
        assert ssd.grad_smem_bytes(64, p, n) <= ssd.SMEM_LIMIT
    assert ssd.grad_smem_bytes(64, 64, 128) == 4 * (
        2 * 64 * 68 + 2 * 64 * 132 + 2 * 64 * 132 + 2 * 64 * 68 + 4 * 64
        + 2 * 4 * 64 + 4 * 64 + 4 * 64 + 16)
    assert ssd.grad_smem_bytes(50, 7, 9) == ssd.grad_smem_bytes(64, 16, 32)
    assert ssd.grad_smem_bytes(64, 128, 128) > ssd.SMEM_LIMIT


@pytest.mark.parametrize("b,s,h,g,want", [
    (4, 512, 32, 1, 8),    # mamba2's step: H / G = 32, 128 CTAs, one wave
    (8, 512, 32, 1, 8),
    (4, 512, 12, 1, 3),    # H / G = 12: 3 heads a CTA, 128 CTAs
    (4, 512, 3, 1, 1),     # H / G = 3: 3 heads a CTA would add two waves
    (4, 512, 8, 8, 1),     # H / G = 1 (G = H): one head a CTA
    (2, 512, 8, 2, 1),     # 128 CTAs already one wave
    (16, 64, 2, 1, 1),     # the predicates'
    (8, 512, 24, 2, 6),    # H / G = 12 in each of two groups
])
def test_cta_heads_from_the_shape(b, s, h, g, want):
    """A CTA of the gradient's per-chunk stage takes K consecutive heads of
    a group in turn and sums their dB and dC shares into one partial: K
    is the divisor of H / G up to 8 whose waves of CTAs on 132 SMs, times
    K, are least (the largest of those that tie), decided by the shape
    alone; the ordered sums then take H / K partials a (b, s)."""
    k = ssd.cta_heads(b, s, h, g, 64)
    assert k == want
    assert (h // g) % k == 0 and k <= ssd.MAX_CTA_HEADS
    ctas = b * (s // 64) * h

    def head_times(c):
        return -(-ctas // c // ssd.SMS) * c
    assert all(head_times(k) <= head_times(c) for c in range(1, 9)
               if (h // g) % c == 0)


# --------------------------------------------------------------------------- #
# on the card                                                                 #
# --------------------------------------------------------------------------- #
# (B, S, H, P, G, N, chunk): P and N not multiples of 4 or of a warp, G = H
# and G < H, a chunk of 50 and of 1, the predicate's, mamba2's widths
# and H / G = 32 and 12 at mamba2's batch and length (8 and 3 heads a CTA
# of the per-chunk stage, the others one)
CARD_SHAPES = [(3, 96, 6, 12, 3, 20, 32), (2, 150, 4, 7, 2, 9, 50),
               (1, 64, 2, 4, 1, 4, 64), (2, 5, 3, 33, 3, 5, 1),
               (1, 128, 32, 64, 1, 128, 64), (4, 512, 32, 16, 1, 32, 64),
               (4, 512, 12, 16, 1, 32, 64)]


def _on(card, args):
    return [None if a is None else torch.from_numpy(a).to(card) for a in args]


def _twice(args, chunk=64):
    """Two kernel calls on the same inputs, one launch of the gradient
    kernel each: their gradients are the same bits (no atomics)."""
    before = ssd.backward_launches
    got = ssd.ssd_bwd(*args, chunk=chunk)
    again = ssd.ssd_bwd(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd.backward_launches == before + 2
    for name, g, a in zip(NAMES, got, again):
        assert (g is None and a is None) or torch.equal(g, a), name
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("with_h0,with_dh_last", [(True, True),
                                                  (False, False)])
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_ssd_bwd_kernel_matches_plain(card, shape, with_h0, with_dh_last):
    *dims, chunk = shape
    args = _on(card, _case(8, dims, with_h0, with_dh_last))
    got = _twice(args, chunk)
    want = ref.ssd_bwd(*args, chunk=chunk)
    assert_grads_close(got, want, str(shape), scaled=NAMES)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_ssd_bwd_parts_is_the_cta_heads_rule(card, shape):
    """The partials of dB and dC a (b, s) the kernel writes
    (``ssd_bwd_parts``) are H / K, K from ``ssd.cta_heads``: the scratch
    the wrapper sizes holds them."""
    from repro_torch.kernels import _build
    b, s, h, p, g, n, chunk = shape
    parts = _build.load("ssd_bwd").lib.ssd_bwd_parts(b, s, h, g, chunk)
    assert parts == h // ssd.cta_heads(b, s, h, g, chunk)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["bshp", "bhcp"])
def test_ssd_autograd_on_the_card_through_strided_views(card, layout):
    """The model's strided (B, S, H, P) views (x a slice of a wider
    tensor, dt broadcast over heads) and G = 2, through the autograd
    function: one forward launch and one gradient call, the gradients
    the plain version's."""
    b, s, h, p, g, n = 2, 128, 4, 16, 2, 16
    x, dt, A, Bm, Cm, h0, dy, dh_last = (
        torch.from_numpy(a).to(card) for a in _draws(9, b, s, h, p, g, n))
    dt1 = dt[..., :1].expand(b, s, h)                   # broadcast dt
    leaves = [x.clone().requires_grad_(), dt1.detach().requires_grad_(),
              A.clone().requires_grad_(), Bm.clone().requires_grad_(),
              Cm.clone().requires_grad_()]
    strided = torch.cat([leaves[0], leaves[0]], dim=-1)[..., :p]   # a view
    counts = (ssd.launches, ssd.backward_launches)
    y, last = _through(layout, [strided, *leaves[1:]], h0, 64)
    grads = torch.autograd.grad([y, last], leaves, [dy, dh_last])
    torch.cuda.synchronize()
    assert (ssd.launches - counts[0],
            ssd.backward_launches - counts[1]) == (1, 1)
    want = ref.ssd_bwd(*(t.detach() for t in leaves), h0, dy, dh_last,
                       chunk=64)
    assert_grads_close(list(grads) + [None],
                       list(want[:5]) + [None], layout, scaled=NAMES)


@pytest.mark.gpu
def test_ssd_bwd_kernel_against_float64_at_mamba2_width(card):
    """mamba2's widths (P 64, G 1, N 128) cut to 4 heads and 256 steps,
    with h0 and a cotangent of h_last: every gradient within the scaled
    rule of the float32 plain version, and against a float64 evaluation
    no worse than it by phase 3's rule."""
    args = _on(card, _case(11, (1, 256, 4, 64, 1, 128), True, True))
    got = _twice(args)
    want = ref.ssd_bwd(*args, chunk=64)
    exact = ref.ssd_bwd(*(t.double() for t in args), chunk=64)
    assert_grads_close(got, want, "mamba2 width", scaled=NAMES)
    for name, (kernel, plain) in float64_shares(got, want, exact).items():
        assert kernel <= max(0.1, 2 * plain), (name, kernel, plain)


@pytest.mark.gpu
@pytest.mark.parametrize("cotangent", ["y", "h_last"])
def test_ssd_bwd_kernel_with_one_cotangent(card, cotangent):
    """Only the y-cotangent (no h_last), or only h_last's (dy None: the
    wrapper passes a zero with all-zero strides), with an h0: the plain
    version's gradients, dh0 included, and the same bits on a rerun."""
    x, dt, A, Bm, Cm, h0, dy, dh_last = _on(
        card, _draws(12, 2, 192, 4, 64, 2, 128))
    if cotangent == "y":
        dh_last = None
    else:
        dy = None
    args = (x, dt, A, Bm, Cm, h0, dy, dh_last)
    got = _twice(args)
    assert_grads_close(got, ref.ssd_bwd(*args, chunk=64), cotangent,
                       scaled=NAMES)
