"""The flash attention gradient of the port against the JAX package's.

The JAX package trains through its plain XLA attention and lets JAX
differentiate it; the port's flash wrappers are a ``torch.autograd.Function``
whose backward is a hand-written kernel on the card and
``ref.flash_attention_bwd`` (explicit formulas) on the CPU. Here, in
float32 from numpy draws:

* the port's dQ, dK and dV (the autograd function on the CPU) against
  ``jax.grad`` of ``repro.kernels.ref.mha_attention(..., chunk_q=0)``:
  causal and not, window 0 and 16, GQA groups 1, 3 and 4, S = 64 and a
  ragged 100, non-causal Sq != Sk, and rows that see no key (where the
  JAX package's dense attention averages every value and the kernels
  write 0, so the JAX side gets no cotangent on those rows and the port's
  dQ there must be 0);
* ``ref.flash_attention_bwd`` against torch's autograd through
  ``ref.flash_attention_bshd``, and the (BH, S, D) entry against the
  (B, S, H, D) one;
* recurrentgemma's heads at D = 256 (GQA 16 on one kv head, a window),
  which the gradient kernel takes as the forward does
  (``MAX_BWD_HEAD_DIM``);
* every other kernel wrapper but the RG-LRU's (whose gradient is in
  tests/test_torch_train_families.py) refuses a gradient, on the CPU as
  on the card, and still serves under ``no_grad`` and ``inference_mode``.

Tests marked ``gpu`` hold the gradient kernel (``csrc/flash_attention_bwd.cu``)
and the forward's log-sum-exp to their plain versions on the card, and
skip without one: its bf16 instances (wgmma fed by a ring of stages) at
every padded D with GQA groups 1 and 4 and three masks, on the design
they should take (TMA for aligned operands, the producer warp's own loads
for an unaligned view), with Sk = 0 and rows that see no key, the same
bits on a rerun. JAX is imported inside a fixture.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import (_build, decode_attention, flash_attention,
                                 hsv_color, moe_router, ref, rglru, ssd)

torch.set_num_threads(1)

TOL_TIGHT = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from repro.kernels import ref as jax_ref
    return jax, jax_ref


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _draw(seed, b, sq, sk, h, hkv, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for shape in (
        (b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d), (b, sq, h, d))]


def _visible_rows(sq, sk, causal, window):
    i = np.arange(sq)[:, None]
    j = np.arange(sk)[None, :]
    vis = np.ones((sq, sk), bool)
    if causal:
        vis &= j <= i
    if window > 0:
        vis &= j > i - window
    return vis.any(1)


def _jax_grads(jx, q, k, v, w, causal, window):
    jax, jax_ref = jx
    jnp = jax.numpy

    def loss(q, k, v):
        out = jax_ref.mha_attention(q, k, v, causal=causal, window=window,
                                    chunk_q=0)
        return jnp.sum(out * w)

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


def _port_grads(q, k, v, w, causal, window):
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = flash_attention.flash_attention_bshd(qt, kt, vt, causal=causal,
                                               window=window)
    return [g.numpy() for g in torch.autograd.grad(
        out, (qt, kt, vt), torch.from_numpy(w))]


# (B, Sq, Sk, H, Hkv, D) x causal x window: groups 1, 3 and 4, S 64 and a
# ragged 100
GRAD_SHAPES = [(2, s, s, h, hkv, 16) for s in (64, 100)
               for h, hkv in ((4, 4), (6, 2), (8, 2))]


@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", GRAD_SHAPES)
def test_flash_grad_matches_jax(jx, shape, causal, window):
    b, sq, sk, h, hkv, d = shape
    q, k, v, w = _draw(sum(shape) + 7 * causal + window, *shape)
    want = _jax_grads(jx, q, k, v, w, causal, window)
    got = _port_grads(q, k, v, w, causal, window)
    for name, g, r in zip("qkv", got, want):
        np.testing.assert_allclose(g, r, **TOL_TIGHT, err_msg=f"d{name}")


@pytest.mark.parametrize("shape", [(2, 48, 80, 6, 3, 16), (1, 100, 36, 4, 1, 8)])
def test_flash_grad_noncausal_sq_ne_sk(jx, shape):
    q, k, v, w = _draw(3, *shape)
    want = _jax_grads(jx, q, k, v, w, False, 0)
    got = _port_grads(q, k, v, w, False, 0)
    for name, g, r in zip("qkv", got, want):
        np.testing.assert_allclose(g, r, **TOL_TIGHT, err_msg=f"d{name}")


# non-causal and windowed, more queries than keys: rows past Sk + window -
# 1 see no key
@pytest.mark.parametrize("shape,window", [((2, 64, 40, 4, 2, 16), 16),
                                          ((1, 100, 20, 6, 2, 8), 4)])
def test_flash_grad_empty_rows(jx, shape, window):
    b, sq, sk, h, hkv, d = shape
    q, k, v, w = _draw(11, *shape)
    seen = _visible_rows(sq, sk, False, window)
    assert not seen.all() and seen.any()
    w_seen = w * seen[None, :, None, None]
    want = _jax_grads(jx, q, k, v, w_seen, False, window)
    got = _port_grads(q, k, v, w_seen, False, window)
    for name, g, r in zip("qkv", got, want):
        np.testing.assert_allclose(g, r, **TOL_TIGHT, err_msg=f"d{name}")
    # a cotangent on the empty rows changes nothing: they add nothing and
    # their dQ is 0
    full = _port_grads(q, k, v, w, False, window)
    assert np.all(full[0][:, ~seen] == 0)
    for g, r in zip(full, got):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 8), (False, 0),
                                           (False, 8)])
@pytest.mark.parametrize("shape", [(2, 37, 37, 6, 2, 16), (1, 24, 40, 4, 4, 8)])
def test_plain_bwd_matches_torch_autograd(shape, causal, window):
    q, k, v, w = (torch.from_numpy(a) for a in _draw(5, *shape))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ref.flash_attention_bshd(*leaves, causal=causal, window=window)
    want = torch.autograd.grad(out, leaves, w)
    got = ref.flash_attention_bwd_bshd(q, k, v, out.detach(), w,
                                       causal=causal, window=window)
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, **TOL_TIGHT)


def test_bhsd_entry_gradient_matches_bshd():
    b, s, h, hkv, d = 2, 50, 6, 2, 16
    q, k, v, w = (torch.from_numpy(a) for a in _draw(9, b, s, s, h, hkv, d))

    def bhsd(t):
        return t.transpose(1, 2).reshape(-1, s, d).contiguous()

    lq, lk, lv = (t.clone().requires_grad_() for t in (q, k, v))
    out = flash_attention.flash_attention_bshd(lq, lk, lv, window=12)
    want = torch.autograd.grad(out, (lq, lk, lv), w)
    bq, bk, bv = (bhsd(t).requires_grad_() for t in (q, k, v))
    out = flash_attention.flash_attention_bhsd(bq, bk, bv, group=h // hkv,
                                               window=12)
    got = torch.autograd.grad(out, (bq, bk, bv), bhsd(w))
    for g, r in zip(got, want):
        torch.testing.assert_close(g, bhsd(r), rtol=0, atol=0)


# recurrentgemma's local attention: 16 query heads of 256 on one kv head,
# causal with a window, and a non-causal Sq != Sk case at D = 256
@pytest.mark.parametrize("shape,causal,window", [
    ((1, 48, 48, 16, 1, 256), True, 16),
    ((2, 40, 40, 4, 1, 256), True, 0),
    ((1, 24, 40, 4, 2, 256), False, 0),
])
def test_flash_grad_d256_matches_jax(jx, shape, causal, window):
    q, k, v, w = _draw(13, *shape)
    want = _jax_grads(jx, q, k, v, w, causal, window)
    got = _port_grads(q, k, v, w, causal, window)
    for name, g, r in zip("qkv", got, want):
        np.testing.assert_allclose(g, r, **TOL_TIGHT, err_msg=f"d{name}")


def test_the_gradient_takes_every_head_the_forward_takes():
    """The CPU and the card train the same heads: the gradient kernel's
    widest head is the forward's."""
    assert flash_attention.MAX_BWD_HEAD_DIM == flash_attention.MAX_HEAD_DIM


def test_cpu_gradient_launches_nothing():
    q, k, v, w = (torch.from_numpy(a) for a in _draw(1, 1, 20, 20, 4, 2, 8))
    before = (flash_attention.launches, flash_attention.backward_launches)
    leaves = [t.requires_grad_() for t in (q, k, v)]
    out = flash_attention.flash_attention_bshd(*leaves)
    torch.autograd.grad(out, leaves, w)
    assert (flash_attention.launches,
            flash_attention.backward_launches) == before


# --------------------------------------------------------------------------- #
# kernels without a backward refuse a gradient                                #
# --------------------------------------------------------------------------- #
def _refusal_cases():
    rng = np.random.default_rng(0)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    toks = torch.from_numpy(rng.integers(1, 16, (2, 6)).astype(np.int32))
    crops = torch.from_numpy(rng.uniform(0, 255, (2, 4, 4, 3)).astype(
        np.float32))
    ranges = torch.from_numpy(ref.COLOR_RANGES)
    lens = torch.tensor([3, 5], dtype=torch.int32)
    return {
        "hsv_color_hist": (hsv_color.hsv_color_hist, (crops, ranges), {}, 0),
        "moe_router_tk": (moe_router.moe_router_tk, (t(5, 8), 2), {}, 0),
        "moe_router_tokens": (moe_router.moe_router_tokens,
                              (toks, t(16, 4), t(4, 8), 2), {}, 2),
        "ssd_bshp": (ssd.ssd_bshp, (t(1, 8, 2, 4), t(1, 8, 2).abs(),
                                    -t(2).abs(), t(1, 8, 1, 4), t(1, 8, 1, 4)),
                     {"chunk": 4}, 0),
        "ssd_bhcp": (ssd.ssd_bhcp, (t(1, 2, 8, 4), t(1, 2, 8).abs(),
                                    -t(2).abs(), t(1, 1, 8, 4), t(1, 1, 8, 4),
                                    t(1, 2, 4, 4)), {"chunk": 4}, 0),
        "rglru_tokens": (rglru.rglru_tokens, (toks, t(16, 8), t(16, 8),
                                              t(16, 8), t(8)), {}, 1),
        "decode_attention_bkgd": (decode_attention.decode_attention_bkgd,
                                  (t(4, 2, 8), t(4, 6, 8), t(4, 6, 8), lens),
                                  {"num_kv_heads": 2}, 0),
        "decode_attention_bshd": (decode_attention.decode_attention_bshd,
                                  (t(2, 4, 8), t(2, 6, 2, 8), t(2, 6, 2, 8),
                                   lens), {}, 1),
    }


REFUSAL_CASES = sorted(_refusal_cases())


@pytest.mark.parametrize("name", REFUSAL_CASES)
def test_wrapper_without_backward_refuses_gradients(name):
    fn, args, kw, arg = _refusal_cases()[name]
    args = list(args)
    args[arg] = args[arg].clone().requires_grad_()
    with pytest.raises(RuntimeError, match="has no backward yet"):
        fn(*args, **kw)
    with torch.no_grad():
        fn(*args, **kw)
    with torch.inference_mode():
        fn(*(a.detach() if isinstance(a, torch.Tensor) else a for a in args),
           **kw)


# --------------------------------------------------------------------------- #
# on the card                                                                 #
# --------------------------------------------------------------------------- #
BWD_CASES = [  # (B, H, Hkv, Sq, Sk, D, causal, window)
    (2, 9, 3, 256, 256, 64, True, 0),
    (1, 4, 1, 1024, 1024, 64, True, 256),
    (2, 4, 4, 130, 130, 64, True, 0),
    (2, 4, 2, 96, 200, 64, False, 0),
    (1, 8, 8, 77, 77, 128, True, 0),
    (2, 4, 2, 100, 100, 32, True, 16),
    (1, 8, 2, 160, 160, 80, True, 64),   # h2o-danube's head, padded to 128
    (1, 16, 1, 300, 300, 256, True, 128),  # recurrentgemma's heads, a window
    (2, 4, 2, 96, 200, 256, False, 0),
    (1, 4, 4, 77, 77, 200, True, 0),     # D padded to 256
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", BWD_CASES)
def test_bwd_kernel_matches_plain(card, case, dtype):
    b, h, hkv, sq, sk, d, causal, window = case
    q, k, v, w = (torch.from_numpy(a).to(card, dtype) for a in _draw(
        2, b, sq, sk, h, hkv, d))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = flash_attention.backward_launches
    out = flash_attention.flash_attention_bshd(*leaves, causal=causal,
                                               window=window)
    got = torch.autograd.grad(out, leaves, w)
    torch.cuda.synchronize()
    assert flash_attention.backward_launches == before + 1

    def bhsd(t):
        return t.transpose(1, 2).reshape(-1, t.shape[1], d).contiguous()

    args = [bhsd(t) for t in (q, k, v, out.detach(), w)]
    want = ref.flash_attention_bwd(*args, group=h // hkv, causal=causal,
                                   window=window)
    got = [bhsd(g) for g in got]
    if dtype == torch.float32:
        for g, r in zip(got, want):
            lim = 1e-4 * r.abs() + 1e-5 * r.abs().max()
            assert bool(((g - r).abs() <= lim).all())
    else:
        limits = ref.flash_bwd_bf16_limits(*args, want, group=h // hkv,
                                           causal=causal, window=window)
        for g, r, lim in zip(got, want, limits):
            assert bool(((g.float() - r.float()).abs() <= lim).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_lse_and_determinism(card, dtype):
    b, s, h, hkv, d = 2, 300, 6, 2, 64
    q, k, v, w = (torch.from_numpy(a).to(card, dtype) for a in _draw(
        4, b, s, s, h, hkv, d))
    out, lse = flash_attention._forward(q, k, v, "bshd", 3, True, 64,
                                        d ** -0.5, with_lse=True)
    plain = flash_attention._forward(q, k, v, "bshd", 3, True, 64,
                                     d ** -0.5, with_lse=False)[0]
    assert torch.equal(out, plain)   # the LSE moves nothing in o
    qb = q.transpose(1, 2).reshape(b * h, s, d).float()
    kb = torch.repeat_interleave(
        k.transpose(1, 2).reshape(b * hkv, s, d).float(), 3, dim=0)
    logits = qb @ kb.transpose(1, 2) * d ** -0.5
    i = torch.arange(s, device=card)
    vis = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - 64)
    want = torch.logsumexp(logits.masked_fill(~vis, float("-inf")), -1)
    torch.testing.assert_close(lse, want, rtol=1e-5, atol=1e-5)
    grads = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        o = flash_attention.flash_attention_bshd(*leaves, window=64)
        grads.append(torch.autograd.grad(o, leaves, w))
    for a, c in zip(*grads):
        assert torch.equal(a, c)   # no atomics: the same bits


# the bf16 instances (wgmma fed by a ring of stages): every width D pads
# to (16, 80 and 200 pad up to 64, 128 and 256), GQA groups 1 and 4, and a
# causal, a windowed and a non-causal Sq != Sk mask
WGMMA_DIMS = [16, 64, 80, 128, 200, 256]
WGMMA_MASKS = {"causal": (150, 150, True, 0), "window": (200, 200, True, 48),
               "non-causal Sq != Sk": (96, 170, False, 0)}
ROUTES = {2: "wgmma, TMA ring", 1: "wgmma, producer loads",
          0: "float32 mma.sync"}


def _bhsd(t, d):
    return t.transpose(1, 2).reshape(-1, t.shape[1], d).contiguous()


def _route(q, k, v, out, dout, lse, causal, window):
    """The design flash_attention_bwd takes for these (B, S, H, D) views."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    outs = [torch.empty_like(t) for t in (q, k, v)]
    ts = (q, k, v, out, dout, *outs)
    args = flash_attention.pack_bwd_args(
        q, k, v, out, dout, lse, torch.empty_like(lse), *outs,
        [flash_attention.bshd_layout(t) for t in ts], b, h, h // hkv, sq, sk,
        causal, window, d ** -0.5)
    lib = _build.load("flash_attention_bwd").lib
    return ROUTES[lib.flash_attention_bwd_route(args)]


def _card_grads(q, k, v, w, causal, window):
    """The gradient kernel's (dQ, dK, dV) through the autograd function
    twice (the same bits expected), the forward's output and LSE."""
    runs = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = flash_attention.flash_attention_bshd(*leaves, causal=causal,
                                                   window=window)
        runs.append(torch.autograd.grad(out, leaves, w))
    torch.cuda.synchronize()
    for a, c in zip(*runs):
        assert torch.equal(a, c)   # no atomics: the same bits
    group = q.shape[2] // k.shape[2]
    o, lse = flash_attention._forward(q, k, v, "bshd", group, causal, window,
                                      q.shape[-1] ** -0.5, with_lse=True)
    return runs[0], o, lse


def _within_bf16_limits(q, k, v, o, w, got, causal, window):
    d = q.shape[-1]
    group = q.shape[2] // k.shape[2]
    args = [_bhsd(t, d) for t in (q, k, v, o, w)]
    want = ref.flash_attention_bwd(*args, group=group, causal=causal,
                                   window=window)
    limits = ref.flash_bwd_bf16_limits(*args, want, group=group,
                                       causal=causal, window=window)
    return all(bool(((_bhsd(g, d).float() - r.float()).abs() <= lim).all())
               for g, r, lim in zip(got, want, limits))


@pytest.mark.gpu
@pytest.mark.parametrize("mask", sorted(WGMMA_MASKS))
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("d", WGMMA_DIMS)
def test_bwd_wgmma_instances(card, d, group, mask):
    sq, sk, causal, window = WGMMA_MASKS[mask]
    h = 4 if group == 1 else 8
    q, k, v, w = (torch.from_numpy(a).to(card, torch.bfloat16) for a in _draw(
        d + group, 2, sq, sk, h, h // group, d))
    got, o, lse = _card_grads(q, k, v, w, causal, window)
    assert _route(q, k, v, o, w, lse, causal, window) == "wgmma, TMA ring"
    assert _within_bf16_limits(q, k, v, o, w, got, causal, window)


@pytest.mark.gpu
def test_bwd_unaligned_views_take_the_producers_loads(card):
    """Views whose rows start 2 bytes past a 16-byte boundary (no TMA, no
    cp.async piece fits) go through the producer warp's own loads."""
    b, s, h, hkv, d = 2, 140, 8, 2, 64
    q, k, v, w = (torch.from_numpy(a).to(card, torch.bfloat16) for a in _draw(
        21, b, s, s, h, hkv, d + 1))
    q, k, v = (t[..., 1:] for t in (q, k, v))
    w = w[..., 1:].contiguous()
    got, o, lse = _card_grads(q, k, v, w, True, 32)
    assert _route(q, k, v, o, w, lse, True, 32) == "wgmma, producer loads"
    assert _within_bf16_limits(q, k, v, o, w, got, True, 32)


@pytest.mark.gpu
def test_bwd_without_keys_writes_zero_dq(card):
    """Sk = 0: dQ = 0 and no dK / dV pass."""
    b, sq, h, hkv, d = 2, 70, 4, 2, 64
    q, _, _, w = (torch.from_numpy(a).to(card, torch.bfloat16) for a in _draw(
        22, b, sq, 1, h, hkv, d))
    k = v = torch.empty((b, 0, hkv, d), dtype=torch.bfloat16, device=card)
    out = torch.zeros_like(q)
    lse = torch.zeros((b * h, sq), dtype=torch.float32, device=card)
    before = flash_attention.backward_launches
    dq, dk, dv = flash_attention._launch_bwd(
        q, k, v, out, w, lse, lambda t, kv: flash_attention.bshd_layout(t),
        b, h, h // hkv, sq, 0, True, 0, d ** -0.5)
    torch.cuda.synchronize()
    assert flash_attention.backward_launches == before + 1
    assert bool((dq == 0).all()) and dk.shape == dv.shape == k.shape


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 256])
def test_bwd_rows_without_a_visible_key(card, d):
    """Non-causal with a window and more queries than keys: rows past Sk +
    window - 1 see no key and get dQ = 0; the rest within the limits."""
    b, sq, sk, h, hkv, window = 1, 200, 90, 4, 2, 40
    q, k, v, w = (torch.from_numpy(a).to(card, torch.bfloat16) for a in _draw(
        23, b, sq, sk, h, hkv, d))
    seen = torch.from_numpy(_visible_rows(sq, sk, False, window)).to(card)
    assert not bool(seen.all()) and bool(seen.any())
    got, o, lse = _card_grads(q, k, v, w, False, window)
    assert bool((got[0][:, ~seen] == 0).all())
    assert _within_bf16_limits(q, k, v, o, w, got, False, window)
