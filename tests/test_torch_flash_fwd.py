"""The bf16 flash forward's order of operations, and its kernel on the card.

``csrc/flash_attention.cu`` computes bf16 attention with wgmma tiles fed
by a TMA ring (see the source's note). No card is here, so the CPU tests
hold a numpy float32 emulation of that kernel's order for each program
(``emulate``): key tiles of 64 from key 0, only those the block test lets
the CTA's 64 rows see; two key groups (the even and the odd tiles), merged
at the end, where Sk is more than one tile and Sq fits one or D > 128
(``split``); logits in base 2 (scale *
log2 e folded in), masked ones -inf; the running max from -1e30 and its
rescale exp2(m - m_new); P rounded to bf16 (to nearest even) before P.V,
the row sums on the unrounded P; O summed across tiles, rescaled before
each tile's product; the division at the end (one reciprocal a row, then
products); the log-sum-exp ln 2 (m +
log2 l), +inf for a row that sees no key. It is held to the JAX package's
``flash_attention_bhsd`` in interpret mode (as
tests/test_torch_attention.py::test_flash_attention_matches_pallas_interpret
runs it) and to ``ref.flash_attention_bshd`` within
``ref.flash_bf16_limit``, at causal, windowed and non-causal Sq != Sk
masks, GQA groups 1 and 4 and D = 64, 80 and 128; an emulation that drops
the last query block's last key tile must break that limit, so the limit
can refuse such a kernel.

Tests marked ``gpu`` run the kernel and skip without a card: every padded
D with groups 1 and 4 and three masks on the TMA route, unaligned views on
the producer's own loads, rows that see no key, the same bits on a rerun,
a program's rows bit-equal alone and in batches of 3 and 64 at the LLM
predicate's shape, and one launch a call. JAX is imported inside a fixture.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention, ref

torch.set_num_threads(1)

BK = 64        # keys a tile, and query rows a CTA
NEG = np.float32(-1e30)
LOG2E = 1.4426950408889634
LN2 = np.float32(0.6931471805599453)

# (Sq, Sk, causal, window) of the three masks, and a cross-attention's
# single query tile (two key groups); every row sees a key, so the JAX
# kernel (which averages a row that sees none) is comparable everywhere
MASKS = {"causal": (192, 192, True, 0), "window": (192, 192, True, 48),
         "non-causal Sq != Sk": (128, 192, False, 0),
         "one query tile": (64, 192, False, 0)}
DIMS = [64, 80, 128]


def bf16_round(x: np.ndarray) -> np.ndarray:
    """float32 to the nearest bf16 (ties to even), kept in float32."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) >> 16 << 16
    return b.astype(np.uint32).view(np.float32)


def tiles_seen(q0: int, sq: int, sk: int, causal: bool, window: int) -> tuple:
    """(k_begin, n_tiles): the key tiles some row of [q0, q0 + 64) sees."""
    q_last = min(q0 + BK, sq) - 1
    k_end = min(sk, q_last + 1) if causal else sk
    k_begin = max(0, q0 - window + 1) // BK * BK if window > 0 else 0
    n = (k_end - k_begin + BK - 1) // BK if k_end > k_begin else 0
    return k_begin, n


def split(sq: int, sk: int, d: int) -> bool:
    """Whether the kernel splits a CTA's key tiles between two key groups:
    its rows see more than one tile, and the CTAs are few (Sq within one
    tile) or heavy (D > 128)."""
    return sk > BK and (sq <= BK or d > 128)


def emulate(q, k, v, *, group: int, causal: bool, window: int,
            scale: float | None = None, drop_last: bool = False):
    """The bf16 kernel's order for q (BH, Sq, D) and k, v (BH / group, Sk,
    D), float32 arrays of bf16 values: (o rounded to bf16, lse), both
    float32. ``drop_last`` leaves out the last query block's last key tile
    (a broken kernel)."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    c = np.float32((d ** -0.5 if scale is None else scale) * LOG2E)
    groups = 2 if split(sq, sk, d) else 1
    o = np.zeros((bh, sq, d), np.float32)
    lse = np.zeros((bh, sq), np.float32)
    q_tiles = (sq + BK - 1) // BK
    for p in range(bh):
        kp, vp = k[p // group], v[p // group]
        for qt in range(q_tiles):
            q0 = qt * BK
            rows = np.arange(q0, min(q0 + BK, sq))
            k_begin, n_tiles = tiles_seen(q0, sq, sk, causal, window)
            if drop_last and qt == q_tiles - 1 and n_tiles > 1:
                n_tiles -= 1
            parts = []
            for g in range(groups):
                m = np.full(len(rows), NEG, np.float32)
                l = np.zeros(len(rows), np.float32)
                acc = np.zeros((len(rows), d), np.float32)
                for n in range(g, n_tiles, groups):
                    keys = np.arange(k_begin + n * BK,
                                     min(k_begin + (n + 1) * BK, sk))
                    s = q[p, rows] @ kp[keys].T
                    vis = np.ones(s.shape, bool)
                    if causal:
                        vis &= keys[None, :] <= rows[:, None]
                    if window > 0:
                        vis &= keys[None, :] > rows[:, None] - window
                    x = np.where(vis, s * c, np.float32(-np.inf))
                    m_new = np.maximum(m, np.maximum(x.max(1), NEG))
                    corr = np.exp2(m - m_new)
                    pr = np.exp2(x - m_new[:, None]).astype(np.float32)
                    l = l * corr + pr.sum(1, dtype=np.float32)
                    acc = acc * corr[:, None] + bf16_round(pr) @ vp[keys]
                    m = m_new
                parts.append((m, l, acc))
            m, l, acc = parts[0]
            if groups > 1:
                m1, l1, acc1 = parts[1]
                top = np.maximum(m, m1)
                f0, f1 = np.exp2(m - top), np.exp2(m1 - top)
                l = l * f0 + l1 * f1
                acc = acc * f0[:, None] + acc1 * f1[:, None]
                m = top
            inv = np.float32(1) / np.where(l == 0, np.float32(1), l)
            o[p, rows] = bf16_round(acc * inv[:, None])
            with np.errstate(divide="ignore"):
                lse[p, rows] = np.where(l == 0, np.float32(np.inf),
                                        (m + np.log2(l)) * LN2)
    return o, lse


def _draw(seed: int, bh: int, bkv: int, sq: int, sk: int, d: int):
    """bf16 values as float32 (BH, Sq, D) q and (BHkv, Sk, D) k, v."""
    rng = np.random.default_rng(seed)
    return tuple(bf16_round(rng.standard_normal(shape).astype(np.float32))
                 for shape in ((bh, sq, d), (bkv, sk, d), (bkv, sk, d)))


def _bshd(a: np.ndarray, heads: int) -> torch.Tensor:
    """(B * heads, S, D) float32 to a (B, S, heads, D) bf16 tensor."""
    bh, s, d = a.shape
    return torch.from_numpy(a).reshape(bh // heads, heads, s, d).transpose(
        1, 2).to(torch.bfloat16)


def _limit_share(o, q, k, v, causal, window):
    """The largest share of ``ref.flash_bf16_limit`` that ``o`` (BH, Sq,
    D) takes against ``ref.flash_attention_bshd`` on the same inputs, all
    programs the heads of one sequence."""
    heads = q.shape[0]
    qt, kt, vt = _bshd(q, heads), _bshd(k, k.shape[0]), _bshd(v, k.shape[0])
    want = ref.flash_attention_bshd(qt, kt, vt, causal=causal, window=window)
    limit = ref.flash_bf16_limit(qt, kt, vt, want, causal=causal,
                                 window=window)
    diff = (_bshd(o, heads).float() - want.float()).abs()
    return float(torch.where(diff == 0, 0.0, diff / limit).max())


@pytest.fixture(scope="module")
def jax_flash():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.flash_attention import flash_attention_bhsd
    return jnp, flash_attention_bhsd


@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("d", DIMS)
def test_emulation_matches_pallas_interpret(jax_flash, d, group, mask):
    """The emulated kernel order against the JAX package's Pallas kernel
    (interpret mode) on bf16 inputs: within ``ref.flash_bf16_limit`` of
    its output, which rounds o once and keeps P in float32."""
    jnp, flash_bhsd = jax_flash
    sq, sk, causal, window = MASKS[mask]
    q, k, v = _draw(d + group, group, 1, sq, sk, d)
    got, _ = emulate(q, k, v, group=group, causal=causal, window=window)
    want = np.asarray(flash_bhsd(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), group=group,
        causal=causal, window=window, block_q=64, block_k=64),
        np.float32)
    qt, kt, vt = _bshd(q, group), _bshd(k, 1), _bshd(v, 1)
    want_t = _bshd(want, group).float()
    limit = ref.flash_bf16_limit(qt, kt, vt, want_t, causal=causal,
                                 window=window)
    err = (_bshd(got, group).float() - want_t).abs()
    assert bool((err <= limit).all()), float((err / limit).max())


# the limit's own cases: the three masks, a ragged Sq and Sk, and Sk
# within one tile (one key group)
LIMIT_CASES = {**MASKS, "ragged causal": (150, 150, True, 0),
               "ragged non-causal": (70, 130, False, 0),
               "one key tile": (100, 50, False, 0)}


@pytest.mark.parametrize("case", sorted(LIMIT_CASES))
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("d", [*DIMS, 200])
def test_emulation_within_bf16_limit(d, group, case):
    """The emulated order against the plain version within
    ``ref.flash_bf16_limit``, and its LSE against the log-sum-exp of the
    scaled logits in float64."""
    sq, sk, causal, window = LIMIT_CASES[case]
    q, k, v = _draw(3 * d + group, 4 * group, 4, sq, sk, d)
    o, lse = emulate(q, k, v, group=group, causal=causal, window=window)
    assert _limit_share(o, q, k, v, causal, window) <= 1.0
    kx = np.repeat(k, group, 0).astype(np.float64)
    logits = q.astype(np.float64) @ kx.transpose(0, 2, 1) * d ** -0.5
    i, j = np.arange(sq)[:, None], np.arange(sk)[None, :]
    vis = np.ones((sq, sk), bool)
    if causal:
        vis &= j <= i
    if window > 0:
        vis &= j > i - window
    top = np.where(vis, logits, -np.inf).max(-1, keepdims=True)
    want = np.log(np.where(vis, np.exp(logits - top), 0).sum(-1)) + top[..., 0]
    np.testing.assert_allclose(lse, want, rtol=1e-5, atol=1e-5)


def test_rows_that_see_no_key_write_zero_and_an_infinite_lse():
    """Queries past the keys' end under a causal window: o exactly 0, LSE
    +inf, as the plain version's 0."""
    q, k, v = _draw(7, 4, 2, 200, 100, 64)
    o, lse = emulate(q, k, v, group=2, causal=True, window=32)
    hidden = np.arange(200) - 32 >= 99   # no key j with j > i - 32, j < 100
    assert hidden.any() and bool((o[:, hidden] == 0).all())
    assert bool(np.isinf(lse[:, hidden]).all())
    assert np.isfinite(lse[:, ~hidden]).all()
    assert _limit_share(o, q, k, v, True, 32) <= 1.0


@pytest.mark.parametrize("mask", sorted(MASKS))
def test_dropping_the_last_key_tile_breaks_the_limit(mask):
    """The broken kernel that skips the last query block's last key tile
    (chip_smoke.py's first flash mutant) is refused by the limit the
    kernel is held to."""
    sq, sk, causal, window = MASKS[mask]
    q, k, v = _draw(11, 4, 4, sq, sk, 64)
    good, _ = emulate(q, k, v, group=1, causal=causal, window=window)
    bad, _ = emulate(q, k, v, group=1, causal=causal, window=window,
                     drop_last=True)
    assert _limit_share(good, q, k, v, causal, window) <= 1.0
    assert _limit_share(bad, q, k, v, causal, window) > 1.0


# --------------------------------------------------------------------------- #
# the kernel on the card                                                       #
# --------------------------------------------------------------------------- #
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# every width D pads to (16, 80 and 200 pad up to 64, 128 and 256), as the
# gradient's card tests take them (tests/test_torch_flash_grad.py)
WGMMA_DIMS = [16, 64, 80, 128, 200, 256]
CARD_MASKS = {"causal": (150, 150, True, 0), "window": (200, 200, True, 48),
              "non-causal Sq != Sk": (96, 170, False, 0)}


def _card_qkv(seed, b, sq, sk, h, hkv, d, dev):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 .to(dev, torch.bfloat16)
                 for s in ((b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d)))


def _within_limit(q, k, v, got, causal, window) -> bool:
    want = ref.flash_attention_bshd(q, k, v, causal=causal, window=window)
    limit = ref.flash_bf16_limit(q, k, v, want, causal=causal, window=window)
    return bool(((got.float() - want.float()).abs() <= limit).all())


@pytest.mark.gpu
@pytest.mark.parametrize("mask", sorted(CARD_MASKS))
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("d", WGMMA_DIMS)
def test_fwd_wgmma_instances(card, d, group, mask):
    sq, sk, causal, window = CARD_MASKS[mask]
    h = 4 if group == 1 else 8
    q, k, v = _card_qkv(d + group, 2, sq, sk, h, h // group, d, card)
    got = flash_attention.flash_attention_bshd(q, k, v, causal=causal,
                                               window=window)
    assert flash_attention.route(q, k, v, causal=causal, window=window) == \
        "bf16 wgmma, TMA ring"
    assert _within_limit(q, k, v, got, causal, window)


@pytest.mark.gpu
def test_fwd_unaligned_views_take_the_producers_loads(card):
    """Views whose rows start 2 bytes past a 16-byte boundary (no TMA) go
    through the producer warp's own loads, to the same limit."""
    q, k, v = _card_qkv(21, 2, 140, 140, 8, 2, 65, card)
    q, k, v = (t[..., 1:] for t in (q, k, v))
    got = flash_attention.flash_attention_bshd(q, k, v, window=32)
    assert flash_attention.route(q, k, v, window=32) == \
        "bf16 wgmma, producer loads"
    assert _within_limit(q, k, v, got, True, 32)


@pytest.mark.gpu
def test_fwd_rows_that_see_no_key(card):
    """Queries past the keys' end under a causal window write 0 and an LSE
    of +inf; the others a finite LSE, and both LSEs and o the same bits on
    a rerun."""
    q, k, v = _card_qkv(5, 2, 200, 100, 4, 2, 64, card)
    runs = [flash_attention._forward(q, k, v, "bshd", 2, True, 32,
                                     64 ** -0.5, with_lse=True)
            for _ in range(2)]
    (o, lse), (o2, lse2) = runs
    hidden = torch.arange(200, device=card) - 32 >= 99
    assert bool((o[:, hidden] == 0).all())
    lse = lse.reshape(2, 4, 200)
    assert bool(torch.isinf(lse[..., hidden]).all())
    assert bool(torch.isfinite(lse[..., ~hidden]).all())
    assert torch.equal(o, o2) and torch.equal(lse.flatten(), lse2.flatten())
    assert _within_limit(q, k, v, o, True, 32)


@pytest.mark.gpu
def test_fwd_same_bits_on_a_rerun_and_one_launch_a_call(card):
    q, k, v = _card_qkv(9, 2, 512, 512, 48, 8, 128, card)
    before = flash_attention.launches
    outs = [flash_attention.flash_attention_bshd(q, k, v) for _ in range(2)]
    torch.cuda.synchronize()
    assert flash_attention.launches - before == 2
    assert torch.equal(outs[0], outs[1])


@pytest.mark.gpu
def test_fwd_rows_do_not_depend_on_the_batch(card):
    """At the LLM predicate's (512, 9, 3, 64): each sequence's rows are
    the same bits alone and in batches of 3 and 64, as the eddy may batch
    them."""
    q, k, v = _card_qkv(13, 64, 512, 512, 9, 3, 64, card)
    full = flash_attention.flash_attention_bshd(q, k, v)
    three = flash_attention.flash_attention_bshd(q[5:8], k[5:8], v[5:8])
    assert torch.equal(three, full[5:8])
    for i in (0, 6, 63):
        alone = flash_attention.flash_attention_bshd(q[i:i + 1], k[i:i + 1],
                                                     v[i:i + 1])
        assert torch.equal(alone, full[i:i + 1])
