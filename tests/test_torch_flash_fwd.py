"""The bf16 flash forward's order of operations, and its kernel on the card.

``csrc/flash_attention.cu`` computes bf16 attention with wgmma tiles fed
by a TMA ring (see the source's note), in one of two designs. No card is
here, so the CPU tests hold a numpy float32 emulation of the kernel's
order for each program (``emulate``): key tiles of 64 from key 0, only
those the block test lets a warpgroup's 64 rows see; the running max from
-1e30 and its rescale exp2(m - m_new); P rounded to bf16 (to nearest
even) before P.V, the row sums on the unrounded P; O summed across tiles,
rescaled before each tile's product; the division at the end (one
reciprocal a row, then products); the log-sum-exp ln 2 (m + log2 l), +inf
for a row that sees no key. The shared design walks its persistent
schedule (``units``, ``slot``: two or three warpgroups a CTA on
consecutive q heads of a kv head, or at group 1 on consecutive query
tiles of a head, each over the unit's tiles that lie in its band) with the
scale folded into one FFMA an exponential; the design of a CTA a query
tile (``per_tile``: group 1, Sq within one tile) scales the logits first
and splits the key tiles between two key groups (the even and the odd
tiles), merged at the end (``split``). It is held to the JAX package's
``flash_attention_bhsd`` in interpret mode (as
tests/test_torch_attention.py::test_flash_attention_matches_pallas_interpret
runs it) and to ``ref.flash_attention_bshd`` within
``ref.flash_bf16_limit``, at causal, windowed and non-causal Sq != Sk
masks, GQA groups 1 and 4 and D = 64, 80 and 128, and packed at the
models' kv groups 3, 6, 7 and 16 (with two and three warpgroups: the same
bits); the schedule covers each query tile once; an emulation that drops
the last query block's last key tile must break that limit, so the limit
can refuse such a kernel.

Tests marked ``gpu`` run the kernel and skip without a card: every padded
D with groups 1 and 4 and three masks on the TMA route, unaligned views on
the producer's own loads (in both designs; the shared design's at the
LLM's, grok-1's and recurrentgemma's kv groups, bit-equal to its TMA
route, and with o alone unaligned), rows that see no key, the same bits on
a rerun, a program's rows bit-equal alone and in batches of 3 and 64 at
the LLM predicate's shape (and alone and in the batch at grok-1's and
recurrentgemma's under the persistent schedule), the route at each model
shape, both designs within the limit there, and one launch a call. JAX is
imported inside a fixture.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention, ref

torch.set_num_threads(1)

BK = 64        # keys a tile, and query rows a warpgroup
NEG = np.float32(-1e30)
LOG2E = 1.4426950408889634
LN2 = np.float32(0.6931471805599453)

# (Sq, Sk, causal, window) of the three masks, and a cross-attention's
# single query tile (two key groups at group 1); every row sees a key, so
# the JAX kernel (which averages a row that sees none) is comparable
# everywhere
MASKS = {"causal": (192, 192, True, 0), "window": (192, 192, True, 48),
         "non-causal Sq != Sk": (128, 192, False, 0),
         "one query tile": (64, 192, False, 0)}
DIMS = [64, 80, 128]


def bf16_round(x: np.ndarray) -> np.ndarray:
    """float32 to the nearest bf16 (ties to even), kept in float32."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) >> 16 << 16
    return b.astype(np.uint32).view(np.float32)


def tiles_seen(q0: int, sq: int, sk: int, causal: bool, window: int,
               bn: int = BK) -> tuple:
    """(k_begin, n_tiles): the key tiles of bn keys (aligned to bn from key
    0) some row of [q0, q0 + 64) sees."""
    q_last = min(q0 + BK, sq) - 1
    k_end = min(sk, q_last + 1) if causal else sk
    k_begin = max(0, q0 - window + 1) // bn * bn if window > 0 else 0
    n = (k_end - k_begin + bn - 1) // bn if k_end > k_begin else 0
    return k_begin, n


def per_tile(sq: int, group: int, d: int) -> bool:
    """Whether the kernel takes its design of a CTA a query tile (else the
    shared design): where the kv group is 1 and Sq fits one tile, so no two
    warpgroups could share a K/V stage, and at D <= 64 where three
    warpgroups do not divide the kv group."""
    return (group == 1 and sq <= BK) or (d <= 64 and group > 1
                                         and group % 3 != 0)


def key_tile(d: int) -> int:
    """The shared design's keys a tile: 128 at D <= 64, else 64."""
    return 2 * BK if d <= 64 else BK


def split(sq: int, sk: int, d: int, group: int = 1) -> bool:
    """Whether the kernel splits a CTA's key tiles between two key groups:
    in the design of a CTA a query tile, where its rows see more than one
    tile and the CTAs are few (Sq within one tile) or heavy (D > 128)."""
    return per_tile(sq, group, d) and sk > BK and (sq <= BK or d > 128)


def warpgroups(d: int) -> int:
    """The shared design's consumer warpgroups a CTA, as
    ``flash_attention_route`` picks them: three at D <= 128, else two."""
    return 3 if d <= 128 else 2


def slot(u: int, s: int, *, batch: int, heads: int, group: int, sq: int,
         sk: int, causal: bool, window: int, w: int, bn: int = BK) -> dict:
    """Warpgroup s's share of work unit u of the shared design with w
    warpgroups (the kernel's ``slot_of``): sequence b, head h, rows from
    q0, key tiles (kb, nt), and whether it is one (valid). Group 2 and up:
    w consecutive q heads of a kv head at one query tile; group 1: w
    consecutive query tiles of one head; heaviest ranks first."""
    q_tiles = -(-sq // BK)
    hblocks = -(-group // w) if group > 1 else 1
    per_rank = batch * heads // group * hblocks if group > 1 else batch * heads
    rank, r = divmod(u, per_rank)
    if group > 1:
        bk, j = divmod(r, hblocks)
        i = j * w + s
        kv_heads = heads // group
        b = bk // kv_heads
        valid = i < group
        h = (bk - b * kv_heads) * group + min(i, group - 1)
        q0 = (q_tiles - 1 - rank) * BK
    else:
        b, h = divmod(r, heads)
        qt = q_tiles - 1 - (rank * w + s)
        valid = qt >= 0
        q0 = max(qt, 0) * BK
    kb, nt = tiles_seen(q0, sq, sk, causal, window, bn)
    return {"b": b, "h": h, "q0": q0, "valid": valid, "kb": kb,
            "nt": nt if valid else 0}


def units(*, batch: int, heads: int, group: int, sq: int, sk: int,
          causal: bool, window: int, w: int, bn: int = BK) -> list:
    """The shared design's work units in schedule order, each (kb, nt,
    slots): the union of its w slots' key tiles of bn keys, which the
    producer loads once for all of them, and the slots (``slot``)."""
    q_tiles = -(-sq // BK)
    if group > 1:
        n = q_tiles * batch * heads // group * -(-group // w)
    else:
        n = -(-q_tiles // w) * batch * heads
    out = []
    for u in range(n):
        slots = [slot(u, s, batch=batch, heads=heads, group=group, sq=sq,
                      sk=sk, causal=causal, window=window, w=w, bn=bn)
                 for s in range(w)]
        live = [x for x in slots if x["nt"] > 0]
        kb = min((x["kb"] for x in live), default=0)
        end = max((x["kb"] + bn * x["nt"] for x in live), default=0)
        out.append((kb, (end - kb) // bn if live else 0, slots))
    return out


def _rows(qp, kp, vp, rows, keys0, *, sk: int, causal: bool, window: int,
          c, fold: bool, bn: int = BK):
    """(m, l, acc) of query rows ``rows`` over the key tiles of bn keys
    starting at ``keys0``, in order, as a warpgroup sums them: the running
    max from
    -1e30 and its rescale exp2(m - m_new); P rounded to bf16 before P.V,
    the row sums on the unrounded P. ``fold``: the shared design's
    2^(s c - m) in one FFMA (emulated in float64, rounded once), the max
    taken on the raw logits; else the logits scaled first."""
    d = qp.shape[1]
    m = np.full(len(rows), NEG, np.float32)
    l = np.zeros(len(rows), np.float32)
    acc = np.zeros((len(rows), d), np.float32)
    for k0 in keys0:
        keys = np.arange(k0, min(k0 + bn, sk))
        s = qp[rows] @ kp[keys].T
        vis = np.ones(s.shape, bool)
        if causal:
            vis &= keys[None, :] <= rows[:, None]
        if window > 0:
            vis &= keys[None, :] > rows[:, None] - window
        if fold:
            x = np.where(vis, s, np.float32(-np.inf))
            m_new = np.maximum(m, (x.max(1) * c).astype(np.float32))
            arg = (x.astype(np.float64) * np.float64(c)
                   - m_new[:, None]).astype(np.float32)
        else:
            x = np.where(vis, s * c, np.float32(-np.inf))
            m_new = np.maximum(m, np.maximum(x.max(1), NEG))
            arg = x - m_new[:, None]
        corr = np.exp2(m - m_new)
        pr = np.exp2(arg).astype(np.float32)
        l = l * corr + pr.sum(1, dtype=np.float32)
        acc = acc * corr[:, None] + bf16_round(pr) @ vp[keys]
        m = m_new
    return m, l, acc


def _finish(o, lse, p, rows, m, l, acc) -> None:
    """The division at the end (one reciprocal a row, then products) and
    the log-sum-exp ln 2 (m + log2 l), +inf for a row that sees no key."""
    inv = np.float32(1) / np.where(l == 0, np.float32(1), l)
    o[p, rows] = bf16_round(acc * inv[:, None])
    with np.errstate(divide="ignore"):
        lse[p, rows] = np.where(l == 0, np.float32(np.inf),
                                (m + np.log2(l)) * LN2)


def emulate(q, k, v, *, group: int, causal: bool, window: int,
            scale: float | None = None, drop_last: bool = False,
            w: int | None = None):
    """The bf16 kernel's order for q (BH, Sq, D) and k, v (BH / group, Sk,
    D), float32 arrays of bf16 values: (o rounded to bf16, lse), both
    float32. The shared design (``per_tile`` false, or any given w) walks
    its schedule (``units``; w warpgroups, by default ``warpgroups``'
    choice; key tiles of ``key_tile(D)``): each valid slot's rows over the
    unit's tiles that lie in its band; the design of a CTA a query tile
    walks each program's tiles,
    split between two key groups and merged where ``split``.
    ``drop_last`` leaves out the last query block's last key tile (a
    broken kernel)."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    c = np.float32((d ** -0.5 if scale is None else scale) * LOG2E)
    o = np.zeros((bh, sq, d), np.float32)
    lse = np.zeros((bh, sq), np.float32)
    q_tiles = (sq + BK - 1) // BK
    kw = {"sk": sk, "causal": causal, "window": window, "c": c}
    if w is not None or not per_tile(sq, group, d):
        w = warpgroups(d) if w is None else w
        bn = key_tile(d)
        for kb, nt, slots in units(batch=1, heads=bh, group=group, sq=sq,
                                   sk=sk, causal=causal, window=window, w=w,
                                   bn=bn):
            for x in slots:
                if not x["valid"]:
                    continue
                p, rows = x["h"], np.arange(x["q0"], min(x["q0"] + BK, sq))
                n = x["nt"] - (drop_last and x["q0"] == (q_tiles - 1) * BK
                               and x["nt"] > 1)
                keys0 = [k0 for k0 in range(kb, kb + bn * nt, bn)
                         if x["kb"] <= k0 < x["kb"] + bn * n]
                _finish(o, lse, p, rows, *_rows(
                    q[p], k[p // group], v[p // group], rows, keys0,
                    fold=True, bn=bn, **kw))
        return o, lse
    groups = 2 if split(sq, sk, d, group) else 1
    for p in range(bh):
        kp, vp = k[p // group], v[p // group]
        for qt in range(q_tiles):
            q0 = qt * BK
            rows = np.arange(q0, min(q0 + BK, sq))
            k_begin, n_tiles = tiles_seen(q0, sq, sk, causal, window)
            if drop_last and qt == q_tiles - 1 and n_tiles > 1:
                n_tiles -= 1
            parts = [_rows(q[p], kp, vp, rows,
                           [k_begin + n * BK
                            for n in range(g, n_tiles, groups)],
                           fold=False, **kw) for g in range(groups)]
            m, l, acc = parts[0]
            if groups > 1:
                m1, l1, acc1 = parts[1]
                top = np.maximum(m, m1)
                f0, f1 = np.exp2(m - top), np.exp2(m1 - top)
                l = l * f0 + l1 * f1
                acc = acc * f0[:, None] + acc1 * f1[:, None]
                m = top
            _finish(o, lse, p, rows, m, l, acc)
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


# the shared design's packing: (heads, group, Sq, Sk, causal, window, D)
# at the kv groups of the models' attention (3: SmolLM's, 6: grok-1's, 7:
# arctic's, 16: recurrentgemma's local attention, each at a small Sq),
# with Sq not a multiple of 64, and group 1 with query tiles packed under a
# causal mask and a window
PACKED = {"group 3": (9, 3, 150, 150, True, 0, 64),
          "group 6": (12, 6, 130, 130, True, 0, 128),
          "group 7": (7, 7, 100, 100, True, 0, 128),
          "group 16": (16, 16, 70, 70, True, 40, 256),
          "group 1 causal": (2, 1, 192, 192, True, 0, 64),
          "group 1 window": (2, 1, 200, 200, True, 48, 80)}


@pytest.mark.parametrize("w", [2, 3])
@pytest.mark.parametrize("case", sorted(PACKED))
def test_schedule_covers_every_query_tile_once(case, w):
    """Each (sequence, head, query tile) is one valid slot of one unit;
    the slots of a unit read one kv head (one head at group 1), the unit's
    tiles (of ``key_tile(D)`` keys) are the union of theirs, and units run
    heaviest first."""
    heads, group, sq, sk, causal, window, d = PACKED[case]
    batch, bn = 2, key_tile(d)
    seen = []
    last = None
    for kb, nt, slots in units(batch=batch, heads=heads, group=group, sq=sq,
                               sk=sk, causal=causal, window=window, w=w,
                               bn=bn):
        assert len({(x["b"], x["h"] // group) for x in slots}) == 1
        live = [x for x in slots if x["valid"]]
        assert live
        for x in live:
            seen.append((x["b"], x["h"], x["q0"]))
            if x["nt"]:
                assert kb <= x["kb"] and x["kb"] + bn * x["nt"] <= kb + bn * nt
        top = max(x["q0"] for x in live)
        assert last is None or top <= last
        last = top
    want = [(b, h, q0) for b in range(batch) for h in range(heads)
            for q0 in range(0, sq, BK)]
    assert sorted(seen) == sorted(want)
    if group > 1 and group % w:   # the group's last block leaves slots idle
        assert any(not x["valid"] for *_, slots in units(
            batch=batch, heads=heads, group=group, sq=sq, sk=sk,
            causal=causal, window=window, w=w) for x in slots)


@pytest.mark.parametrize("case", sorted(PACKED))
def test_packed_emulation_within_bf16_limit(case):
    """The shared design's order through its schedule within
    ``ref.flash_bf16_limit`` of the plain version, and a row's bits the
    same with two and three warpgroups a CTA (its sums do not depend on
    which slot took it)."""
    heads, group, sq, sk, causal, window, d = PACKED[case]
    q, k, v = _draw(5 * group + d, heads, heads // group, sq, sk, d)
    two, lse2 = emulate(q, k, v, group=group, causal=causal, window=window,
                        w=2)
    three, lse3 = emulate(q, k, v, group=group, causal=causal,
                          window=window, w=3)
    assert np.array_equal(two, three) and np.array_equal(lse2, lse3)
    assert _limit_share(two, q, k, v, causal, window) <= 1.0


def test_group_one_tiles_of_a_unit_see_different_bands():
    """Group 1, causal: the two query tiles of a unit see different key
    tiles, so the lower one skips the last of the unit's, which the
    producer still loads for the upper one."""
    (kb, nt, (hi, lo)), *_ = units(batch=1, heads=1, group=1, sq=192,
                                   sk=192, causal=True, window=0, w=2)
    assert (hi["q0"], lo["q0"]) == (128, 64)
    assert (kb, nt) == (0, 3) and (lo["kb"], lo["nt"]) == (0, 2)


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
    assert flash_attention.route(q, k, v, causal=causal, window=window) == (
        "bf16 wgmma, TMA ring" if per_tile(sq, group, d)
        else "bf16 wgmma shared stages, TMA ring")
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


# (B, Sq, Sk, H, Hkv, D, causal, window) of the models' bf16 attention: the
# LLM predicate's at 10 rows, whisper-small's encoder and cross-attention,
# grok-1's, arctic's, recurrentgemma-9b's local attention
MODEL_SHAPES = {"llm": (10, 512, 512, 9, 3, 64, True, 0),
                "whisper encoder": (4, 1500, 1500, 12, 12, 64, False, 0),
                "whisper cross": (4, 64, 1500, 12, 12, 64, False, 0),
                "grok-1": (2, 512, 512, 48, 8, 128, True, 0),
                "arctic": (2, 512, 512, 56, 8, 128, True, 0),
                "recurrentgemma": (1, 2560, 2560, 16, 1, 256, True, 2048)}


def _variant(q, k, v, variant, causal, window, out=None):
    """flash_attention_variant's output (design ``variant``: 1 a CTA a
    query tile, 2 the shared design, 0 the one the call's route takes) and
    LSE, into ``out`` where given."""
    from repro_torch.kernels import _build
    b, sq, h, d = q.shape
    out = torch.empty_like(q) if out is None else out
    lse = torch.empty((b * h, sq), device=q.device)
    args = flash_attention.pack_args(
        q, k, v, out, tuple(map(flash_attention.bshd_layout, (q, k, v, out))),
        b, h, h // k.shape[2], sq, k.shape[1], causal, window, d ** -0.5, lse)
    lib = _build.load("flash_attention").lib
    assert lib.flash_attention_variant(
        args, variant, torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    return out, lse


def _shifted(t):
    """A view of t's values whose rows start 2 bytes past a 16-byte
    boundary (no TMA map, no 16-byte access)."""
    wide = torch.empty((*t.shape[:-1], t.shape[-1] + 1), dtype=t.dtype,
                       device=t.device)
    wide[..., 1:] = t
    return wide[..., 1:]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(MODEL_SHAPES))
def test_fwd_route_at_the_model_shapes(card, shape):
    """Each model shape takes its design by TMA (the shared design; at
    whisper's cross-attention, one query tile at group 1, a CTA a query
    tile), within the limit, with the same bits on a rerun."""
    b, sq, sk, h, hkv, d, causal, window = MODEL_SHAPES[shape]
    q, k, v = _card_qkv(31, b, sq, sk, h, hkv, d, card)
    want = ("bf16 wgmma, TMA ring" if shape == "whisper cross"
            else "bf16 wgmma shared stages, TMA ring")
    assert flash_attention.route(q, k, v, causal=causal,
                                 window=window) == want
    runs = [flash_attention.flash_attention_bshd(q, k, v, causal=causal,
                                                 window=window)
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    assert _within_limit(q, k, v, runs[0], causal, window)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(MODEL_SHAPES))
def test_fwd_both_designs_within_the_limit(card, shape):
    """At each model shape both bf16 designs (a CTA a query tile, and the
    shared design, whichever the route takes) stay within the limit, and
    the routed call gives the bits of the design its route names."""
    b, sq, sk, h, hkv, d, causal, window = MODEL_SHAPES[shape]
    q, k, v = _card_qkv(33, b, sq, sk, h, hkv, d, card)
    routed, routed_lse = _variant(q, k, v, 0, causal, window)
    shared = "shared" in flash_attention.route(q, k, v, causal=causal,
                                               window=window)
    for design in (1, 2):
        o, lse = _variant(q, k, v, design, causal, window)
        assert _within_limit(q, k, v, o, causal, window)
        if design == (2 if shared else 1):
            assert torch.equal(o, routed) and torch.equal(lse, routed_lse)


# (B, Sq, Sk, H, Hkv, D, causal, window) at the kv groups and widths of the
# shared design's three instances, cut in length: the LLM predicate's
# group 3 at D = 64, grok-1's 6 at D = 128, recurrentgemma's 16 at D = 256
UNALIGNED_SHAPES = {"llm": (2, 200, 200, 9, 3, 64, True, 0),
                    "grok-1": (2, 200, 200, 12, 6, 128, True, 0),
                    "recurrentgemma": (1, 300, 300, 16, 1, 256, True, 128)}


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(UNALIGNED_SHAPES))
def test_fwd_unaligned_views_on_the_shared_design(card, shape):
    """q, k and v 2 bytes past a 16-byte boundary take the shared design's
    own loads: the bits of its TMA route on the same values, o and LSE, the
    same on a rerun, within the limit; through the wrapper (o aligned: its
    16-byte stores) and with o unaligned too (pair and single stores)."""
    b, sq, sk, h, hkv, d, causal, window = UNALIGNED_SHAPES[shape]
    q, k, v = _card_qkv(37, b, sq, sk, h, hkv, d, card)
    qs, ks, vs = map(_shifted, (q, k, v))
    assert flash_attention.route(q, k, v, causal=causal, window=window) == \
        "bf16 wgmma shared stages, TMA ring"
    assert flash_attention.route(qs, ks, vs, causal=causal,
                                 window=window) == \
        "bf16 wgmma shared stages, producer loads"
    want, want_lse = _variant(q, k, v, 0, causal, window)
    assert _within_limit(q, k, v, want, causal, window)
    got = flash_attention.flash_attention_bshd(qs, ks, vs, causal=causal,
                                               window=window)
    assert torch.equal(got, want)
    for _ in range(2):
        o, lse = _variant(qs, ks, vs, 0, causal, window,
                          out=_shifted(torch.empty_like(q)))
        assert torch.equal(o, want) and torch.equal(lse, want_lse)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(UNALIGNED_SHAPES))
def test_fwd_unaligned_o_alone(card, shape):
    """o 2 bytes past a 16-byte boundary, q, k and v aligned: TMA loads,
    then the shared design's pair and single stores instead of its TMA
    store, to the same bits as an aligned o, on a rerun too."""
    b, sq, sk, h, hkv, d, causal, window = UNALIGNED_SHAPES[shape]
    q, k, v = _card_qkv(39, b, sq, sk, h, hkv, d, card)
    want, want_lse = _variant(q, k, v, 0, causal, window)
    for _ in range(2):
        o, lse = _variant(q, k, v, 0, causal, window,
                          out=_shifted(torch.empty_like(q)))
        assert torch.equal(o, want) and torch.equal(lse, want_lse)
    assert _within_limit(q, k, v, want, causal, window)


@pytest.mark.gpu
def test_fwd_rows_do_not_depend_on_the_batch_under_the_schedule(card):
    """At grok-1's attention (heads packed three a CTA, as many CTAs as
    SMs) and recurrentgemma's (two heads a CTA, at B = 1 and as the second
    of a batch of two): a sequence's rows are the same bits alone and in
    the batch."""
    for shape in ("grok-1", "recurrentgemma"):
        b, sq, sk, h, hkv, d, causal, window = MODEL_SHAPES[shape]
        b = max(b, 2)
        q, k, v = _card_qkv(35, b, sq, sk, h, hkv, d, card)
        full = flash_attention.flash_attention_bshd(q, k, v, causal=causal,
                                                    window=window)
        for i in (0, b - 1):
            alone = flash_attention.flash_attention_bshd(
                q[i:i + 1], k[i:i + 1], v[i:i + 1], causal=causal,
                window=window)
            assert torch.equal(alone, full[i:i + 1])
