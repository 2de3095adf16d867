"""The attention kernels' operand layouts, the split-cache decode's merge
and the 3xTF32 products, as plain PyTorch on the CPU; and the rebuilt
kernels against their plain versions on the card.

On the CPU: the stride helpers address exactly the rows the transposed
copies used to hold; ``ref.decode_attention_split`` (the split kernel's
arithmetic) equals ``ref.decode_attention_bkgd`` within ``TOL_TIGHT`` on
every split edge; and, on the predicates' own tables and rows, scores
from 3xTF32 products stay within ``SCORE_ATOL`` of float32 and keep every
decision, while one TF32 product a multiply-add moves them past the
smallest decision margin. Tests marked ``gpu`` run the CUDA kernels
against their plain versions and skip without a card.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.data import text as port_text
from repro_torch.kernels import decode_attention, flash_attention, ops, ref
from repro_torch.udfs import library as lib

torch.set_num_threads(1)

TOL_TIGHT = dict(rtol=1e-4, atol=1e-5)
TOL_BF16 = dict(rtol=8e-2, atol=8e-2)   # tests/test_kernels.py, bfloat16
SCORE_ATOL = 1e-7   # attention scores: kernel against plain version


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _gather(t: torch.Tensor, offset: int, rows: int, row_stride: int):
    """(rows, D) read from t's storage at ``offset`` as the kernel reads it."""
    return torch.as_strided(t, (rows, t.shape[-1]), (row_stride, 1),
                            t.storage_offset() + offset)


# --------------------------------------------------------------------------- #
# layouts                                                                     #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("s", [32, 40])   # 40: the causal S ops used to pad
def test_flash_layouts_address_the_rows_of_the_old_copies(rng, group, s):
    b, h, d = 3, 4, 8
    hkv = h // group
    q, k, v = (_t(rng.standard_normal((b, s, n, d))) for n in (h, hkv, hkv))
    pad = (-s) % 32   # the old path padded S to the block, then copied
    old = [F.pad(t, (0, 0, 0, 0, 0, pad)).transpose(1, 2).reshape(
        b * t.shape[2], s + pad, d) for t in (q, k, v)]
    for t, copy, grp in ((q, old[0], 1), (k, old[1], group),
                         (v, old[2], group)):
        lay = flash_attention.bshd_layout(t)
        offsets = flash_attention.program_offsets(lay, b * h, h, grp)
        for p, off in enumerate(offsets):
            assert torch.equal(_gather(t, off, s, lay[2]), copy[p // grp, :s])
    # the 3-d entry point's view of the old copies: BH / group sequences of
    # `group` query heads and one kv head
    lay_q = flash_attention.bhsd_layout(old[0], group)
    lay_k = flash_attention.bhsd_layout(old[1], 1)
    for p, (oq, ok) in enumerate(zip(
            flash_attention.program_offsets(lay_q, b * h, group),
            flash_attention.program_offsets(lay_k, b * h, group, group))):
        assert torch.equal(_gather(old[0], oq, s + pad, lay_q[2]), old[0][p])
        assert torch.equal(_gather(old[1], ok, s + pad, lay_k[2]),
                           old[1][p // group])


@pytest.mark.parametrize("hkv,g", [(1, 2), (2, 2), (2, 4), (4, 1)])
def test_decode_layouts_address_the_rows_of_the_old_copies(rng, hkv, g):
    b, s, d = 3, 24, 8
    h = hkv * g
    q = _t(rng.standard_normal((b, h, d)))
    kc = _t(rng.standard_normal((b, s, hkv, d)))
    old_q = q.reshape(b * hkv, g, d)
    old_k = kc.transpose(1, 2).reshape(b * hkv, s, d)
    lay_q = decode_attention.query_layout(q, g)
    lay_k = decode_attention.cache_layout(kc)
    for p, (oq, ok) in enumerate(zip(
            flash_attention.program_offsets(lay_q, b * hkv, hkv),
            flash_attention.program_offsets(lay_k, b * hkv, hkv))):
        assert torch.equal(_gather(q, oq, g, lay_q[2]), old_q[p])
        assert torch.equal(_gather(kc, ok, s, lay_k[2]), old_k[p])
    # a query broadcast over the batch (stride 0), as the predicate makes it
    fixed = _t(rng.standard_normal((h, d))).expand(b, h, d)
    lay = decode_attention.query_layout(fixed, g)
    for p, off in enumerate(flash_attention.program_offsets(lay, b * hkv,
                                                            hkv)):
        assert torch.equal(_gather(fixed, off, g, lay[2]),
                           fixed.reshape(b * hkv, g, d)[p])


def test_model_layout_entry_points_match_the_3d_ones_on_cpu(rng):
    q, k, v = (_t(rng.standard_normal((2, 48, n, 16))) for n in (4, 2, 2))
    got = flash_attention.flash_attention_bshd(q, k, v, window=20)
    want = flash_attention.flash_attention_bhsd(
        *(t.transpose(1, 2).reshape(-1, 48, 16) for t in (q, k, v)), group=2,
        window=20).reshape(2, 4, 48, 16).transpose(1, 2)
    assert torch.equal(got, want)
    lens = torch.tensor([0, 30])
    dec = decode_attention.decode_attention_bshd(q[:, 5], k, v, lens)
    want = decode_attention.decode_attention_bkgd(
        q[:, 5].reshape(4, 2, 16), k.transpose(1, 2).reshape(4, 48, 16),
        v.transpose(1, 2).reshape(4, 48, 16), lens, num_kv_heads=2)
    assert torch.equal(dec, want.reshape(2, 4, 16))
    assert torch.equal(dec[0], torch.zeros(4, 16))
    with pytest.raises(ValueError, match="4-d"):
        flash_attention.flash_attention_bshd(q[0], k[0], v[0])
    with pytest.raises(ValueError, match="lengths"):
        decode_attention.decode_attention_bshd(q[:, 0], k, v, lens[:1])


# --------------------------------------------------------------------------- #
# the split-cache merge                                                       #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("s", [32, 96, 512, 4096])
@pytest.mark.parametrize("split", [32, 256])
def test_split_decode_equals_the_plain_decode(rng, s, split):
    lens = [0, 1, split - 1, split, split + 1, s + 9]
    hkv, g, d = 2, 4, 16
    bkv = len(lens) * hkv
    q = _t(rng.standard_normal((bkv, g, d)))
    kc, vc = (_t(rng.standard_normal((bkv, s, d))) for _ in range(2))
    lengths = torch.tensor(lens, dtype=torch.int32)
    got = ref.decode_attention_split(q, kc, vc, lengths, num_kv_heads=hkv,
                                     split=split)
    want = ref.decode_attention_bkgd(q, kc, vc, lengths, num_kv_heads=hkv)
    torch.testing.assert_close(got, want, **TOL_TIGHT)
    assert torch.equal(got[:hkv], torch.zeros_like(got[:hkv]))  # length 0


def test_split_count_depends_on_s_alone():
    assert [decode_attention.splits(s) for s in (1, 32, 256, 257, 4096)] == [
        1, 1, 1, 2, 16]
    assert decode_attention.SPLIT == 256


# --------------------------------------------------------------------------- #
# the precision argument: 3xTF32, never one TF32 product                      #
# --------------------------------------------------------------------------- #
def _tf32_1x(a, b):
    return ref.tf32_round(a) @ ref.tf32_round(b)


def _attend_with(mm, q, k, v, mask):
    """softmax(mm(q, k^T) * scale) . v by ``mm``, with the plain versions'
    masking (a row with no visible key is 0)."""
    logits = mm(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    probs = ref.softmax(logits.masked_fill(~mask, ref.MASKED))
    probs = probs.masked_fill(~mask.any(-1, keepdim=True), 0.0)
    return mm(probs, v)


def _predicate_scores(kernel: str, mm) -> np.ndarray:
    """The predicate's scores over 2,000 reviews at seq 32, every product
    formed by ``mm``."""
    reviews = port_text.make_reviews(2000, seed=0)
    toks = np.zeros((2000, 32), np.int32)
    for j, r in enumerate(reviews):
        toks[j, :min(len(r.tokens), 32)] = r.tokens[:32]
    toks = lib.token_ids(toks, 32, 256, torch.device("cpu"))
    if kernel == "flash_attention":
        q, k, v = (t.transpose(1, 2) for t in lib.attention_inputs(
            lib.attention_tables(), toks))          # (B, H, S, D)
        mask = torch.ones(32, 32, dtype=torch.bool).tril()
        out = _attend_with(mm, q, k, v, mask).transpose(1, 2)
    else:
        q, kc, vc, lens = lib.decode_inputs(lib.decode_tables(), toks)
        mask = (torch.arange(32)[None, :] < lens[:, None])[:, None, :]
        out = _attend_with(mm, q, kc[:, :, 0], vc[:, :, 0], mask)
    return lib.row_mean(out).numpy()


@pytest.mark.parametrize("kernel", ["flash_attention", "decode_attention"])
def test_3xtf32_scores_keep_every_decision_and_1xtf32_do_not(kernel):
    exact = _predicate_scores(kernel, torch.matmul)
    margin = np.abs(exact).min()
    three = _predicate_scores(kernel, ref.mm_3xtf32)
    one = _predicate_scores(kernel, _tf32_1x)
    err3, err1 = np.abs(three - exact).max(), np.abs(one - exact).max()
    assert margin > SCORE_ATOL          # no decision within the tolerance
    assert err3 <= SCORE_ATOL
    np.testing.assert_array_equal(three > 0, exact > 0)
    assert err1 > margin                # plain TF32 could flip a decision
    assert err1 > 50 * err3


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1 + 2 ** -10, 1 + 2 ** -11, 1 + 3 * 2 ** -11,
                      -(1 + 2 ** -11), 3.0e-39])
    got = ref.tf32_round(x)
    # ties round away from zero (cvt.rna)
    assert got.tolist()[:5] == [1.0, 1 + 2 ** -10, 1 + 2 ** -10,
                                1 + 2 * 2 ** -10, -(1 + 2 ** -10)]
    bits = got.view(torch.int32)
    assert bool(((bits & 0x1FFF) == 0).all())
    a, b = _t(np.random.default_rng(1).standard_normal((64, 64))), \
        _t(np.random.default_rng(2).standard_normal((64, 64)))
    exact = (a.double() @ b.double())
    assert (ref.mm_3xtf32(a, b).double() - exact).abs().max() < 1e-5
    assert (_tf32_1x(a, b).double() - exact).abs().max() > 1e-3


# --------------------------------------------------------------------------- #
# on the card                                                                 #
# --------------------------------------------------------------------------- #
def _allocations(dev) -> int:
    return torch.cuda.memory_stats(dev)["allocation.all.allocated"]


@pytest.mark.gpu
@pytest.mark.parametrize("window", [0, 32, 512])
@pytest.mark.parametrize("s", [200, 1000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 16, 64, 128, 256])
def test_flash_kernel_matches_plain_version_across_tiles(card, rng, d, dtype,
                                                         s, window):
    q, k, v = (_t(rng.standard_normal((1, s, n, d))).to(card, dtype)
               for n in (4, 2, 2))
    got = flash_attention.flash_attention_bshd(q, k, v, window=window)
    want = ref.flash_attention_bhsd(
        *(t.transpose(1, 2).reshape(-1, s, d) for t in (q, k, v)), group=2,
        window=window).reshape(1, 4, s, d).transpose(1, 2)
    torch.testing.assert_close(got.float(), want.float(),
                               **(TOL_TIGHT if dtype == torch.float32
                                  else TOL_BF16))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_non_causal_and_rows_past_the_keys(card, rng, dtype):
    q = _t(rng.standard_normal((4, 300, 64))).to(card, dtype)
    k, v = (_t(rng.standard_normal((2, 130, 64))).to(card, dtype)
            for _ in range(2))
    tol = TOL_TIGHT if dtype == torch.float32 else TOL_BF16
    got = flash_attention.flash_attention_bhsd(q, k, v, group=2, causal=False)
    want = ref.flash_attention_bhsd(q, k, v, group=2, causal=False)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    got = flash_attention.flash_attention_bhsd(q, k, v, group=2, window=8)
    want = ref.flash_attention_bhsd(q, k, v, group=2, window=8)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    assert bool((got[:, 137:] == 0).all())   # no key j > i - 8 with j < 130


@pytest.mark.gpu
@pytest.mark.parametrize("s", [300, 4096])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 64, 256])
def test_decode_kernel_matches_plain_version_on_every_split_edge(
        card, rng, d, dtype, s):
    lens = [0, 1, 255, 256, 257, s - 1, s, s + 100]
    b, hkv, g = len(lens), 2, 4
    q = _t(rng.standard_normal((b, hkv * g, d))).to(card, dtype)
    kc, vc = (_t(rng.standard_normal((b, s, hkv, d))).to(card, dtype)
              for _ in range(2))
    lengths = torch.tensor(lens, dtype=torch.int32, device=card)
    got = decode_attention.decode_attention_bshd(q, kc, vc, lengths)
    want = ref.decode_attention_bkgd(
        q.reshape(b * hkv, g, d), kc.transpose(1, 2).reshape(b * hkv, s, d),
        vc.transpose(1, 2).reshape(b * hkv, s, d), lengths,
        num_kv_heads=hkv).reshape(b, hkv * g, d)
    torch.testing.assert_close(got.float(), want.float(),
                               **(TOL_TIGHT if dtype == torch.float32
                                  else TOL_BF16))
    assert bool((got[0] == 0).all())   # length 0


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 6])   # 6: rows not 16-byte aligned
def test_kernels_read_strided_views_without_copies(card, rng, d):
    b, s, h, hkv = 2, 200, 4, 2
    # q: heads 1..4 of 6; k and v interleaved in one (B, S, 2, Hkv, D) buffer
    qbase = _t(rng.standard_normal((b, s, h + 2, d))).to(card)
    kv = _t(rng.standard_normal((b, s, 2, hkv, d))).to(card)
    q, k, v = qbase[:, :, 1:h + 1], kv[:, :, 0], kv[:, :, 1]
    assert not (q.is_contiguous() or k.is_contiguous())
    before = _allocations(card)
    got = ops.flash_attention(q, k, v)
    assert _allocations(card) - before == 1     # the output, nothing else
    assert got.is_contiguous() and tuple(got.shape) == (b, s, h, d)
    want = ref.mha_attention(q.contiguous(), k.contiguous(), v.contiguous())
    torch.testing.assert_close(got, want, **TOL_TIGHT)

    dq = qbase[:, 7, 1:h + 1]                   # (B, H, D) view
    lens = torch.tensor([150, 3], dtype=torch.int32, device=card)
    before = _allocations(card)
    dec = ops.decode_attention(dq, k, v, lens, block_k=s)
    assert _allocations(card) - before == 1
    want = ref.decode_attention_bkgd(
        dq.reshape(b * hkv, h // hkv, d),
        k.transpose(1, 2).reshape(b * hkv, s, d),
        v.transpose(1, 2).reshape(b * hkv, s, d), lens, num_kv_heads=hkv)
    torch.testing.assert_close(dec, want.reshape(b, h, d), **TOL_TIGHT)
    # a query broadcast over the batch, as the decode predicate makes it
    fixed = dq[0].expand(b, h, d)
    torch.testing.assert_close(
        ops.decode_attention(fixed, k, v, lens, block_k=s),
        ops.decode_attention(fixed.contiguous(), k.contiguous(),
                             v.contiguous(), lens, block_k=s),
        rtol=0, atol=0)


@pytest.mark.gpu
def test_split_decode_plain_version_matches_the_kernel(card, rng):
    b, s, hkv, g, d = 4, 1000, 2, 4, 64
    q = _t(rng.standard_normal((b * hkv, g, d))).to(card)
    kc, vc = (_t(rng.standard_normal((b * hkv, s, d))).to(card)
              for _ in range(2))
    lens = torch.tensor([0, 256, 700, 1000], dtype=torch.int32, device=card)
    got = decode_attention.decode_attention_bkgd(q, kc, vc, lens,
                                                 num_kv_heads=hkv)
    want = ref.decode_attention_split(q, kc, vc, lens, num_kv_heads=hkv,
                                      split=decode_attention.SPLIT)
    torch.testing.assert_close(got, want, **TOL_TIGHT)
