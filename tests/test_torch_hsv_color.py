"""The port's HSV color kernel and its plain version against the JAX package.

The same numpy inputs go through ``repro`` (the reference) and
``repro_torch``. The port's plain version must give the reference's
histogram bit for bit: both count pixels exactly and scale the count once
by the float32 reciprocal of H*W. The Pallas kernel in interpret mode adds
one partial fraction per row block, so against it the tolerance is 1e-6
(a few float32 ulps of a fraction below 1). Tests marked ``gpu`` run the
CUDA kernel and skip without a card. JAX is imported inside a fixture, so
that the ``gpu`` tests also run on a card host that has no JAX.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch import convert, udfs
from repro_torch.kernels import hsv_color, launch, ops, ref

# small tensors: one intra-op thread, so these tests do not crowd the
# timing-sensitive executor tests running beside them
torch.set_num_threads(1)

INTERPRET_ATOL = 1e-6


@pytest.fixture(scope="module")
def jx():
    """The JAX package's HSV modules (jnp, ref, hsv_color)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import hsv_color as jax_hsv
    from repro.kernels import ref as jax_ref

    return types.SimpleNamespace(jnp=jnp, ref=jax_ref, hsv=jax_hsv)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without a CUDA card")


def _crops(kind: str, b: int, size: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "int":
        return rng.integers(0, 256, (b, size, size, 3)).astype(np.float32)
    return rng.uniform(0, 255, (b, size, size, 3)).astype(np.float32)


def edge_pixels() -> np.ndarray:
    """Pixels where one ulp moves a bucket: red-max with b > g (negative
    hue before the floor-mod), greys (s = 0), and H/S/V on range bounds."""
    hand = [
        (255, 0, 10), (200, 50, 120), (100, 0, 99), (255, 0, 255),
        (0, 0, 0), (45, 45, 45), (46, 46, 46), (200, 200, 200),
        (201, 201, 201), (255, 255, 255), (45, 20, 20), (46, 20, 20),
    ]
    cand = np.random.default_rng(11).integers(0, 256, (1 << 16, 3))
    cand = cand.astype(np.float32)
    hsv = ref.rgb_to_hsv(torch.from_numpy(cand)).numpy()
    on_bound = (np.isin(hsv[:, 0], [9, 10, 33, 34])
                | np.isin(hsv[:, 1], [49, 50, 201])
                | np.isin(hsv[:, 2], [45, 46]))
    return np.concatenate([np.asarray(hand, np.float32), cand[on_bound]])


# --------------------------------------------------------------------------- #
# plain version against the JAX reference: exact                             #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("kind", ["int", "float"])
@pytest.mark.parametrize("size", [8, 64, 96])
def test_plain_version_equals_reference(jx, kind, size):
    x = _crops(kind, 4, size, seed=size)
    jh, jl = jx.ref.hsv_color_classify(jx.jnp.asarray(x))
    th, tl = ref.hsv_color_classify(torch.from_numpy(x))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


def test_plain_version_equals_reference_on_edge_pixels(jx):
    px = edge_pixels()
    assert len(px) > 100
    # one pixel per 1x1 crop: the histogram IS the pixel's bucket
    x = px.reshape(-1, 1, 1, 3)
    jh, jl = jx.ref.hsv_color_classify(jx.jnp.asarray(x))
    th, tl = ref.hsv_color_classify(torch.from_numpy(x))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(
        ref.rgb_to_hsv(torch.from_numpy(px)).numpy(),
        np.asarray(jx.ref.rgb_to_hsv(jx.jnp.asarray(px))))


def test_hue_floor_mod_follows_jax_remainder(jx):
    """Red-max pixels with b > g have (g-b)/diff < 0: JAX's float ``%``
    brings them into [0, 6), C's fmod alone would keep them negative."""
    x = torch.tensor([-5.5, -3.0, -1e-7, 0.0, 2.5, 6.0, 7.25], dtype=torch.float32)
    want = np.asarray(jx.jnp.asarray(x.numpy()) % 6.0)
    np.testing.assert_array_equal(ref._remainder(x, 6.0).numpy(), want)
    hsv = ref.rgb_to_hsv(torch.tensor([[255.0, 0.0, 10.0]]))
    assert 170 < float(hsv[0, 0]) < 180


def test_hue_needs_no_fmod_for_any_integer_red_max_pixel():
    """Over every integer (r, g, b) whose maximum is r, the hue's quotient
    x = (g - b) / diff lies in [-1, 1], so fmod(x, 6) == x bit for bit and
    the kernel's x < 0 ? x + 6 : x equals ``ref._remainder`` (the JAX
    package's float %), -0.0 included."""
    r = torch.arange(256, dtype=torch.float32)
    r, g, b = torch.meshgrid(r, r, r, indexing="ij")
    red = (r >= g) & (r >= b)
    r, g, b = r[red], g[red], b[red]
    assert r.numel() == sum((v + 1) ** 2 for v in range(256))
    diff = r - torch.minimum(g, b)
    x = (g - b) / torch.where(diff == 0, torch.ones_like(diff), diff)
    assert float(x.abs().max()) <= 1.0
    bits = lambda t: t.view(torch.int32)  # noqa: E731
    assert torch.equal(bits(torch.fmod(x, 6.0)), bits(x))
    kernel = torch.where(x < 0, x + 6.0, x)
    assert torch.equal(bits(kernel), bits(ref._remainder(x, 6.0)))


def emulate_cluster_counts(buckets: np.ndarray, k: int, nb: int) -> np.ndarray:
    """(hw,) buckets of one crop -> (nb,) counts as the kernel forms them
    over k CTAs: CTA r takes [r * stretch, (r + 1) * stretch), stretch a
    multiple of 4; each thread takes groups of 4 pixels strided by the
    CTA's threads, adds one to a 4-bit field per pixel and moves the fields
    into integer counters every 3 groups; the counters are summed over the
    threads and the CTAs in any order."""
    hw = len(buckets)
    stretch = (-(-hw // k) + 3) // 4 * 4
    threads = min(hsv_color.MAX_THREADS, (stretch // 4 + 31) // 32 * 32)
    total = np.zeros(nb, np.int64)
    for rank in range(k):
        begin, end = rank * stretch, min(hw, (rank + 1) * stretch)
        for t in range(threads):
            fields, pending = 0, []
            groups = range(begin + 4 * t, end, 4 * threads)
            for i, g in enumerate(groups):
                for bucket in buckets[g:min(g + 4, end)]:
                    fields += 1 << (4 * int(bucket))
                    pending.append(int(bucket))
                if i % 3 == 2 or i == len(groups) - 1:   # the flush
                    got = [(fields >> (4 * j)) & 15 for j in range(nb)]
                    # no field overflowed into its neighbour
                    assert got == np.bincount(pending, minlength=nb).tolist()
                    total += got
                    fields, pending = 0, []
    return total


@pytest.mark.parametrize("hw", [1, 49, 4096, 9216])
def test_split_over_a_cluster_sums_to_the_plain_histogram(hw):
    side = {1: (1, 1), 49: (7, 7), 4096: (64, 64), 9216: (96, 96)}[hw]
    x = torch.from_numpy(np.random.default_rng(hw).integers(
        0, 256, (1, *side, 3)).astype(np.float32))
    ranges = torch.as_tensor(ref.COLOR_RANGES)
    buckets = ref.hsv_color_buckets(x, ranges).reshape(-1).numpy()
    want = ref.hsv_color_classify(x, ranges)[0][0]
    nb = len(ref.COLOR_RANGES) + 1
    for k in range(1, 17):
        counts = emulate_cluster_counts(buckets, k, nb)
        assert counts.sum() == hw
        hist = torch.from_numpy(counts).to(torch.float32) * ref.inv_pixels(hw)
        assert torch.equal(hist, want), k


@pytest.mark.parametrize("batch", [1, 4, 16, 32, 264, 4096, 1 << 24])
@pytest.mark.parametrize("hw", [1, 49, 960, 4096, 9216])
def test_plan_covers_each_crop_once(batch, hw):
    p = hsv_color.plan(batch, hw)
    assert p.cluster in (1, 2, 4, 8) and p.stretch % 4 == 0
    assert p.cluster * p.stretch >= hw > (p.cluster - 1) * p.stretch
    assert p.threads % 32 == 0 and 32 <= p.threads <= hsv_color.MAX_THREADS
    assert 4 * p.threads >= min(p.stretch, 4 * hsv_color.MAX_THREADS)
    if p.cluster > 1:   # split only to fill the card, never below 512 px
        assert batch * p.cluster // 2 < hsv_color.FILL_CTAS
        assert p.stretch >= hsv_color.MIN_STRETCH


# --------------------------------------------------------------------------- #
# the port against the Pallas kernel (interpret mode)                         #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("size,block_rows", [(8, 8), (96, 48)])
def test_port_matches_pallas_interpret(jx, size, block_rows):
    x = _crops("int", 2, size, seed=3)
    want = np.asarray(jx.hsv.hsv_color_hist(
        jx.jnp.asarray(x), jx.jnp.asarray(jx.ref.COLOR_RANGES),
        block_rows=block_rows, interpret=True))
    got, label = ops.hsv_color_classify(torch.from_numpy(x),
                                        block_rows=block_rows)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=INTERPRET_ATOL)
    np.testing.assert_array_equal(label.numpy(), want.argmax(-1))


# --------------------------------------------------------------------------- #
# the wrapper                                                                 #
# --------------------------------------------------------------------------- #
def test_cpu_tensor_takes_plain_version_without_a_launch():
    x = torch.from_numpy(_crops("int", 3, 16))
    ranges = torch.as_tensor(ref.COLOR_RANGES)
    before = hsv_color.launches
    hist = hsv_color.hsv_color_hist(x, ranges)
    assert hsv_color.launches == before  # only a kernel launch counts
    np.testing.assert_array_equal(hist.numpy(),
                                  ref.hsv_color_classify(x, ranges)[0].numpy())


def test_zero_rows_return_empty_histogram():
    ranges = torch.as_tensor(ref.COLOR_RANGES)
    hist = hsv_color.hsv_color_hist(torch.zeros((0, 64, 64, 3)), ranges)
    assert tuple(hist.shape) == (0, len(ref.COLOR_RANGES) + 1)
    hist, label = ops.hsv_color_classify(torch.zeros((0, 8, 8, 3)))
    assert tuple(hist.shape) == (0, 10) and tuple(label.shape) == (0,)


def test_wrapper_rejects_bad_shapes_and_devices():
    ranges = torch.as_tensor(ref.COLOR_RANGES)
    with pytest.raises(ValueError):
        hsv_color.hsv_color_hist(torch.zeros((2, 8, 8, 4)), ranges)
    with pytest.raises(ValueError):
        hsv_color.hsv_color_hist(torch.zeros((2, 8, 8, 3)), ranges[:, :5])
    with pytest.raises(ValueError):
        hsv_color.hsv_color_hist(torch.zeros((2, 8, 8, 3), device="meta"),
                                 ranges.to("meta"))


def test_uint8_crops_match_float_crops():
    x = _crops("int", 2, 8)
    a = ops.hsv_color_classify(torch.from_numpy(x.astype(np.uint8)))[0]
    b = ops.hsv_color_classify(torch.from_numpy(x))[0]
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_converted_range_table_gives_the_same_histogram(jx):
    x = _crops("int", 2, 8)
    table = convert.hsv_ranges(np.asarray(jx.jnp.asarray(jx.ref.COLOR_RANGES)),
                               device="cpu")
    assert table.dtype == torch.float32 and tuple(table.shape) == (9, 6)
    np.testing.assert_array_equal(
        ops.hsv_color_classify(torch.from_numpy(x), table)[0].numpy(),
        np.asarray(jx.ref.hsv_color_classify(jx.jnp.asarray(x))[0]))
    with pytest.raises(ValueError):
        convert.hsv_ranges(np.zeros((9, 5)), device="cpu")


def test_cuda_without_a_card_raises(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        udfs.color_predicate("black", size=8, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        udfs.planted_detector("d", np.ones(4, bool), work_dim=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        udfs.planted_classifier("c", 0, label_column="y")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.require_device("cuda")


# --------------------------------------------------------------------------- #
# on the card                                                                 #
# --------------------------------------------------------------------------- #
@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(32, 64, 64), (7, 96, 96), (3, 40, 24),
                                   (1, 64, 64)])
def test_kernel_matches_plain_version_on_card(card, shape):
    b, h, w = shape
    x = torch.from_numpy(
        np.random.default_rng(b).integers(0, 256, (b, h, w, 3))
        .astype(np.float32)).to(card)
    ranges = torch.as_tensor(ref.COLOR_RANGES, device=card)
    before = hsv_color.launches
    got = hsv_color.hsv_color_hist(x, ranges)
    want = ref.hsv_color_classify(x, ranges)[0]
    torch.cuda.synchronize()
    assert hsv_color.launches == before + 1
    assert float((got - want).abs().max()) <= INTERPRET_ATOL
    assert torch.equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.gpu
def test_kernel_on_edge_pixels_per_pixel(card):
    x = torch.from_numpy(edge_pixels().reshape(-1, 1, 1, 3)).to(card)
    ranges = torch.as_tensor(ref.COLOR_RANGES, device=card)
    got = hsv_color.hsv_color_hist(x, ranges)
    want = ref.hsv_color_classify(x, ranges)[0]
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_hooked_launch_on_card_reports_cuda_backend(card):
    events = []
    x = torch.zeros((4, 8, 8, 3), device=card)
    with launch.launch_hooks(events.append):
        with launch.thread_stream(card):
            ops.hsv_color_classify(x)
    assert [(e.name, e.backend, e.rows) for e in events] == [
        ("hsv_color", "cuda", 4)]


@pytest.mark.gpu
@pytest.mark.parametrize("side", [1, 7, 96])
@pytest.mark.parametrize("c", [1, 9, 16, 31])
def test_kernel_bit_equal_at_ragged_sizes_and_range_counts(card, side, c):
    """Ragged crops (1x1, 7x7: not 16-byte aligned; 96x96: eight CTAs of
    1,152 pixels) against 1, 9, 16 and 31 ranges (the 16- and 32-bucket
    instances), bit for bit."""
    rng = np.random.default_rng(side * 100 + c)
    x = torch.from_numpy(rng.integers(0, 256, (5, side, side, 3)).astype(
        np.float32)).to(card)
    base = np.tile(ref.COLOR_RANGES, (4, 1))[:c]
    ranges = torch.from_numpy(np.ascontiguousarray(base)).to(card)
    got = hsv_color.hsv_color_hist(x, ranges)
    want = ref.hsv_color_classify(x, ranges)[0]
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_histogram_rows_do_not_depend_on_the_batch(card):
    """A crop alone (a cluster of 8 CTAs) and among 4,096 (one CTA a crop)
    gives the same bits."""
    x = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (4096, 64, 64, 3)).astype(np.float32)).to(card)
    ranges = torch.as_tensor(ref.COLOR_RANGES, device=card)
    assert hsv_color.plan(1, 4096).cluster == 8
    assert hsv_color.plan(4096, 4096).cluster == 1
    whole = hsv_color.hsv_color_hist(x, ranges)
    for i in (0, 1, 2047, 4095):
        assert torch.equal(hsv_color.hsv_color_hist(x[i:i + 1], ranges),
                           whole[i:i + 1])
    assert torch.equal(hsv_color.hsv_color_hist(x[:16], ranges), whole[:16])
