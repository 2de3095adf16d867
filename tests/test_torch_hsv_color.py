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
    table = convert.hsv_ranges(np.asarray(jx.jnp.asarray(jx.ref.COLOR_RANGES)))
    assert table.dtype == torch.float32 and tuple(table.shape) == (9, 6)
    np.testing.assert_array_equal(
        ops.hsv_color_classify(torch.from_numpy(x), table)[0].numpy(),
        np.asarray(jx.ref.hsv_color_classify(jx.jnp.asarray(x))[0]))
    with pytest.raises(ValueError):
        convert.hsv_ranges(np.zeros((9, 5)))


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
