"""The RG-LRU forward kernel's pipelined design and bf16 instance
(``csrc/rglru.cu``, ``kernels/rglru.py``).

On the CPU: a torch emulation of the pipelined design's order (chunks of
64 steps through a ring of input chunks and a ring of term chunks, the
walker's h_t written over m_t and stored from the slot before the slot
takes a new chunk; bf16 widened by the kernel's bit shift and rounded once
to nearest even by its integer rule) equals ``ref.rglru`` bit for bit on
float32 and bf16 inputs at ragged shapes, with and without h0; the term
threads' elements cover a chunk's tile once in both pipelined instances;
``route`` picks the stated design at the model's forward, train, decode
and predicate shapes; and the port's bf16 path agrees with the JAX
package's ``rglru_bsw`` (Pallas, interpret mode) and ``ref.rglru`` on the
same numpy-seeded bf16 inputs within ``TOL_TIGHT`` after widening. Tests
marked ``gpu`` run the kernel on the card (bit-equal to ``ref.rglru`` and
to the float32 instance cast, the kept h sequence to the float32
instance's output, the same bits on a rerun, a 2-byte-misaligned view,
every design forced at ragged shapes, no copy or cast in a bf16 call) and
skip without one. JAX is imported inside a fixture, so the ``gpu`` cases
also run on a card host that has no JAX.
"""
import types

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import ref, rglru

torch.set_num_threads(1)

TOL_TIGHT = dict(rtol=1e-4, atol=1e-5)
STEPS = 64   # a pipelined chunk's steps (csrc/rglru.cu kSteps)
RINGS = {torch.bfloat16: (4, 3), torch.float32: (3, 2)}  # (kIn, kSlots)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules the tests compare against."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ref as jax_ref
    from repro.kernels.rglru import rglru_bsw as jax_rglru_bsw
    return types.SimpleNamespace(jnp=jnp, ref=jax_ref, rglru_bsw=jax_rglru_bsw)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _draws(seed: int, b: int, s: int, w: int, dtype, with_h0: bool):
    """x, r, i (B, S, W), a_param (W,) and h0 (B, W) or None, from a numpy
    seed, in ``dtype`` (a_param float32)."""
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dtype)

    x, r, i = t(b, s, w), t(b, s, w), t(b, s, w)
    a_param = t(w).float()
    return x, r, i, a_param, t(b, w) if with_h0 else None


# --------------------------------------------------------------------------- #
# the pipelined design's order, emulated                                      #
# --------------------------------------------------------------------------- #
def _widen(t: torch.Tensor) -> torch.Tensor:
    """The kernel's widening: a bf16 element's bits as float32's top half
    (``widen4``); float32 as it is."""
    if t.dtype != torch.bfloat16:
        return t
    return (t.view(torch.int16).to(torch.int32) << 16).view(torch.float32)


def _round(h: torch.Tensor, dtype) -> torch.Tensor:
    """The kernel's store of float32 h in ``dtype``: bf16 rounded to
    nearest even by ``__floats2bfloat162_rn``'s integer rule."""
    if dtype != torch.bfloat16:
        return h.clone()
    u = h.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    top = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) & 0xFFFF
    return ((top ^ 0x8000) - 0x8000).to(torch.int16).view(torch.bfloat16)


def _pipelined_rglru(x, r, i, a_param, h0, c=8.0):
    """The pipelined design's order: per chunk c of STEPS steps, the term
    threads wait for chunk c's copies (input ring slot c % kIn, filled
    kIn - 1 chunks ahead into the slot read for chunk c - 1), store the
    walked chunk c - kSlots from term slot c % kSlots, then form a_t and
    m_t there; the walker walks the slot, h_t over m_t, h carried across
    chunks; the last kSlots chunks are stored after the loop. Returns
    (out, h_last) in x's dtype and the float32 h sequence."""
    b, s, w = x.shape
    n_in, n_slots = RINGS[x.dtype]
    f32 = torch.float32
    nc = -(-s // STEPS)
    nsp = -c * ref.softplus(a_param.to(f32))
    in_ring = [None] * n_in
    slots = [None] * n_slots   # (a_t, m_t then h_t) of a chunk
    out = torch.empty((b, s, w), dtype=x.dtype)
    hs = torch.empty((b, s, w), dtype=f32)
    h = torch.zeros((b, w), dtype=f32) if h0 is None else _widen(h0).to(f32)

    def rows(k):
        return slice(k * STEPS, min((k + 1) * STEPS, s))

    def load(k):
        if k < nc:
            in_ring[k % n_in] = (k, *(t[:, rows(k)].clone() for t in (x, r, i)))

    def store(k):
        got, _, th = slots[k % n_slots]
        assert got == k, "a slot stored the wrong chunk"
        hs[:, rows(k)] = th
        out[:, rows(k)] = _round(th, x.dtype)

    for k in range(n_in - 1):
        load(k)
    for k in range(nc):
        load(k + n_in - 1)
        got, tx, tr, ti = in_ring[k % n_in]
        assert got == k, "the input ring holds the wrong chunk"
        if k >= n_slots:
            store(k - n_slots)
        a = torch.exp(nsp * ref.sigmoid(_widen(tr)))
        gated = ref.sigmoid(_widen(ti)) * _widen(tx)
        m = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * gated
        slots[k % n_slots] = (k, a, m)
        for t in range(a.shape[1]):   # the walker
            h = a[:, t] * h + m[:, t]
            m[:, t] = h
    for k in range(max(nc - n_slots, 0), nc):
        store(k)
    return out, _round(h, x.dtype), hs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [1, 33, 70, 2560])
@pytest.mark.parametrize("w", [7, 40, 4100])
@pytest.mark.parametrize("with_h0", [False, True])
def test_pipelined_emulation_is_bit_equal(dtype, s, w, with_h0):
    b = 1 if s * w > 100_000 else 2
    x, r, i, a_param, h0 = _draws(s + w, b, s, w, dtype, with_h0)
    out, h_last, hs = _pipelined_rglru(x, r, i, a_param, h0)
    want, want_last = ref.rglru(x, r, i, a_param, h0)
    assert out.dtype == dtype and h_last.dtype == dtype
    assert torch.equal(out, want) and torch.equal(h_last, want_last)
    # the kept float32 sequence is the float32 plain version's output
    f32 = [t.float() for t in (x, r, i)]
    want_hs, _ = ref.rglru(*f32, a_param, None if h0 is None else h0.float())
    assert torch.equal(hs, want_hs)


def _owners(warps: int, tw: int) -> np.ndarray:
    """How many times the term threads of an instance with ``warps`` term
    warps take each element of a chunk's (STEPS, 32) tile whose first
    ``tw`` channels are real (``load``, ``terms`` and ``store`` walk the
    same elements: rows tid / 8 + k * (threads / 8), channels 4 (tid % 8)
    .. + 3, cut at tw)."""
    threads = warps * 32
    per, row_step = STEPS * 32 // 4 // threads, threads // 8
    seen = np.zeros((STEPS, 32), np.int64)
    for tid in range(threads):
        col = (tid % 8) * 4
        left = tw - col
        for k in range(per):
            t = tid // 8 + k * row_step
            for j in range(min(max(left, 0), 4)):
                seen[t, col + j] += 1
    return seen


@pytest.mark.parametrize("warps", [16, 8])
@pytest.mark.parametrize("tw", [32, 8, 7, 4, 1])
def test_term_threads_cover_each_element_once(warps, tw):
    seen = _owners(warps, tw)
    assert (seen[:, :tw] == 1).all() and (seen[:, tw:] == 0).all()


# --------------------------------------------------------------------------- #
# the route                                                                   #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,design", [
    ((1, 2560, 4096), rglru.PIPELINED),         # recurrentgemma's forward
    ((2, 2560, 4096), rglru.PIPELINED_PAIRS),   # its train step
    ((1, 1, 4096), rglru.STAGED),               # its decode step
    ((1, 2560, 16), rglru.STAGED),              # a tiny width
    ((32, 64, 16), rglru.STAGED),               # the predicates
    ((4096, 64, 16), rglru.STAGED),
    ((16, 32, 16), rglru.STAGED),
    ((1, 64, 4096), rglru.PIPELINED),           # a short prefill
    ((1, 2560, 32), rglru.PIPELINED),           # one tile
    ((8, 256, 4096), rglru.PIPELINED_PAIRS),
])
def test_route_picks_the_stated_design(dtype, shape, design):
    """The route and the design packed for inputs of either dtype (the
    full shapes as expanded views: nothing is allocated)."""
    assert rglru.route(*shape) == design
    b, s, w = shape
    x = torch.zeros(1, dtype=dtype).expand(b, s, w)
    h = torch.zeros(1, dtype=dtype).expand(b, w)
    args = rglru.pack_args(x, x, x, torch.zeros(w), h, x, h)
    assert rglru.ARGS.unpack(args)[-1] == design


def test_packed_arguments_carry_dtypes_and_design():
    x = torch.zeros((2, 3, 4), dtype=torch.bfloat16)
    h0 = torch.zeros((2, 4), dtype=torch.bfloat16)
    args = rglru.pack_args(x, x, x, torch.zeros(4), h0, x, h0,
                           torch.zeros((2, 3, 4)), design=2)
    fields = rglru.ARGS.unpack(args)
    assert fields[4] == h0.data_ptr() and fields[8:11] == (2, 3, 4)
    assert fields[11] == 8.0 and fields[12:] == (1, 0, 1, 2)
    args = rglru.pack_args(*(torch.zeros((1, 2560, 64)) for _ in range(3)),
                           torch.zeros(64), None, x, h0)
    assert rglru.ARGS.unpack(args)[4] == 0
    assert rglru.ARGS.unpack(args)[12:] == (0, 0, 0, rglru.PIPELINED)


# --------------------------------------------------------------------------- #
# the port's bf16 path against the JAX package                                #
# --------------------------------------------------------------------------- #
def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at |v| (8 significant bits)."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126))) - 7)


@pytest.mark.parametrize("b,s,w", [(2, 64, 128), (1, 256, 64), (2, 96, 40)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_bf16_path_matches_jax(jx, b, s, w, with_h0):
    """The port's bf16 path (out and h_last bf16, the float32 h sequence
    kept beside them) against the JAX package's ``ref.rglru`` and Pallas
    ``rglru_bsw`` on the same bf16 inputs. Each computes in float32 on the
    widened inputs and rounds once at the end, so the float32 sequences
    are held to ``TOL_TIGHT`` (the JAX functions run on the widened
    inputs: their bf16 calls widen the same way first), the port's bf16
    outputs are its float32 ones rounded, and the JAX functions' own bf16
    outputs lie within one bf16 step of the port's: two roundings of
    float32 values a few float32 ulps apart differ by one step where a
    rounding boundary falls between them (1 of 16,384 elements at (1, 256,
    64))."""
    x, r, i, a_param, h0 = _draws(7 * s + w, b, s, w, torch.bfloat16, True)
    h0 = h0 if with_h0 else None
    jnp = jx.jnp
    out, h_last, hs = rglru._forward(x, r, i, a_param, h0, 8.0, keep_hs=True)
    assert out.dtype == h_last.dtype == torch.bfloat16
    assert torch.equal(out, hs.to(torch.bfloat16))
    assert torch.equal(h_last, hs[:, -1].to(torch.bfloat16))

    def J(t, dtype=jnp.float32):
        return None if t is None else jnp.asarray(t.float().numpy(), dtype)

    def pallas(*args, state):
        return jx.rglru_bsw(*args, state, block_s=32, block_w=min(w, 512),
                            interpret=True)

    wide = [J(t) for t in (x, r, i)]
    narrow = [J(t, jnp.bfloat16) for t in (x, r, i)]
    zero = jnp.zeros((b, w), jnp.float32)
    runs = {
        "ref.rglru": (jx.ref.rglru(*wide, J(a_param), J(h0)),
                      jx.ref.rglru(*narrow, J(a_param), J(h0, jnp.bfloat16))),
        "rglru_bsw": (pallas(*wide, J(a_param), state=J(h0) if with_h0
                             else zero),
                      pallas(*narrow, J(a_param), state=(
                          J(h0, jnp.bfloat16) if with_h0
                          else zero.astype(jnp.bfloat16)))),
    }
    for name, ((o32, last32), (o16, last16)) in runs.items():
        np.testing.assert_allclose(hs.numpy(), np.asarray(o32), **TOL_TIGHT,
                                   err_msg=name)
        np.testing.assert_allclose(hs[:, -1].numpy(), np.asarray(last32),
                                   **TOL_TIGHT, err_msg=name)
        for got, theirs in ((out, o16), (h_last, last16)):
            g = got.float().numpy()
            t = np.asarray(theirs.astype(jnp.float32))
            assert (np.abs(g - t) <= _bf16_ulp(t)).all(), name


def test_autograd_forward_keeps_the_float32_sequence():
    """``Rglru``'s forward on bf16 inputs returns bf16 and keeps the
    float32 h sequence, the float32 plain version's output (on the CPU,
    its plain version)."""
    x, r, i, a_param, h0 = _draws(11, 2, 70, 40, torch.bfloat16, True)
    out, h_last, hs = rglru._forward(x, r, i, a_param, h0, 8.0, keep_hs=True)
    want, want_last = ref.rglru(x, r, i, a_param, h0)
    assert torch.equal(out, want) and torch.equal(h_last, want_last)
    f32 = [t.float() for t in (x, r, i)]
    assert hs.dtype == torch.float32
    assert torch.equal(hs, ref.rglru(*f32, a_param, h0.float())[0])


# --------------------------------------------------------------------------- #
# on the card                                                                 #
# --------------------------------------------------------------------------- #
CARD_CASES = [   # (B, S, W), h0
    ((1, 2560, 4096), False),   # recurrentgemma-9b's forward
    ((2, 2560, 4096), False),   # its train step
    ((2, 2560, 4096), True),
    ((1, 1, 4096), True),       # a decode step from a bf16 state
    ((3, 200, 40), True),       # ragged: a tile of 8 channels
    ((1, 2560, 4100), True),    # a tile of 4
    ((2, 130, 70), False),      # a tile of 6: element-wise copies
    ((2, 33, 7), True),
]


def _on(card, ts):
    return [None if t is None else t.to(card) for t in ts]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,with_h0", CARD_CASES)
def test_bf16_instance_bit_equal_on_card(card, shape, with_h0):
    x, r, i, a_param, h0 = _on(card, _draws(sum(shape), *shape,
                                            torch.bfloat16, with_h0))
    got = rglru.rglru_bsw(x, r, i, a_param, h0)
    again = rglru.rglru_bsw(x, r, i, a_param, h0)
    want = ref.rglru(x, r, i, a_param, h0)
    f32 = [t.float() for t in (x, r, i)]
    h0f = None if h0 is None else h0.float()
    wide = rglru.rglru_bsw(*f32, a_param, h0f)
    torch.cuda.synchronize()
    for g, a, p, f in zip(got, again, want, wide):
        assert g.dtype == torch.bfloat16
        assert torch.equal(g, p) and torch.equal(g, a)
        assert torch.equal(g, f.to(torch.bfloat16))
    # the kept float32 sequence: the float32 instance's output
    leaves = [t.clone().requires_grad_() for t in (x, r, i)]
    out, h_last, hs = rglru._forward(*leaves, a_param, h0, 8.0, keep_hs=True)
    torch.cuda.synchronize()
    assert torch.equal(out, got[0]) and torch.equal(h_last, got[1])
    assert hs.dtype == torch.float32 and torch.equal(hs, wide[0])


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 2560, 4096), (2, 300, 64),
                                   (1, 1, 4096)])
def test_misaligned_bf16_view_on_card(card, shape):
    """x, r and i 2 bytes off a 16-byte boundary (contiguous views of
    larger buffers): the element-wise copies, the same bits."""
    x, r, i, a_param, h0 = _on(card, _draws(5, *shape, torch.bfloat16, True))
    views = []
    for t in (x, r, i):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=card)
        v = buf[1:].view(t.shape)
        v.copy_(t)
        assert v.data_ptr() % 16 == 2
        views.append(v)
    got = rglru.rglru_bsw(*views, a_param, h0)
    want = ref.rglru(x, r, i, a_param, h0)
    torch.cuda.synchronize()
    assert all(torch.equal(g, p) for g, p in zip(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("design", [rglru.STAGED, rglru.PIPELINED,
                                    rglru.PIPELINED_PAIRS])
@pytest.mark.parametrize("shape", [(2, 200, 40), (1, 130, 4100),
                                   (3, 70, 7), (2, 1, 64)])
def test_every_design_bit_equal_on_card(card, dtype, design, shape):
    """Each design forced at the C entry point, with a bf16 a_param and
    h0 and the float32 h sequence written: out, h_last and hs equal the
    plain version's."""
    x, r, i, _, h0 = _on(card, _draws(3, *shape, dtype, True))
    a_param = torch.randn(shape[2], device=card).to(torch.bfloat16)
    h0 = h0.to(torch.bfloat16)
    out, h_last = torch.empty_like(x), torch.empty_like(h0).to(dtype)
    hs = torch.empty(shape, device=card)
    err = rglru._build.load("rglru").lib.rglru_bsw(
        rglru.pack_args(x, r, i, a_param, h0, out, h_last, hs,
                        design=design), torch.cuda.current_stream().cuda_stream)
    assert err == 0
    want, want_last = ref.rglru(x, r, i, a_param, h0)
    f32 = [t.float() for t in (x, r, i)]
    want_hs, _ = ref.rglru(*f32, a_param, h0)
    torch.cuda.synchronize()
    assert torch.equal(out, want) and torch.equal(h_last, want_last)
    assert torch.equal(hs, want_hs)


class _Ops(TorchDispatchMode):
    """The aten operations called inside the mode."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(func.__name__)
        return func(*args, **(kwargs or {}))


@pytest.mark.gpu
@pytest.mark.parametrize("shape,with_h0,grad", [
    ((1, 2560, 4096), False, False), ((2, 2560, 4096), False, True),
    ((1, 1, 4096), True, False)])
def test_bf16_call_makes_no_copy_on_card(card, shape, with_h0, grad):
    """A bf16 model's call (bf16 a_param and h0, as the hybrid family's
    parameters and state are) allocates its outputs and launches once: no
    copy, no cast."""
    x, r, i, a_param, h0 = _on(card, _draws(9, *shape, torch.bfloat16,
                                            with_h0))
    a_param = a_param.to(torch.bfloat16)
    if grad:
        x.requires_grad_()
    before = rglru.launches
    with _Ops() as ops:
        rglru.rglru_bsw(x, r, i, a_param, h0)
    torch.cuda.synchronize()
    assert rglru.launches == before + 1
    assert not [n for n in ops.names
                if n.split(".")[0] in ("_to_copy", "copy_", "clone", "to",
                                       "contiguous")], ops.names
