"""Mamba-2 SSD chunked scan, for Hopper.

Port of ``repro.kernels.ssd``. For CUDA tensors the wrappers call the
hand-written kernel in ``csrc/ssd.cu`` or raise; for CPU tensors they run
the plain version in ``ref.py``. The kernel has two designs behind one
entry point (see the source's note): at P = N = 4, the text predicate's
shapes, one launch of a warp per (b, h) walking the chunks in order; at
every other shape (mamba2's scan) three launches on the tensor cores --
chunk states, the pass over the chunks and per-chunk outputs -- through
scratch the wrapper allocates (``scratch_floats``). The kernel reads every
operand through its strides: ``ssd_bshp`` takes the model's (B, S, H, P)
views as they are (a dt broadcast over heads included) and writes
(B, S, H, P); ``ssd_bhcp`` takes the JAX package's (B, H, S, P) layout.
``launches`` counts the kernel's calls, one a call whatever its number of
launches, so a run can show that it went through the kernel.

Both wrappers are differentiable. When grad mode is on and an input
requires a gradient, they go through ``Ssd``, a
``torch.autograd.Function`` whose backward is ``ssd_bwd``: the
hand-written gradient kernel in ``csrc/ssd_bwd.cu`` on the card
(``backward_launches`` counts its calls, four launches each: chunk
states, the passes over the chunks, the per-chunk gradients, a CTA
taking K heads in turn and summing their dB and dC shares, and the
ordered sums) and ``ref.ssd_bwd`` on the CPU. Its scratch is the chunk
states and their gradients, each chunk's cum and dA share, and one
partial of dB and of dC a CTA of K heads (``cta_heads`` gives K).
The JAX package differentiates its plain scan instead: its Pallas kernel
has no backward. A shape whose gradient tiles outgrow a CTA's shared
memory (``grad_smem_bytes``) is refused before the forward runs, on both
devices.
"""
from __future__ import annotations

import struct
import threading

import torch

from repro_torch.kernels import _build, ref

MAX_CHUNK = 64  # a chunk's rows: two a lane (P = N = 4), four 16-row tiles
SMEM_LIMIT = 227 * 1024  # shared memory one CTA may hold
MAX_CTA_HEADS = 8  # heads one CTA of the gradient's per-chunk stage takes
SMS = 132          # the H100 SXM's SMs: a wave of that stage's CTAs

launches = 0           # forward kernel calls (one or three launches each)
backward_launches = 0  # gradient kernel calls (four launches each)
_COUNT_LOCK = threading.Lock()

# the C entry point's packed arguments (SsdArgs in the source): x, dt, A,
# Bm, Cm, h0 (0 for a zero state), y, h_last; the element strides of x,
# dt, Bm, Cm and y in (b, s, h, last) order; batch, heads, seq, P, G, N,
# chunk and a word the entry point fills (which operands move in 16-byte
# pieces)
ARGS = struct.Struct("<8Q19q8i")
# the gradient entry point's (SsdBwdArgs): x, dt, A, Bm, Cm, h0 or 0, dy,
# dh_last or 0, dx, ddt, dA, dB, dC, dh0 or 0, then the scratch (states,
# grads, cum, dB_part, dC_part, dA_part); the element strides of x,
# dt, Bm, Cm and dy in (b, s, h, last) order; batch, heads, seq, P, G, N,
# chunk and a word the entry point fills (which operands move in 16-byte
# pieces)
BWD_ARGS = struct.Struct("<20Q19q8i")


def bhsp_strides(t: torch.Tensor) -> tuple:
    """Element strides of a (B, H, S[, last]) view, in (b, s, h, last)
    order."""
    s = t.stride()
    return (s[0], s[2], s[1]) + tuple(s[3:])


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype == torch.float32 else t.to(torch.float32)


def stage_floats(b: int, h: int, s: int, p: int, n: int, chunk: int) -> int:
    """Float32 scratch the three stages take at any shape: the chunk
    states, B H (S / chunk) P N floats, then each chunk's cum, B H S
    (``launch_stages`` in ``csrc/ssd.cu``)."""
    return b * h * (s // chunk) * p * n + b * h * s


def scratch_floats(b: int, h: int, s: int, p: int, n: int,
                   chunk: int) -> int:
    """Float32 scratch one forward call takes on the card: none at
    P = N = 4 (one launch), else ``stage_floats``."""
    if p == 4 and n == 4:
        return 0
    return stage_floats(b, h, s, p, n, chunk)


def _check(shapes: tuple, want: tuple, h: int, g: int, s: int,
           chunk: int) -> None:
    """Raise unless dt, A, Cm and h0 (None passes) have the shapes ``want``
    and the sizes suit the chunked scan."""
    if shapes != want:
        for label, got, shape in zip(("dt", "A", "Cm", "h0"), shapes, want):
            if got != shape:
                raise ValueError(f"{label} must be {shape}, got {got}")
    if g == 0 or h % g or chunk <= 0 or s % chunk:
        raise ValueError(f"need G | H and chunk | S, got H={h} G={g} S={s} "
                         f"chunk={chunk}")


def grad_smem_bytes(chunk: int, p: int, n: int) -> int:
    """Shared memory the gradient kernel's per-chunk stage takes
    (``grads_floats`` in ``csrc/ssd_bwd.cu``, in bytes): the tiles x and
    dy (L, P), B and C (L, N), h_in and dH (P, N) and M and E (L, L), L
    and P rounded up to 16 and N to 32 (the tensor cores' fragments), each
    row 4 floats longer; four (L,) vectors; the triangle's row and column
    sums, x_m . dH B_m and e_l dy_l . h_in C_l, an (L,) vector for each
    tile of their products; and 16 slots."""
    def up(v, m):
        return -(-v // m) * m
    lp, pp, nq = up(chunk, 16), up(p, 16), up(n, 32)
    return 4 * (2 * lp * (pp + 4) + 2 * lp * (nq + 4) + 2 * pp * (nq + 4)
                + 2 * lp * (lp + 4) + 4 * lp + 2 * (lp // 16) * lp
                + (pp // 16) * lp + (nq // 32) * lp + 16)


def cta_heads(b: int, s: int, h: int, g: int, chunk: int) -> int:
    """K, the heads one CTA of the gradient's per-chunk stage takes in turn,
    summing their dB and dC shares into one partial (``cta_heads`` in
    ``csrc/ssd_bwd.cu``, whose entry ``ssd_bwd_parts`` the wrapper holds
    this to): of the divisors of H / G up to ``MAX_CTA_HEADS`` (a CTA's
    heads share a group), the one whose waves of B (S / chunk) H / K CTAs
    on the card's ``SMS`` SMs, times K, are least, the largest of those
    that tie. By the shape alone; the ordered sums then take H / K
    partials a (b, s)."""
    chunks = b * (s // chunk)
    best, least = 1, -(-chunks * h // SMS)
    for k in range(2, MAX_CTA_HEADS + 1):
        if (h // g) % k == 0:
            t = -(-chunks * (h // k) // SMS) * k
            if t <= least:
                best, least = k, t
    return best


def _check_grad(chunk: int, p: int, n: int) -> None:
    """Raise unless the gradient kernel takes this shape (on the CPU too,
    so that the CPU does not train what the card refuses)."""
    if chunk > MAX_CHUNK:
        raise ValueError(f"the ssd gradient takes chunk <= {MAX_CHUNK}, got "
                         f"{chunk}")
    need = grad_smem_bytes(chunk, p, n)
    if need > SMEM_LIMIT:
        raise ValueError(f"the ssd gradient's tiles at chunk={chunk} P={p} "
                         f"N={n} take {need} bytes of shared memory, more "
                         f"than a CTA's {SMEM_LIMIT}")


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def flops(b: int, s: int, h: int, p: int, n: int, chunk: int) -> int:
    """The forward's operations, counted as ``bwd_flops`` counts the
    gradient's: per (b, h, chunk) 2 L P N multiply-adds (the chunk state
    and C h_in^T) and T (N + P) on the triangle (C B^T and its product
    with x), T = L (L + 1) / 2, two operations each; the pass's P N a
    chunk is left out, as there."""
    tri = chunk * (chunk + 1) // 2
    return 2 * b * h * (s // chunk) * (2 * chunk * p * n + tri * (n + p))


def bwd_flops(b: int, s: int, h: int, p: int, n: int, chunk: int) -> int:
    """The gradient's (``csrc/ssd_bwd.cu``'s bound note): per (b, h,
    chunk) 5 L P N multiply-adds and T (3 N + 2 P) on the triangles, T =
    L (L + 1) / 2, two operations each."""
    tri = chunk * (chunk + 1) // 2
    return 2 * b * h * (s // chunk) * (5 * chunk * p * n
                                       + tri * (3 * n + 2 * p))


_entry = None  # the library's C function, looked up once
_bwd_entry = None
_parts_entry = None


def _launch(x, dt, A, Bm, Cm, h0, y, strides, sizes, chunk: int):
    """Launch the kernel on the current stream of x's card, each operand
    addressed by its ``strides`` (x, dt, Bm, Cm, y, in (b, s, h, last)
    order); ``sizes`` is (B, S, H, P, G, N). Returns (y, h_last)."""
    global _entry, launches
    b, s, h, p, g, n = sizes
    dev = x.get_device()
    if not (dt.get_device() == A.get_device() == Bm.get_device()
            == Cm.get_device() == dev) or (
                h0 is not None and h0.get_device() != dev):
        raise ValueError(f"all inputs must lie on {x.device}")
    if chunk > MAX_CHUNK:
        raise ValueError(f"chunk must be at most {MAX_CHUNK}, got {chunk}")
    if A.dtype != torch.float32 or not A.is_contiguous():
        A = A.to(torch.float32).contiguous()
    if h0 is not None and (h0.dtype != torch.float32 or not h0.is_contiguous()):
        h0 = h0.to(torch.float32).contiguous()
    h_last = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    floats = scratch_floats(b, h, s, p, n, chunk)
    scratch = (torch.empty(floats, dtype=torch.float32, device=x.device)
               if floats else None)
    sx, sdt, sb, sc, sy = strides
    if _build.traced("ssd", flops(b, s, h, p, n, chunk),
                     (x, dt, A, Bm, Cm, h0), (y, h_last)):
        return y, h_last
    if _entry is None:
        _entry = _build.load("ssd").lib.ssd_scan
    err = _entry(ARGS.pack(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), 0 if h0 is None else h0.data_ptr(), y.data_ptr(),
        h_last.data_ptr(), *sx, *sdt, *sb, *sc, *sy, b, h, s, p, g, n, chunk,
        0), None if scratch is None else scratch.data_ptr(),
        _build.raw_stream(dev))
    if err != 0:
        raise RuntimeError(f"ssd kernel launch failed: CUDA error {err}")
    with _COUNT_LOCK:
        launches += 1
    return y, h_last


def _not_cuda(x) -> ValueError:
    return ValueError(f"ssd runs on cpu or cuda, not {x.device}")


def _forward_f32(x, dt, A, Bm, Cm, h0, chunk: int, bhcp: bool):
    """(y float32 in x's layout, h_last float32) of float32 operands in
    the (B, S, H, P) layout, or the (B, H, S, P) one when ``bhcp``: the
    kernel's on the card, the plain version's on the CPU."""
    if not _build.on_card(x):
        if x.device.type != "cpu":
            raise _not_cuda(x)
        if bhcp:
            y, h_last = ref.ssd(x.transpose(1, 2), dt.transpose(1, 2), A,
                                Bm.transpose(1, 2), Cm.transpose(1, 2), h0,
                                chunk=chunk)
            return y.transpose(1, 2), h_last
        return ref.ssd(x, dt, A, Bm, Cm, h0, chunk=chunk)
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    if bhcp:
        b, h, s, p = x.shape
        strides = tuple(map(bhsp_strides, (x, dt, Bm, Cm, y)))
        g, n = Bm.shape[1], Bm.shape[3]
    else:
        b, s, h, p = x.shape
        strides = tuple(t.stride() for t in (x, dt, Bm, Cm, y))
        g, n = Bm.shape[2], Bm.shape[3]
    return _launch(x, dt, A, Bm, Cm, h0, y, strides, (b, s, h, p, g, n),
                   chunk)


def ssd_bwd(x, dt, A, Bm, Cm, h0, dy, dh_last, *, chunk: int = 64):
    """(dx, ddt, dA, dB, dC, dh0), all float32: the gradient of
    ``ssd_bshp`` (formulas in ``ref.ssd_bwd``) for the cotangents ``dy``
    (B, S, H, P) and ``dh_last`` (B, H, P, N), each None for zero, in the
    (B, S, H, P) layout; dh0 is None when h0 is. On the card one call of
    the gradient kernel (four launches: chunk states, the passes over the
    chunks, the per-chunk gradients and the ordered sums), which reads x,
    dt, Bm, Cm and dy through their strides, into scratch of the chunk
    states and their gradients (B H (S / chunk) P N floats each), cum (B
    H S), dA's shares (B H (S / chunk)) and one partial of dB and of dC a
    CTA of K heads (B S (H / K) N each, K from ``cta_heads``); on the CPU
    the plain version."""
    global _bwd_entry, _parts_entry, backward_launches
    if not _build.on_card(x):
        if x.device.type != "cpu":
            raise _not_cuda(x)
        return ref.ssd_bwd(x, dt, A, Bm, Cm, h0, dy, dh_last, chunk=chunk)
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    _check_grad(chunk, p, n)
    f32 = torch.float32
    xf, dtf, Bf, Cf = _f32(x), _f32(dt), _f32(Bm), _f32(Cm)
    dyf = (torch.zeros((), dtype=f32, device=x.device).expand(x.shape)
           if dy is None else _f32(dy))   # zero strides: nothing to read
    Af = _build.f32_contiguous(A)
    h0f = None if h0 is None else _build.f32_contiguous(h0)
    dhl = None if dh_last is None else _build.f32_contiguous(dh_last)
    dev = x.get_device()
    if any(t is not None and t.get_device() != dev
           for t in (dtf, Af, Bf, Cf, dyf, h0f, dhl)):
        raise ValueError(f"all inputs must lie on {x.device}")
    nc = s // chunk

    def empty(*shape):
        return torch.empty(shape, dtype=f32, device=x.device)

    dx, ddt, dA = empty(b, s, h, p), empty(b, s, h), empty(h)
    dB, dC = empty(b, s, g, n), empty(b, s, g, n)
    dh0 = None if h0 is None else empty(b, h, p, n)
    parts = h // cta_heads(b, s, h, g, chunk)
    scratch = (empty(b, h, nc, p, n), empty(b, h, nc, p, n), empty(b, h, s),
               empty(b, s, parts, n), empty(b, s, parts, n), empty(b, h, nc))
    if _build.traced("ssd_bwd", bwd_flops(b, s, h, p, n, chunk),
                     (xf, dtf, Af, Bf, Cf, h0f, dyf, dhl),
                     (dx, ddt, dA, dB, dC, dh0)):
        return dx, ddt, dA, dB, dC, dh0
    if _bwd_entry is None:
        lib = _build.load("ssd_bwd").lib
        _bwd_entry, _parts_entry = lib.ssd_bwd, lib.ssd_bwd_parts
    # the kernel writes as many partials as its own rule says: the scratch
    # must hold them
    if _parts_entry(b, s, h, g, chunk) != parts:
        raise RuntimeError(f"ssd_bwd writes {_parts_entry(b, s, h, g, chunk)}"
                           f" partials of dB a (b, s), the scratch holds "
                           f"{parts}")
    ptrs = (xf, dtf, Af, Bf, Cf, h0f, dyf, dhl, dx, ddt, dA, dB, dC, dh0,
            *scratch)
    err = _bwd_entry(BWD_ARGS.pack(
        *(0 if t is None else t.data_ptr() for t in ptrs),
        *xf.stride(), *dtf.stride(), *Bf.stride(), *Cf.stride(),
        *dyf.stride(), b, h, s, p, g, n, chunk, 0), _build.raw_stream(dev))
    if err != 0:
        raise RuntimeError(f"ssd_bwd kernel launch failed: CUDA error {err}")
    with _COUNT_LOCK:
        backward_launches += 1
    return dx, ddt, dA, dB, dC, dh0


class Ssd(torch.autograd.Function):
    """``ssd_bshp`` (``bhcp`` False) or ``ssd_bhcp`` (True) with its
    gradient: ``apply(x, dt, A, Bm, Cm, h0, chunk, bhcp)`` -> (y in x's
    dtype, h_last float32). The forward launches the forward kernel and
    keeps the float32 operands it makes; the backward, ``ssd_bwd``,
    recomputes the states, so nothing else is kept. The gradients come
    back in the inputs' dtypes, and a cotangent autograd leaves out (None)
    is zero. Under remat the forward runs again in the backward pass (and
    counts again in ``launches``)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, h0, chunk, bhcp):
        ctx.set_materialize_grads(False)
        xf, dtf, Bf, Cf = _f32(x), _f32(dt), _f32(Bm), _f32(Cm)
        y, h_last = _forward_f32(xf, dtf, A, Bf, Cf, h0, chunk, bhcp)
        ctx.save_for_backward(xf, dtf, A, Bf, Cf, h0)
        ctx.chunk, ctx.bhcp = chunk, bhcp
        ctx.dtypes = (x.dtype, dt.dtype, A.dtype, Bm.dtype, Cm.dtype,
                      None if h0 is None else h0.dtype)
        return y.to(x.dtype), h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        x, dt, A, Bm, Cm, h0 = ctx.saved_tensors
        if ctx.bhcp:   # the (B, S, H, P) views of the (B, H, S, P) layout
            x, dt, Bm, Cm = (t.transpose(1, 2) for t in (x, dt, Bm, Cm))
            dy = None if dy is None else dy.transpose(1, 2)
        grads = list(ssd_bwd(x, dt, A, Bm, Cm, h0, dy, dh_last,
                             chunk=ctx.chunk))
        if ctx.bhcp:
            for i in (0, 1, 3, 4):   # dx, ddt, dB, dC
                grads[i] = grads[i].transpose(1, 2)
        return (*(None if g is None else g.to(d)
                  for g, d in zip(grads, ctx.dtypes)), None, None)


def ssd_bshp(
    x: torch.Tensor,    # (B, S, H, P)
    dt: torch.Tensor,   # (B, S, H)
    A: torch.Tensor,    # (H,)
    Bm: torch.Tensor,   # (B, S, G, N)
    Cm: torch.Tensor,   # (B, S, G, N)
    h0: torch.Tensor | None = None,  # (B, H, P, N); None: a zero state
    *,
    chunk: int = 64,
):
    """(y (B, S, H, P) in x's dtype, h_last (B, H, P, N) float32) in the
    model's layout, on views as they are: on the card no operand is copied
    (float32 inputs; others are converted), a None h0 is a zero state
    inside the kernel, and the kernel writes the (B, S, H, P) result
    itself. Differentiable (``Ssd``)."""
    if x.dim() != 4 or Bm.dim() != 4:
        raise ValueError(f"x and Bm must be 4-d, got {tuple(x.shape)} and "
                         f"{tuple(Bm.shape)}")
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    _check((dt.shape, A.shape, Cm.shape, None if h0 is None else h0.shape),
           ((b, s, h), (h,), (b, s, g, n), None if h0 is None else (b, h, p, n)),
           h, g, s, chunk)
    grad = _wants_grad(x, dt, A, Bm, Cm, h0)
    if grad:
        _check_grad(chunk, p, n)
    if b == 0:
        return (torch.zeros_like(x),
                torch.zeros((0, h, p, n), dtype=torch.float32, device=x.device))
    if grad:
        return Ssd.apply(x, dt, A, Bm, Cm, h0, chunk, False)
    y, h_last = _forward_f32(_f32(x), _f32(dt), A, _f32(Bm), _f32(Cm), h0,
                             chunk, False)
    return (y if x.dtype == torch.float32 else y.to(x.dtype)), h_last


def ssd_bhcp(
    x: torch.Tensor,    # (B, H, S, P)
    dt: torch.Tensor,   # (B, H, S)
    A: torch.Tensor,    # (H,)
    Bm: torch.Tensor,   # (B, G, S, N)
    Cm: torch.Tensor,   # (B, G, S, N)
    h0: torch.Tensor,   # (B, H, P, N)
    *,
    chunk: int = 64,
):
    """(y (B, H, S, P) in x's dtype, h_last (B, H, P, N) float32) in the
    JAX package's layout: the function of ``ssd_bshp``, read and written
    through the (B, H, S, P) strides. Differentiable (``Ssd``)."""
    if x.dim() != 4 or Bm.dim() != 4:
        raise ValueError(f"x and Bm must be 4-d, got {tuple(x.shape)} and "
                         f"{tuple(Bm.shape)}")
    b, h, s, p = x.shape
    g, n = Bm.shape[1], Bm.shape[3]
    _check((dt.shape, A.shape, Cm.shape, None if h0 is None else h0.shape),
           ((b, h, s), (h,), (b, g, s, n), None if h0 is None else (b, h, p, n)),
           h, g, s, chunk)
    grad = _wants_grad(x, dt, A, Bm, Cm, h0)
    if grad:
        _check_grad(chunk, p, n)
    if b == 0:
        return (torch.zeros_like(x),
                torch.zeros((0, h, p, n), dtype=torch.float32, device=x.device))
    if grad:
        return Ssd.apply(x, dt, A, Bm, Cm, h0, chunk, True)
    y, h_last = _forward_f32(_f32(x), _f32(dt), A, _f32(Bm), _f32(Cm), h0,
                             chunk, True)
    return (y if x.dtype == torch.float32 else y.to(x.dtype)), h_last
