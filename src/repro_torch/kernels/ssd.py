"""Mamba-2 SSD chunked scan, for Hopper.

Port of ``repro.kernels.ssd``. For CUDA tensors the wrappers launch the
hand-written kernel in ``csrc/ssd.cu`` (a warp per (b, h) walking the
chunks in order, see the source's note) or raise; for CPU tensors they
run the plain version in ``ref.py``. The kernel reads every operand
through its strides: ``ssd_bshp`` takes the model's (B, S, H, P) views as
they are (a dt broadcast over heads included) and writes (B, S, H, P);
``ssd_bhcp`` takes the JAX package's (B, H, S, P) layout. ``launches``
counts kernel launches, so a run can show that it went through the
kernel.
"""
from __future__ import annotations

import struct
import threading

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.launch import refuse_grad

MAX_CHUNK = 64  # the kernel's lanes own two rows of a chunk each

launches = 0
_COUNT_LOCK = threading.Lock()

# the C entry point's packed arguments (SsdArgs in the source): x, dt, A,
# Bm, Cm, h0 (0 for a zero state), y, h_last; the element strides of x,
# dt, Bm, Cm and y in (b, s, h, last) order; batch, heads, seq, P, G, N,
# chunk and a word the entry point fills (which operands move in 16-byte
# pieces)
ARGS = struct.Struct("<8Q19q8i")


def bhsp_strides(t: torch.Tensor) -> tuple:
    """Element strides of a (B, H, S[, last]) view, in (b, s, h, last)
    order."""
    s = t.stride()
    return (s[0], s[2], s[1]) + tuple(s[3:])


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype == torch.float32 else t.to(torch.float32)


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


_entry = None  # the library's C function, looked up once


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
    sx, sdt, sb, sc, sy = strides
    if _entry is None:
        _entry = _build.load("ssd").lib.ssd_scan
    err = _entry(ARGS.pack(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), 0 if h0 is None else h0.data_ptr(), y.data_ptr(),
        h_last.data_ptr(), *sx, *sdt, *sb, *sc, *sy, b, h, s, p, g, n, chunk,
        0), _build.raw_stream(dev))
    if err != 0:
        raise RuntimeError(f"ssd kernel launch failed: CUDA error {err}")
    with _COUNT_LOCK:
        launches += 1
    return y, h_last


def _not_cuda(x) -> ValueError:
    return ValueError(f"ssd runs on cpu or cuda, not {x.device}")


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
    itself."""
    refuse_grad("ssd", x, dt, A, Bm, Cm, h0)
    if x.dim() != 4 or Bm.dim() != 4:
        raise ValueError(f"x and Bm must be 4-d, got {tuple(x.shape)} and "
                         f"{tuple(Bm.shape)}")
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    _check((dt.shape, A.shape, Cm.shape, None if h0 is None else h0.shape),
           ((b, s, h), (h,), (b, s, g, n), None if h0 is None else (b, h, p, n)),
           h, g, s, chunk)
    if b == 0:
        return (torch.zeros_like(x),
                torch.zeros((0, h, p, n), dtype=torch.float32, device=x.device))
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise _not_cuda(x)
        return ref.ssd(x, dt, A, Bm, Cm, h0, chunk=chunk)
    xf, dtf, Bf, Cf = _f32(x), _f32(dt), _f32(Bm), _f32(Cm)
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=x.device)
    y, h_last = _launch(xf, dtf, A, Bf, Cf, h0, y,
                        tuple(t.stride() for t in (xf, dtf, Bf, Cf, y)),
                        (b, s, h, p, g, n), chunk)
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
    through the (B, H, S, P) strides."""
    refuse_grad("ssd", x, dt, A, Bm, Cm, h0)
    if x.dim() != 4 or Bm.dim() != 4:
        raise ValueError(f"x and Bm must be 4-d, got {tuple(x.shape)} and "
                         f"{tuple(Bm.shape)}")
    b, h, s, p = x.shape
    g, n = Bm.shape[1], Bm.shape[3]
    _check((dt.shape, A.shape, Cm.shape, None if h0 is None else h0.shape),
           ((b, h, s), (h,), (b, g, s, n), None if h0 is None else (b, h, p, n)),
           h, g, s, chunk)
    if b == 0:
        return (torch.zeros_like(x),
                torch.zeros((0, h, p, n), dtype=torch.float32, device=x.device))
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise _not_cuda(x)
        y, h_last = ref.ssd(x.transpose(1, 2), dt.transpose(1, 2), A,
                            Bm.transpose(1, 2), Cm.transpose(1, 2), h0,
                            chunk=chunk)
        return y.transpose(1, 2), h_last
    xf, dtf, Bf, Cf = _f32(x), _f32(dt), _f32(Bm), _f32(Cm)
    y = torch.empty((b, h, s, p), dtype=torch.float32, device=x.device)
    y, h_last = _launch(xf, dtf, A, Bf, Cf, h0, y,
                        tuple(map(bhsp_strides, (xf, dtf, Bf, Cf, y))),
                        (b, s, h, p, g, n), chunk)
    return (y if x.dtype == torch.float32 else y.to(x.dtype)), h_last
