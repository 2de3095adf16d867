"""Mamba-2 SSD chunked scan, for Hopper.

Port of ``repro.kernels.ssd``. For a CUDA tensor ``ssd_bhcp`` launches the
hand-written kernel in ``csrc/ssd.cu`` (one block per (b, h) walking the
chunks in order, see the source's note) or raises; for a CPU tensor it
runs the plain version in ``ref.py``. ``launches`` counts kernel launches,
so a run can show that it went through the kernel.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels import _build, ref

MAX_CHUNK = 64  # the kernel keeps a chunk's (L, L) weights in shared memory

launches = 0
_COUNT_LOCK = threading.Lock()


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
    """(y (B, H, S, P) in x's dtype, h_last (B, H, P, N) float32)."""
    global launches
    if x.dim() != 4 or Bm.dim() != 4:
        raise ValueError(f"x and Bm must be 4-d, got {tuple(x.shape)} and "
                         f"{tuple(Bm.shape)}")
    b, h, s, p = x.shape
    g, n = Bm.shape[1], Bm.shape[3]
    shapes = {"dt": (dt, (b, h, s)), "A": (A, (h,)), "Bm": (Bm, (b, g, s, n)),
              "Cm": (Cm, (b, g, s, n)), "h0": (h0, (b, h, p, n))}
    for label, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"{label} must be {want}, got {tuple(t.shape)}")
    if g == 0 or h % g or chunk <= 0 or s % chunk:
        raise ValueError(f"need G | H and chunk | S, got H={h} G={g} S={s} "
                         f"chunk={chunk}")
    if b == 0:
        return (torch.zeros_like(x),
                torch.zeros((0, h, p, n), dtype=torch.float32, device=x.device))
    if x.device.type == "cpu":
        y, h_last = ref.ssd(x.transpose(1, 2), dt.transpose(1, 2), A,
                            Bm.transpose(1, 2), Cm.transpose(1, 2), h0,
                            chunk=chunk)
        return y.transpose(1, 2), h_last
    if x.device.type != "cuda":
        raise ValueError(f"ssd_bhcp runs on cpu or cuda, not {x.device}")
    if chunk > MAX_CHUNK:
        raise ValueError(f"chunk must be at most {MAX_CHUNK}, got {chunk}")
    ins = [t.to(torch.float32).contiguous() for t in (x, dt, A, Bm, Cm, h0)]
    if any(t.device != x.device for t in ins):
        raise ValueError(f"all inputs must lie on {x.device}")
    y = torch.empty((b, h, s, p), dtype=torch.float32, device=x.device)
    h_last = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    lib = _build.load("ssd").lib
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.ssd_bhcp(*(t.data_ptr() for t in ins), y.data_ptr(),
                       h_last.data_ptr(), b, h, s, p, g, n, chunk, stream)
    if err != 0:
        raise RuntimeError(f"ssd kernel launch failed: CUDA error {err}")
    with _COUNT_LOCK:
        launches += 1
    return y.to(x.dtype), h_last
