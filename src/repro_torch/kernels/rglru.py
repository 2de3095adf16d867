"""RG-LRU linear recurrence (recurrentgemma / Griffin), for Hopper.

Port of ``repro.kernels.rglru``. For a CUDA tensor ``rglru_bsw`` launches
the hand-written kernel in ``csrc/rglru.cu`` (one thread per channel
walking S in order, see the source's note) or raises; for a CPU tensor it
runs the plain version in ``ref.py``. ``launches`` counts kernel launches,
so a run can show that it went through the kernel.
"""
from __future__ import annotations

import struct
import threading

import torch

from repro_torch.kernels import _build, ref

launches = 0
_COUNT_LOCK = threading.Lock()

# the C entry point's packed arguments (RglruArgs in the source): x, r, i,
# a_param, h0, out, h_last; B, S, W and c
ARGS = struct.Struct("<7Q3if")
_entry = None  # the library's C function, looked up once


def rglru_bsw(
    x: torch.Tensor,        # (B, S, W)
    r: torch.Tensor,        # (B, S, W)
    i: torch.Tensor,        # (B, S, W)
    a_param: torch.Tensor,  # (W,)
    h0: torch.Tensor,       # (B, W)
    *,
    c: float = 8.0,
):
    """(out (B, S, W), h_last (B, W)), both in x's dtype. Each channel's
    whole sequence is one thread's, so S and W are free."""
    global _entry, launches
    if x.dim() != 3:
        raise ValueError(f"x must be (B, S, W), got {tuple(x.shape)}")
    b, s, w = x.shape
    if r.shape != x.shape or i.shape != x.shape:
        raise ValueError(f"r and i must match x {tuple(x.shape)}, got "
                         f"{tuple(r.shape)} and {tuple(i.shape)}")
    if tuple(a_param.shape) != (w,) or tuple(h0.shape) != (b, w):
        raise ValueError(f"a_param must be ({w},) and h0 ({b}, {w}), got "
                         f"{tuple(a_param.shape)} and {tuple(h0.shape)}")
    if b == 0 or w == 0:
        return torch.zeros_like(x), torch.zeros_like(h0, dtype=x.dtype)
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"rglru_bsw runs on cpu or cuda, not {x.device}")
        return ref.rglru(x, r, i, a_param, h0, c=c)
    dev = x.get_device()
    ins = [t if t.dtype == torch.float32 and t.is_contiguous()
           else t.to(torch.float32).contiguous() for t in (x, r, i, a_param, h0)]
    if any(t.get_device() != dev for t in ins):
        raise ValueError(f"all inputs must lie on {x.device}")
    out = torch.empty((b, s, w), dtype=torch.float32, device=x.device)
    h_last = torch.empty((b, w), dtype=torch.float32, device=x.device)
    if _entry is None:
        _entry = _build.load("rglru").lib.rglru_bsw
    err = _entry(ARGS.pack(*(t.data_ptr() for t in ins), out.data_ptr(),
                           h_last.data_ptr(), b, s, w, float(c)),
                 _build.raw_stream(dev))
    if err != 0:
        raise RuntimeError(f"rglru kernel launch failed: CUDA error {err}")
    with _COUNT_LOCK:
        launches += 1
    if x.dtype != torch.float32:
        out, h_last = out.to(x.dtype), h_last.to(x.dtype)
    return out, h_last
