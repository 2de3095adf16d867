"""Blocked causal / sliding-window flash attention with GQA, for Hopper.

Port of ``repro.kernels.flash_attention``. For a CUDA tensor
``flash_attention_bhsd`` launches the hand-written kernel in
``csrc/flash_attention.cu`` (a CTA per 32 query rows, online softmax over
tiles of 32 keys, see the source's note) or raises; for a CPU tensor it
runs the plain version in ``ref.py``. ``launches`` counts kernel launches,
so a run can show that it went through the kernel.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels import _build, ref

MAX_HEAD_DIM = 256  # the kernel keeps a row's dims on one warp, 8 a lane
DTYPES = (torch.float32, torch.bfloat16)

launches = 0
_COUNT_LOCK = threading.Lock()


def flash_attention_bhsd(
    q: torch.Tensor,   # (BH, Sq, D)
    k: torch.Tensor,   # (BH / group, Sk, D)
    v: torch.Tensor,   # (BH / group, Sk, D)
    *,
    group: int,        # H // Hkv
    causal: bool = True,
    window: int = 0,
    scale: float | None = None,
) -> torch.Tensor:
    """(BH, Sq, D) in q's dtype (float32 or bfloat16; math in float32).

    Program b attends kv head b // group; a key at position j is visible
    to the query at position i when (not causal or j <= i) and (window <=
    0 or j > i - window). A query with no visible key gets 0. ``scale``
    defaults to D ** -0.5."""
    global launches
    if q.dim() != 3 or k.dim() != 3:
        raise ValueError(f"q and k must be 3-d, got {tuple(q.shape)} and "
                         f"{tuple(k.shape)}")
    bh, sq, d = q.shape
    if group < 1 or k.shape[0] * group != bh or k.shape[2] != d \
            or v.shape != k.shape:
        raise ValueError(f"need k, v (BH / group, Sk, D) = ({bh} / {group}, "
                         f"Sk, {d}), got {tuple(k.shape)} and {tuple(v.shape)}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k and v must share a dtype in {DTYPES}, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    scale = d ** -0.5 if scale is None else scale
    if bh == 0 or sq == 0 or d == 0:
        return torch.zeros_like(q)
    if q.device.type == "cpu":
        return ref.flash_attention_bhsd(q, k, v, group=group, causal=causal,
                                        window=window, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bhsd runs on cpu or cuda, not "
                         f"{q.device}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head_dim must be at most {MAX_HEAD_DIM}, got {d}")
    ins = [t.contiguous() for t in (q, k, v)]
    if any(t.device != q.device for t in ins):
        raise ValueError(f"all inputs must lie on {q.device}")
    out = torch.empty_like(ins[0])
    lib = _build.load("flash_attention").lib
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_bhsd(
        *(t.data_ptr() for t in ins), out.data_ptr(), bh, sq, k.shape[1], d,
        group, int(causal), int(window), float(scale),
        int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    with _COUNT_LOCK:
        launches += 1
    return out
