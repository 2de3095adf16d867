"""HSV color classification — the paper's DogColorClassifier, for Hopper.

Port of ``repro.kernels.hsv_color``. For a CUDA tensor ``hsv_color_hist``
launches the hand-written kernel in ``csrc/hsv_color.cu`` (one block per
crop, integer counts, see the source's note) or raises; for a CPU tensor it
runs the plain version in ``ref.py``. ``launches`` counts kernel launches,
so a run can show that it went through the kernel.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels import _build, ref

MAX_RANGES = 31      # the kernel's shared-memory range table
MAX_PIXELS = 1 << 24  # counts convert to float32 exactly below this

launches = 0
_COUNT_LOCK = threading.Lock()


def hsv_color_hist(
    crops: torch.Tensor,   # (B, H, W, 3) RGB in [0, 255]
    ranges: torch.Tensor,  # (C, 6) lo/hi HSV
    *,
    block_rows: int = 64,
) -> torch.Tensor:
    """(B, C+1) float32 pixel-fraction histogram per crop.

    ``block_rows`` is accepted so callers match the JAX package; the
    kernel walks each crop whole, so H need not be a multiple of it."""
    global launches
    if crops.dim() != 4 or crops.shape[-1] != 3:
        raise ValueError(f"crops must be (B, H, W, 3), got {tuple(crops.shape)}")
    if ranges.dim() != 2 or ranges.shape[-1] != 6:
        raise ValueError(f"ranges must be (C, 6), got {tuple(ranges.shape)}")
    b, hh, ww, _ = crops.shape
    c = ranges.shape[0]
    if b == 0:
        return torch.zeros((0, c + 1), dtype=torch.float32, device=crops.device)
    if crops.device.type == "cpu":
        return ref.hsv_color_classify(crops, ranges)[0]
    if crops.device.type != "cuda":
        raise ValueError(f"hsv_color_hist runs on cpu or cuda, not {crops.device}")
    if ranges.device != crops.device:
        raise ValueError(f"ranges on {ranges.device}, crops on {crops.device}")
    if c > MAX_RANGES:
        raise ValueError(f"at most {MAX_RANGES} color ranges, got {c}")
    if hh * ww >= MAX_PIXELS:
        raise ValueError(f"crop of {hh}x{ww} pixels exceeds {MAX_PIXELS}")
    crops = crops.to(torch.float32).contiguous()
    ranges = ranges.to(torch.float32).contiguous()
    hist = torch.empty((b, c + 1), dtype=torch.float32, device=crops.device)
    lib = _build.load("hsv_color").lib
    stream = torch.cuda.current_stream(crops.device).cuda_stream
    err = lib.hsv_color_hist(crops.data_ptr(), ranges.data_ptr(),
                             hist.data_ptr(), b, hh * ww, c, stream)
    if err != 0:
        raise RuntimeError(f"hsv_color kernel launch failed: CUDA error {err}")
    with _COUNT_LOCK:
        launches += 1
    return hist
