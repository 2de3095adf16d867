"""Public kernel entry points of the port.

The device of the input decides the path: a CUDA tensor runs the
hand-written kernel, a CPU tensor the plain version in ``ref.py``. There is
no switch that picks by whether a card is present. Every entry point
launches through ``launch.kernel_call``, so timing hooks see each launch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import launch, ref
from repro_torch.kernels.hsv_color import hsv_color_hist


def hsv_color_classify(
    crops: torch.Tensor,                 # (B, H, W, 3) RGB [0,255]
    ranges: torch.Tensor | None = None,  # (C, 6); default: ref.COLOR_RANGES
    *,
    block_rows: int = 64,
):
    """(hist (B, C+1) float32, label (B,) int64 argmax, lowest on ties).

    ``block_rows`` keeps the JAX package's signature; the kernel walks each
    crop whole and needs no row blocking."""
    if ranges is None:
        ranges = torch.as_tensor(ref.COLOR_RANGES, device=crops.device)
    hist = launch.kernel_call(
        hsv_color_hist, name="hsv_color", rows=int(crops.shape[0]),
    )(crops, ranges)
    return hist, torch.argmax(hist, dim=-1)
