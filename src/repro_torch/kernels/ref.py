"""Plain PyTorch versions of the port's kernels.

These are what the CPU tests compare against the JAX package and what
``chip_smoke.py`` holds each kernel against on the card. A kernel wrapper
takes its plain version only for tensors that lie on the CPU; nothing on
the main path runs them when a card is present.
"""
from __future__ import annotations

import numpy as np
import torch

# --------------------------------------------------------------------------- #
# HSV color classification (the paper's DogColorClassifier)                    #
# --------------------------------------------------------------------------- #
# ranges follow the paper's example: red = (0,50,70)..(9,255,255), etc.
COLOR_NAMES = (
    "red", "black", "gray", "yellow", "green", "blue", "purple", "pink",
    "white", "other",
)
# (lo_h, lo_s, lo_v, hi_h, hi_s, hi_v) with H in [0,180), S,V in [0,256)
COLOR_RANGES = np.array(
    [
        [0, 50, 70, 9, 255, 255],      # red
        [0, 0, 0, 180, 255, 45],       # black
        [0, 0, 46, 180, 50, 200],      # gray
        [20, 50, 70, 33, 255, 255],    # yellow
        [34, 50, 70, 85, 255, 255],    # green
        [86, 50, 70, 128, 255, 255],   # blue
        [129, 50, 70, 158, 255, 255],  # purple
        [159, 50, 70, 177, 255, 255],  # pink
        [0, 0, 201, 180, 49, 255],     # white
    ],
    dtype=np.float32,
)


def _remainder(x: torch.Tensor, m: float) -> torch.Tensor:
    """Float ``%`` as the JAX package computes it (``jnp.remainder``):
    C's ``fmod``, then ``+ m`` where the result is nonzero and of the other
    sign. ``torch.remainder`` computes ``x - m*floor(x/m)`` instead, which
    can differ in the last bit."""
    r = torch.fmod(x, m)
    return torch.where((r != 0) & (r < 0), r + m, r)


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """RGB in [0,255] -> HSV with H in [0,180), S,V in [0,255] (OpenCV scale).

    The float32 operations run in the JAX package's order, so results are
    bit-equal to ``repro.kernels.ref.rgb_to_hsv``."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    diff = mx - mn
    one = torch.ones((), dtype=rgb.dtype, device=rgb.device)
    safe = torch.where(diff == 0, one, diff)
    h = torch.where(
        mx == r,
        _remainder((g - b) / safe, 6.0),
        torch.where(mx == g, (b - r) / safe + 2.0, (r - g) / safe + 4.0),
    )
    h = torch.where(diff == 0, torch.zeros_like(h), h) * 30.0  # OpenCV H/2
    s = torch.where(mx == 0, torch.zeros_like(mx),
                    diff / torch.where(mx == 0, one, mx)) * 255.0
    return torch.stack([h, s, mx], dim=-1)


def hsv_color_buckets(crops: torch.Tensor,
                      ranges: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) RGB -> (B, H, W) int64 bucket per pixel: the index of
    the first range that holds it, or C ('other') when none does."""
    hsv = rgb_to_hsv(crops.to(torch.float32))
    c = ranges.shape[0]
    bucket = torch.full(hsv.shape[:-1], c, dtype=torch.int64,
                        device=crops.device)
    # walk the ranges last to first so the first match is written last
    for j in range(c - 1, -1, -1):
        lo, hi = ranges[j, 0:3], ranges[j, 3:6]
        inside = ((hsv >= lo) & (hsv <= hi)).all(dim=-1)
        bucket = torch.where(inside, torch.full_like(bucket, j), bucket)
    return bucket


def hsv_color_classify(crops: torch.Tensor, ranges: torch.Tensor | None = None):
    """(B, H, W, 3) RGB [0,255] -> (B, n_colors+1) pixel-fraction histogram.

    Class = argmax fraction (last bucket = 'other'; ties go to the lowest
    index). Returns (hist, label). The histogram is an exact integer count
    scaled once by ``inv_pixels(H*W)``, as the JAX package's ``mean``
    computes it."""
    if ranges is None:
        ranges = torch.as_tensor(COLOR_RANGES, device=crops.device)
    ranges = ranges.to(device=crops.device, dtype=torch.float32)
    b, h, w, _ = crops.shape
    nb = ranges.shape[0] + 1
    bucket = hsv_color_buckets(crops, ranges)
    offsets = torch.arange(b, device=crops.device).view(b, 1, 1) * nb
    counts = torch.bincount((bucket + offsets).reshape(-1),
                            minlength=b * nb).view(b, nb)
    hist = counts.to(torch.float32) * inv_pixels(h * w)
    return hist, torch.argmax(hist, dim=-1)


def inv_pixels(n: int) -> float:
    """The float32 reciprocal of ``n``. The JAX package's ``mean`` scales
    the exact count by it (XLA turns the division by a constant into this
    product), which can differ from the true quotient by one ulp; the
    kernel and this plain version scale the same way."""
    return float(np.float32(1.0) / np.float32(n))
