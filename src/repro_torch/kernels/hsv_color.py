"""HSV color classification — the paper's DogColorClassifier, for Hopper.

Port of ``repro.kernels.hsv_color``. For a CUDA tensor ``hsv_color_hist``
launches the hand-written kernel in ``csrc/hsv_color.cu`` (each crop split
over a cluster of CTAs that sum integer counts, see the source's note) or
raises; for a CPU tensor it runs the plain version in ``ref.py``.
``launches`` counts kernel launches, so a run can show that it went
through the kernel.
"""
from __future__ import annotations

import functools
import struct
import threading
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.launch import refuse_grad

MAX_RANGES = 31      # the kernel's shared-memory range table
MAX_PIXELS = 1 << 24  # counts convert to float32 exactly below this
MAX_CLUSTER = 8      # CTAs a crop is split over (the portable cluster size)
MAX_THREADS = 128    # threads a CTA
FILL_CTAS = 264      # two CTAs an SM of the H100's 132: enough to fill it
MIN_STRETCH = 512    # pixels a CTA takes at least when a crop is split

launches = 0
_COUNT_LOCK = threading.Lock()

# the C entry point's packed arguments (HsvArgs in the source): crops,
# ranges, hist; batch; H*W, C, the plan (cluster, stretch, threads) and a
# word the entry point fills (whether every crop starts on 16 bytes)
ARGS = struct.Struct("<3Qq6i")


class Plan(NamedTuple):
    """How the kernel splits each crop: ``cluster`` CTAs, CTA r taking
    pixels [r * stretch, (r + 1) * stretch), each with ``threads``
    threads taking groups of 4 pixels."""

    cluster: int
    stretch: int
    threads: int


@functools.lru_cache(maxsize=256)
def plan(batch: int, hw: int) -> Plan:
    """The split of ``batch`` crops of ``hw`` pixels: the smallest power
    of two of CTAs a crop (at most 8) that gives the card ``FILL_CTAS``,
    but no CTA under ``MIN_STRETCH`` pixels; a stretch of whole groups of
    4 pixels; as many threads (a multiple of 32, at most 128) as the
    stretch has groups. The counts are integers, so the split never
    changes the histogram's bits."""
    cluster = 1
    while (cluster < MAX_CLUSTER and batch * cluster < FILL_CTAS
           and hw >= 2 * cluster * MIN_STRETCH):
        cluster *= 2
    per = -(-hw // cluster)
    stretch = (per + 3) // 4 * 4
    threads = min(MAX_THREADS, (stretch // 4 + 31) // 32 * 32)
    return Plan(cluster, stretch, threads)


def pack_args(crops: torch.Tensor, ranges: torch.Tensor, hist: torch.Tensor,
              batch: int, hw: int, c: int) -> bytes:
    """The kernel's arguments in one buffer, with the wrapper's plan."""
    return ARGS.pack(crops.data_ptr(), ranges.data_ptr(), hist.data_ptr(),
                     batch, hw, c, *plan(batch, hw), 0)


_entry = None  # the library's C function, looked up once


def hsv_color_hist(
    crops: torch.Tensor,   # (B, H, W, 3) RGB in [0, 255]
    ranges: torch.Tensor,  # (C, 6) lo/hi HSV
    *,
    block_rows: int = 64,
) -> torch.Tensor:
    """(B, C+1) float32 pixel-fraction histogram per crop.

    ``block_rows`` is accepted so callers match the JAX package; the
    kernel splits crops by pixels, so H need not be a multiple of it."""
    refuse_grad("hsv_color", crops, ranges)
    global _entry, launches
    if crops.dim() != 4 or crops.shape[-1] != 3:
        raise ValueError(f"crops must be (B, H, W, 3), got {tuple(crops.shape)}")
    if ranges.dim() != 2 or ranges.shape[-1] != 6:
        raise ValueError(f"ranges must be (C, 6), got {tuple(ranges.shape)}")
    b, hh, ww, _ = crops.shape
    c = ranges.shape[0]
    if b == 0:
        return torch.zeros((0, c + 1), dtype=torch.float32, device=crops.device)
    if not crops.is_cuda:
        if crops.device.type != "cpu":
            raise ValueError(f"hsv_color_hist runs on cpu or cuda, not "
                             f"{crops.device}")
        return ref.hsv_color_classify(crops, ranges)[0]
    dev = crops.get_device()
    if ranges.get_device() != dev:
        raise ValueError(f"ranges on {ranges.device}, crops on {crops.device}")
    if c > MAX_RANGES:
        raise ValueError(f"at most {MAX_RANGES} color ranges, got {c}")
    if hh * ww >= MAX_PIXELS:
        raise ValueError(f"crop of {hh}x{ww} pixels exceeds {MAX_PIXELS}")
    if crops.dtype != torch.float32 or not crops.is_contiguous():
        crops = crops.to(torch.float32).contiguous()
    if ranges.dtype != torch.float32 or not ranges.is_contiguous():
        ranges = ranges.to(torch.float32).contiguous()
    hist = torch.empty((b, c + 1), dtype=torch.float32, device=crops.device)
    _build.refuse_fake("hsv_color", crops, ranges, hist)
    if _entry is None:
        _entry = _build.load("hsv_color").lib.hsv_color_hist
    err = _entry(pack_args(crops, ranges, hist, b, hh * ww, c),
                 _build.raw_stream(dev))
    if err != 0:
        raise RuntimeError(f"hsv_color kernel launch failed: CUDA error {err}")
    with _COUNT_LOCK:
        launches += 1
    return hist
