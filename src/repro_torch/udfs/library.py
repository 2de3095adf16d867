"""Kernel-backed predicate builders of the port.

Port of ``repro.udfs.library``. Every builder returns a first-class
``Predicate`` whose UDF

  * launches the hand-written kernel through ``repro_torch.kernels.ops``
    (``launch.kernel_call``), so per-launch timings flow into the
    executor's StatsBoard via ``connect_stats_board``;
  * runs the host-to-device copy, the kernel and the copy back on the
    launching thread's own CUDA stream (``launch.thread_stream``);
  * warms up in ``warm_fn`` — GACU lazy activation (§5.1): the first batch
    routed to a worker pays the kernel's build, not every policy probe;
  * carries a roofline-derived ``cost_model`` prior
    (``repro_torch.udfs.rooflines``) for SimClock runs and cold starts;
  * declares a data-aware ``proxy_cost`` for Laminar data balancing;
  * carries a canonical ``fingerprint`` for the persistent StatsStore.

``device`` defaults to ``"cuda"``: the predicate runs on the card, and
building it without one raises. ``device="cpu"`` runs the plain version.
The text predicates and their five kernels are not ported yet.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from repro_torch.core.statstore import canonical_fingerprint
from repro_torch.core.udf import Predicate, UDF
from repro_torch.kernels import launch, ops, ref
from repro_torch.udfs import rooflines


# --------------------------------------------------------------------------- #
# helpers                                                                     #
# --------------------------------------------------------------------------- #
def block_divisor(n: int, cap: int) -> int:
    """Largest divisor of ``n`` that is <= cap (kernel block constraint)."""
    for b in range(min(cap, n), 0, -1):
        if n % b == 0:
            return b
    return 1


def one_row_probe(fn: Callable, columns: Dict[str, tuple],
                  dtypes: Dict[str, np.dtype]) -> Callable[[], object]:
    """GACU ``warm_fn``: run the kernel once on a single synthesized row.

    Returns the probe output so ``UDF.ensure_ready`` learns the output
    dtype/shape from the warm launch — zero-row batches then need no probe
    launch of their own."""

    def warm():
        return fn(
            {c: np.zeros((1,) + shape, dtypes[c])
             for c, shape in columns.items()}
        )

    return warm


def to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """float32 host array -> tensor on ``device`` (cast on the host first).

    Call inside ``launch.thread_stream(device)`` so the copy runs on the
    launching thread's stream."""
    host = torch.from_numpy(np.ascontiguousarray(array, dtype=np.float32))
    return host.to(device)


def hsv_labels(crops: np.ndarray, ranges: torch.Tensor, device: torch.device,
               block_rows: int) -> np.ndarray:
    """(B, H, W, 3) host crops -> (B,) int64 dominant-color labels, through
    one hooked ``hsv_color`` launch on ``device``."""
    with launch.thread_stream(device):
        _, label = ops.hsv_color_classify(to_device(crops, device), ranges,
                                          block_rows=block_rows)
        return label.cpu().numpy()


# --------------------------------------------------------------------------- #
# builders                                                                    #
# --------------------------------------------------------------------------- #
def color_predicate(
    color: str = "black",
    *,
    size: int = 64,
    device="cuda",
    resource: str = "cuda:0",
    name: str = None,
) -> Predicate:
    """HSV color classifier over ``crop`` (B, size, size, 3) RGB [0,255].

    The paper's DogColorClassifier: kernel-fused RGB->HSV + range bucketing
    + histogram argmax; passes rows whose dominant color == ``color``."""
    target = ref.COLOR_NAMES.index(color)
    block_rows = block_divisor(size, 64)
    dev = launch.require_device(device)
    ranges = torch.as_tensor(ref.COLOR_RANGES, device=dev)

    def fn(d):
        return hsv_labels(d["crop"], ranges, dev, block_rows)

    name = name or f"color_is_{color}"
    udf = UDF(
        name, fn, columns=("crop",), resource=resource,
        warm_fn=one_row_probe(fn, {"crop": (size, size, 3)},
                               {"crop": np.float32}),
        cost_model=rooflines.hsv_color(size, size).cost_model,
        proxy_cost=lambda d: float(np.asarray(d["crop"]).size),
        fingerprint=canonical_fingerprint(
            "hsv_color", color=color, size=size, device=dev.type),
    )
    return Predicate(name, udf, compare=lambda o: o == target)


# --------------------------------------------------------------------------- #
# registry                                                                    #
# --------------------------------------------------------------------------- #
# kernel launch name (what StatsBoard entries report under) -> builder
KERNEL_PREDICATES: Dict[str, Callable[..., Predicate]] = {
    "hsv_color": color_predicate,
}


def register_kernel_predicate(kernel: str,
                              builder: Callable[..., Predicate]) -> None:
    """Register a builder under its kernel's launch name."""
    if kernel in KERNEL_PREDICATES:
        raise ValueError(f"kernel predicate {kernel!r} already registered")
    KERNEL_PREDICATES[kernel] = builder


def build_predicate(kernel: str, **kwargs) -> Predicate:
    """Instantiate the registered builder for ``kernel``."""
    try:
        builder = KERNEL_PREDICATES[kernel]
    except KeyError:
        raise KeyError(
            f"no kernel predicate registered for {kernel!r}; "
            f"known: {sorted(KERNEL_PREDICATES)}"
        ) from None
    return builder(**kwargs)
