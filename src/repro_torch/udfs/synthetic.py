"""Synthetic predicates for deterministic benchmarks and examples.

Port of ``repro.udfs.synthetic``. Two families:

* ``planted_predicate`` — a pure membership filter with an ANALYTIC cost
  model (rows * cost_per_row). This is the SimClock workhorse: the UC1/UC3
  benchmarks plant ground-truth pass sets and paper-calibrated per-row
  costs, then compare routing policies on simulated makespan.

* ``planted_detector`` / ``planted_classifier`` — REAL compute (the HSV
  color kernel over the pixel column, so wall-clock cost is genuine) with
  planted labels, standing in for detector/classifier checkpoints we don't
  ship. The detector reads boolean labels indexed by ``rid``; the
  classifier reads integer labels from a batch column and passes
  ``label == target``.
"""
from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from repro_torch.core.statstore import canonical_fingerprint
from repro_torch.core.udf import Predicate, UDF
from repro_torch.kernels import launch, ref
from repro_torch.kernels.hsv_color import hsv_color_hist
from repro_torch.udfs.library import (
    block_divisor, hsv_labels, one_row_probe, to_device,
)
from repro_torch.udfs import rooflines


def planted_predicate(
    name: str,
    passing_ids: Iterable[int],
    *,
    cost_per_row: float,
    resource: str = "cuda:0",
    column: str = "rid",
) -> Predicate:
    """Membership filter over ``column`` with an analytic SimClock cost."""
    ids = np.asarray(sorted(int(i) for i in passing_ids))

    udf = UDF(
        name,
        fn=lambda d: np.isin(d[column], ids),
        columns=(column,),
        resource=resource,
        cost_model=lambda rows: rows * cost_per_row,
        bucket=False,
        # planted sets are benchmark-local, so the fingerprint keys on the
        # planted NAME + cost config: re-building the same scenario in a
        # fresh process maps to the same persistent-statistics record
        fingerprint=canonical_fingerprint(
            f"planted:{name}", cost_per_row=cost_per_row, column=column),
    )
    return Predicate(name, udf, compare=lambda o: o.astype(bool))


def planted_detector(
    name: str,
    planted_mask: np.ndarray,
    *,
    work_dim: int = 96,
    device="cuda",
    resource: str = "cuda:0",
) -> Predicate:
    """Detector stand-in: real HSV-kernel compute + planted boolean labels.

    The ``frame`` column supplies the pixels (any layout reshapeable to
    (rows, work_dim, work_dim, 3)); ``rid`` indexes the planted labels.
    Every evaluation is one hooked kernel launch, so an executor's launch
    hook sees genuine per-launch cost."""
    planted = np.asarray(planted_mask).astype(bool)
    block_rows = block_divisor(work_dim, 64)
    dev = launch.require_device(device)
    ranges = torch.as_tensor(ref.COLOR_RANGES, device=dev)

    def fn(d):
        hsv_labels(
            np.asarray(d["frame"], np.float32).reshape(
                -1, work_dim, work_dim, 3),
            ranges, dev, block_rows,
        )
        return planted[d["rid"]]

    udf = UDF(
        name, fn, columns=("frame", "rid"), resource=resource, bucket=False,
        warm_fn=one_row_probe(
            fn, {"frame": (work_dim, work_dim, 3), "rid": ()},
            {"frame": np.float32, "rid": np.int64},
        ),
        cost_model=rooflines.hsv_color(work_dim, work_dim).cost_model,
        proxy_cost=lambda d: float(np.asarray(d["frame"]).size),
    )
    return Predicate(name, udf, compare=lambda o: o.astype(bool))


def planted_classifier(
    name: str,
    target: int,
    *,
    label_column: str,
    pixel_column: str = "crop",
    device="cuda",
    resource: str = "cuda:0",
) -> Predicate:
    """Classifier stand-in: real HSV compute over (B, H, W, 3) pixels +
    planted integer labels read from ``label_column``; passes label ==
    ``target``. The kernel is launched WITHOUT the timing hooks: this is a
    ViT stand-in that burns real compute, not the color kernel itself, so
    the board's ``hsv_color`` entry counts the color predicate's launches
    only (as the JAX package's ``impl="xla"`` classifier reports none)."""
    dev = launch.require_device(device)
    ranges = torch.as_tensor(ref.COLOR_RANGES, device=dev)

    def fn(d):
        px = np.asarray(d[pixel_column], np.float32)
        with launch.thread_stream(dev):
            hsv_color_hist(to_device(px, dev), ranges,
                           block_rows=block_divisor(px.shape[1], 64))
            if dev.type == "cuda":  # the compute is the point: wait for it
                torch.cuda.current_stream(dev).synchronize()
        return np.asarray(d[label_column])

    udf = UDF(
        name, fn, columns=(pixel_column, label_column), resource=resource,
        proxy_cost=lambda d: float(np.asarray(d[pixel_column]).size),
    )
    return Predicate(name, udf, compare=lambda o: o == target)
