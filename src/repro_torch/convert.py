"""Turn state written by the JAX package into the port's.

The port cannot import the JAX package, so state crosses as numpy arrays
and files: a caller hands in ``np.asarray`` of a JAX array, or the path of
a file the JAX package flushed. This slice carries the HSV range table and
the ``ReuseCache`` snapshot; later slices add embedding tables and model
parameters.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch.core.cache import ReuseCache


def hsv_ranges(ranges, device="cpu") -> torch.Tensor:
    """A (C, 6) HSV range table (lo_h, lo_s, lo_v, hi_h, hi_s, hi_v) -> a
    float32 tensor on ``device``, as ``ops.hsv_color_classify`` takes it."""
    arr = np.array(ranges, dtype=np.float32)  # a copy the tensor may own
    if arr.ndim != 2 or arr.shape[1] != 6:
        raise ValueError(f"HSV ranges must be (C, 6), got {arr.shape}")
    return torch.from_numpy(arr).to(device)


def reuse_cache(path: str) -> ReuseCache:
    """Open a ``ReuseCache`` snapshot flushed by the JAX package.

    Both packages write the same ``.npz`` layout (per UDF and value group,
    ``<udf>__g<N>__ids`` int64 row ids beside ``<udf>__g<N>__vals``). The
    cache itself warns and starts cold on a damaged file; carrying state
    across must not lose it quietly, so this checks the layout first and
    raises on anything it would drop."""
    if not path.endswith(".npz"):
        path += ".npz"
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    with np.load(path, allow_pickle=False) as data:
        for key in data.files:
            if key.endswith("__ids"):
                base = key[: -len("__ids")]
                vals_key = base + "__vals"
                if vals_key not in data.files:
                    raise ValueError(f"{path}: {key} has no {vals_key}")
                ids, vals = data[key], data[vals_key]
                if ids.dtype != np.int64 or ids.ndim != 1:
                    raise ValueError(f"{path}: {key} is not a 1-d int64 array")
                if len(vals) != len(ids):
                    raise ValueError(f"{path}: {key} and {vals_key} differ "
                                     "in length")
            elif not key.endswith("__vals"):
                raise ValueError(f"{path}: unexpected entry {key!r}")
    return ReuseCache(path)
