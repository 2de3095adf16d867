"""Turn state written by the JAX package into the port's.

The port cannot import the JAX package, so state crosses as numpy arrays
and files: a caller hands in ``np.asarray`` of a JAX array, or the path of
a file the JAX package flushed. This module carries the HSV range table,
the text predicates' embedding tables, the ``ReuseCache`` snapshot and
the models' parameters (``model_params``: every family). Like every
entry point of the port, the converters put their tensors on the card
unless the caller asks for the CPU, and raise at once without a card.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch.core.cache import ReuseCache
from repro_torch.kernels.launch import require_device


def hsv_ranges(ranges, device="cuda") -> torch.Tensor:
    """A (C, 6) HSV range table (lo_h, lo_s, lo_v, hi_h, hi_s, hi_v) -> a
    float32 tensor on ``device``, as ``ops.hsv_color_classify`` takes it."""
    arr = np.array(ranges, dtype=np.float32)  # a copy the tensor may own
    if arr.ndim != 2 or arr.shape[1] != 6:
        raise ValueError(f"HSV ranges must be (C, 6), got {arr.shape}")
    return torch.from_numpy(arr).to(require_device(device))


def embedding_table(array, device="cuda") -> torch.Tensor:
    """A (vocab, dim) embedding table -> a float32 tensor on ``device``.

    The text predicates look token ids up in such tables, with id 0 as
    padding; a table whose row 0 is not zero would let padding move a
    score, so it raises."""
    arr = np.array(array, dtype=np.float32)  # a copy the tensor may own
    if arr.ndim != 2:
        raise ValueError(f"an embedding table must be (vocab, dim), got "
                         f"{arr.shape}")
    if arr.shape[0] == 0 or np.any(arr[0] != 0):
        raise ValueError("row 0 of an embedding table (padding) must be zero")
    return torch.from_numpy(arr).to(require_device(device))


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


def model_params(params, cfg, device="cuda"):
    """The JAX package's parameter pytree of ``cfg``'s family -> the port's
    parameter module (the family's ``Model``: ``Transformer``, ``MoE``,
    ``SSM``, ``Hybrid`` or ``EncDec``) holding the same values in
    ``cfg.dtype`` on ``device``.

    ``params`` is the nested dict of the family's ``init_params``, each
    leaf a numpy array (``jax.tree.map(np.asarray, params)`` on the
    caller's side); a stacked leaf's layer i goes to the port's layer i
    (the hybrid family's ``groups`` and ``rest`` stacks, the
    encoder-decoder's ``enc_layers`` and ``dec_layers``). Raises
    ValueError on a missing or extra leaf and on a shape that differs, and
    KeyError for an unknown family."""
    from repro_torch.models.params import param_leaves, set_param
    from repro_torch.models.registry import family_module

    api = family_module(cfg.family)
    dev = require_device(device)
    want = dict(param_leaves(api.param_shapes(cfg)))
    got = dict(param_leaves(params))
    missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    if missing or extra:
        raise ValueError(f"parameter leaves differ from {cfg.name}'s: "
                         f"missing {missing}, extra {extra}")
    for name, s in want.items():
        shape = np.shape(got[name])
        if shape != tuple(s.shape):
            raise ValueError(f"parameter {name}: shape {shape}, "
                             f"{cfg.name} needs {tuple(s.shape)}")
    model = api.Model(cfg, device=dev)
    with torch.no_grad():
        for name in want:
            # through float32, which holds every bfloat16 value exactly
            value = torch.from_numpy(np.array(got[name], dtype=np.float32))
            set_param(model, name, value.to(dev))
    return model


def transformer_params(params, cfg, device="cuda"):
    """``model_params`` for the dense (and vlm) decoder: the JAX package's
    parameter pytree -> the port's ``Transformer``. Raises ValueError for
    a config of another ported family."""
    if cfg.family in ("moe", "ssm", "hybrid", "encdec"):
        raise ValueError(f"transformer_params takes a dense or vlm config, "
                         f"not the {cfg.family} family's: use model_params")
    return model_params(params, cfg, device)
