"""Turn state written by the JAX package into the port's.

The port cannot import the JAX package, so state crosses as numpy arrays
and files: a caller hands in ``np.asarray`` of a JAX array, or the path of
a file the JAX package flushed. This module carries the HSV range table,
the text predicates' embedding tables, the ``ReuseCache`` snapshot, the
models' parameters (``model_params``: every family) and the optimizers'
state (``optimizer_state``). Like every
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


def _tensor(array, dev) -> torch.Tensor:
    """A numpy leaf (bfloat16 included, through float32, which holds it
    exactly) as a tensor of the same dtype on ``dev``."""
    arr = np.asarray(array)
    if str(arr.dtype) == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            dev, torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(dev)


def optimizer_state(state, cfg, device="cuda"):
    """The JAX package's optimizer state for ``cfg``'s parameters -> the
    port's (``optim``): ``AdamW``'s {"m", "v", "count"}, ``Adafactor``'s
    {"f", "count"} or ``Int8ErrorFeedback``'s {"err", "inner"} around
    either, each leaf a numpy array (``jax.tree.map(np.asarray, state)``).
    A parameter-shaped tree becomes a dict keyed by the dotted names of
    ``param_shapes`` in ``param_leaves`` order, its leaves stacked over the
    layers as in the JAX package; Adafactor's per-parameter {"row", "col"}
    or {"v"} dicts stay dicts. Dtypes are kept (bfloat16 moments
    included). Raises ValueError on a state of another shape."""
    from repro_torch.models.params import param_leaves
    from repro_torch.models.registry import family_module

    dev = require_device(device)
    want = dict(param_leaves(family_module(cfg.family).param_shapes(cfg)))

    def params_tree(tree, factored=False):
        got = dict(param_leaves(tree))
        out = {}
        for name, s in want.items():
            if factored:
                parts = {k: got.pop(f"{name}.{k}") for k in ("row", "col", "v")
                         if f"{name}.{k}" in got}
                if not parts:
                    raise ValueError(f"optimizer state: no factors of {name}")
                out[name] = {k: _tensor(a, dev) for k, a in parts.items()}
                continue
            if name not in got:
                raise ValueError(f"optimizer state: no leaf {name}")
            a = got.pop(name)
            if tuple(np.shape(a)) != tuple(s.shape):
                raise ValueError(f"optimizer state {name}: shape "
                                 f"{np.shape(a)}, {cfg.name} needs "
                                 f"{tuple(s.shape)}")
            out[name] = _tensor(a, dev)
        if got:
            raise ValueError(f"optimizer state: extra leaves {sorted(got)}")
        return out

    def convert(st):
        if set(st) == {"err", "inner"}:
            return {"err": params_tree(st["err"]), "inner": convert(st["inner"])}
        if set(st) == {"m", "v", "count"}:
            return {"m": params_tree(st["m"]), "v": params_tree(st["v"]),
                    "count": _tensor(st["count"], dev)}
        if set(st) == {"f", "count"}:
            return {"f": params_tree(st["f"], factored=True),
                    "count": _tensor(st["count"], dev)}
        raise ValueError(f"unknown optimizer state with keys {sorted(st)}")

    return convert(state)
