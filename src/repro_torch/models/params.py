"""A model family's parameters as an ``nn.Module``.

The JAX package keeps a family's parameters in a nested dict whose
layers' leaves are stacked over the layers (each family's
``param_shapes``). The port keeps the same tree in a ``Params`` module:
each top-level leaf is a parameter, and each top-level dict of stacked
leaves becomes an ``nn.ModuleList`` with one entry a layer, holding that
layer's slice of every leaf: a ``LayerParams`` (an
``nn.ParameterDict``), or an ``nn.ModuleDict`` of them where the stack
nests (the hybrid family's groups of (rg1, rg2, attn) layers). A loop
over the list takes the place of ``lax.scan``, and
``convert.model_params`` is a copy.
"""
from __future__ import annotations

import math
from collections.abc import Mapping
from typing import Dict

import torch
from torch import nn

from repro_torch.models.layers import trunc_normal


def spec(shape, dtype) -> torch.Tensor:
    """A shape and dtype with no storage (the JAX ShapeDtypeStruct)."""
    return torch.empty(shape, dtype=dtype, device="meta")


def param_leaves(tree: Dict, prefix: str = ""):
    """(dotted name, leaf) pairs of a nested dict, in sorted key order (the
    order ``jax.tree.flatten`` walks a dict in)."""
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict):
            yield from param_leaves(value, f"{prefix}{key}.")
        else:
            yield prefix + key, value


def count(shapes: Dict) -> int:
    """The number of parameters in a ``param_shapes`` tree."""
    return sum(math.prod(s.shape) for _, s in param_leaves(shapes))


def _param(s: torch.Tensor, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(s.shape, dtype=s.dtype, device=device),
                        requires_grad=False)


def _depth(tree: Dict) -> int:
    """The number of layers a stacked subtree holds (its leaves' first
    dimension)."""
    return next(iter(param_leaves(tree)))[1].shape[0]


class LayerParams(nn.ParameterDict):
    """One layer's parameters. A name the layer lacks raises KeyError, as
    the reference's dict of leaves does (``nn.ParameterDict`` raises
    AttributeError): a grok-1 layer asked for the dense MLP's ``w_gate``
    fails as the reference's does."""

    def __getitem__(self, key: str):
        if key not in self:
            raise KeyError(key)
        return super().__getitem__(key)


def _layer(tree: Dict, device) -> nn.Module:
    """One layer's slice of a stacked subtree."""
    if any(isinstance(v, dict) for v in tree.values()):
        return nn.ModuleDict({k: _layer(v, device) for k, v in tree.items()})
    return LayerParams({k: _param(v[0], device) for k, v in tree.items()})


class Params(nn.Module):
    """The parameters of the tree ``shapes``, made empty on ``device``;
    ``init`` or ``convert.model_params`` fills them."""

    def __init__(self, cfg, shapes: Dict, *, device="cuda"):
        super().__init__()
        self.cfg = cfg
        for name, value in shapes.items():
            if isinstance(value, dict):
                setattr(self, name, nn.ModuleList(
                    _layer(value, device) for _ in range(_depth(value))))
            else:
                setattr(self, name, _param(value, device))


def set_param(model: Params, name: str, value: torch.Tensor) -> None:
    """Copy ``value``, in the JAX layout, into the parameter ``name`` (a
    dotted name of ``param_shapes``; a stacked leaf's value is stacked over
    the layers, and layer i takes slice i)."""
    first, *rest = name.split(".")
    target = getattr(model, first)
    if not rest:
        target.copy_(value)
        return
    for layer, v in zip(target, value, strict=True):
        for key in rest[:-1]:
            layer = layer[key]
        layer[rest[-1]].copy_(v)


def get_param(model: Params, name: str):
    """The parameter ``name`` (a dotted name of ``param_shapes``): the
    tensor itself for a top-level leaf, else the list of each layer's
    slice, in layer order."""
    first, *rest = name.split(".")
    target = getattr(model, first)
    if not rest:
        return target
    out = []
    for layer in target:
        for key in rest[:-1]:
            layer = layer[key]
        out.append(layer[rest[-1]])
    return out


def layer_logical(logical: str) -> str:
    """A stacked leaf's logical dims without the leading "layers" (which
    the rules map to no mesh axis): those of each layer's slice."""
    dims = logical.split()
    assert dims[0] == "layers", logical
    return " ".join(dims[1:])


def distribute_params(model: Params, shapes: Dict, logical: Dict, rules,
                      mesh) -> Params:
    """Replace every parameter of ``model`` by a ``DTensor`` placed by its
    leaf of ``logical`` (the family's ``param_logical``), in place; a
    layer's slice of a stacked leaf by the leaf's dims after "layers".
    Every rank holds the same values (a seeded draw), and each keeps its
    block: no collective, and a replicated parameter keeps its storage.
    A parameter already a ``DTensor`` is left as it is."""
    from repro_torch.distributed.sharding import distribute, is_dtensor

    flat = dict(param_leaves(logical))
    for name, _ in param_leaves(shapes):
        first, *rest = name.split(".")
        if not rest:
            owners = [(model, first)]
            lg = flat[name]
        else:
            owners = []
            for layer in getattr(model, first):
                for key in rest[:-1]:
                    layer = layer[key]
                owners.append((layer, rest[-1]))
            lg = layer_logical(flat[name])
        for owner, key in owners:
            p = owner[key] if isinstance(owner, nn.ParameterDict) else \
                getattr(owner, key)
            if is_dtensor(p):
                continue
            d = nn.Parameter(distribute(p.data, lg, rules, mesh),
                             requires_grad=False)
            if isinstance(owner, nn.ParameterDict):
                owner[key] = d
            else:
                setattr(owner, key, d)
    return model


def stack_layers(tensors: list, s: torch.Tensor, device) -> torch.Tensor:
    """Each layer's tensor stacked over the layers; for a stack of no
    layers (the hybrid's remainder at a multiple of 3 layers), an empty
    tensor of ``s``'s shape (0, ...) and dtype on ``device``."""
    if not tensors:
        return torch.empty(s.shape, dtype=s.dtype, device=device)
    return torch.stack(tensors)


def stacked(model: Params, shapes: Dict) -> Dict[str, torch.Tensor]:
    """Every leaf of ``shapes`` in the JAX layout, keyed by its dotted
    name in ``param_leaves`` order: a layer stack as one tensor stacked
    over the layers (a copy), a top-level leaf as it is (detached)."""
    out = {}
    device = next(model.parameters()).device
    for name, s in param_leaves(shapes):
        value = get_param(model, name)
        out[name] = (value.detach() if isinstance(value, torch.Tensor)
                     else stack_layers([t.detach() for t in value], s,
                                       device))
    return out


class StackedView(Mapping):
    """``stacked(model, shapes)`` a leaf at a time: each lookup stacks
    that leaf anew and keeps nothing, so a train step holds one leaf's
    stacked copy at a time (one layer of grok-1 is 13 GB of bf16
    weights)."""

    def __init__(self, model: Params, shapes: Dict):
        self.model = model
        self.specs = dict(param_leaves(shapes))
        self.device = next(model.parameters()).device

    def __getitem__(self, name: str) -> torch.Tensor:
        value = get_param(self.model, name)
        if isinstance(value, torch.Tensor):
            return value.detach()
        return stack_layers([t.detach() for t in value], self.specs[name],
                            self.device)

    def __iter__(self):
        return iter(self.specs)

    def __len__(self) -> int:
        return len(self.specs)


def init(model: Params, shapes: Dict, generator: torch.Generator, *,
         fill: float, device) -> Params:
    """Fill ``model`` as the JAX package draws its parameters: every leaf
    of two or more dimensions in the stacked layout (the layers' norms
    included) from a normal truncated at ±2 with std 0.02, the rest
    ``fill``. ``generator`` (seeded by the caller) lives on ``device``; the
    numbers are torch's, not ``jax.random``'s."""
    with torch.no_grad():
        for name, s in param_leaves(shapes):
            if len(s.shape) >= 2:
                value = trunc_normal(generator, s.shape, 0.02, s.dtype, device)
            else:
                value = torch.full(s.shape, fill, dtype=s.dtype, device=device)
            set_param(model, name, value)
    return model
