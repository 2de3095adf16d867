"""Submesh carving: Laminar's device allocation at mesh scale.

Port of ``repro.distributed.meshes``. The paper's Laminar router assigns
UDF workers to GPUs proportionally to measured cost. At mesh scale the
resource quantum is a mesh SLICE: this module splits a mesh's data axis
into per-predicate submeshes sized by the predicates' measured costs, so
concurrent UDF predicates each get a data-parallel slice while sharing
the model-parallel layout.

A submesh is a ``DeviceMesh`` over the slice of ``mesh.mesh``, the
parent's rank tensor. Building one creates its process groups, which is
collective: every rank of the world builds every submesh, in the same
order, including those it is not part of (``split_mesh_data_axis`` does).
"""
from __future__ import annotations

from typing import Dict

import torch


def data_rows(ndata: int, shares: Dict[str, float]) -> Dict[str, int]:
    """Data rows a predicate, ~ proportional to its share: every predicate
    gets >= 1 row; remainders go to the largest shares."""
    names = list(shares)
    total = sum(max(s, 1e-9) for s in shares.values())
    raw = {n: max(1, int(round(shares[n] / total * ndata))) for n in names}
    # fix rounding to sum exactly to ndata
    while sum(raw.values()) > ndata:
        big = max(raw, key=raw.get)
        if raw[big] <= 1:
            break
        raw[big] -= 1
    while sum(raw.values()) < ndata:
        big = max(names, key=lambda n: shares[n] / raw[n])
        raw[big] += 1
    return raw


def data_slices(ranks: torch.Tensor, axis: int,
                shares: Dict[str, float]) -> Dict[str, torch.Tensor]:
    """The contiguous slices of the rank tensor ``ranks`` along ``axis``
    (the data axis), one a predicate, as ``data_rows`` sizes them."""
    out, start = {}, 0
    for n, take in data_rows(ranks.shape[axis], shares).items():
        out[n] = ranks.narrow(axis, start, take)
        start += take
    return out


def split_mesh_data_axis(mesh, shares: Dict[str, float]) -> Dict[str, object]:
    """Split the 'data' axis into contiguous slices ~ proportional to
    shares: one ``DeviceMesh`` a predicate, with the parent's axis names.
    Collective: every rank calls it with the same shares."""
    from torch.distributed.device_mesh import DeviceMesh

    axis = list(mesh.mesh_dim_names).index("data")
    return {n: DeviceMesh(mesh.device_type, sub,
                          mesh_dim_names=tuple(mesh.mesh_dim_names))
            for n, sub in data_slices(mesh.mesh, axis, shares).items()}


def cost_shares(costs: Dict[str, float]) -> Dict[str, float]:
    """Laminar sizing rule: submesh share proportional to measured cost."""
    total = sum(costs.values()) or 1.0
    return {k: v / total for k, v in costs.items()}
