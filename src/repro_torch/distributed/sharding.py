"""Logical-axis sharding rules with divisibility-aware fallback.

Port of ``repro.distributed.sharding`` onto ``torch.distributed``'s
``DeviceMesh`` and ``DTensor``. Model code annotates every tensor dim with
a *logical* name ("d_ff", "heads", "batch", ...). ``spec_for`` resolves
logical names to mesh axes through a ``Rules`` table, replicating any dim
whose size does not divide the mapped mesh axes (the GQA kv-head /
grok-expert cases) — never a sharding error, by construction.

Two standard rule sets (the reference's tables, copied):
  * TRAIN_RULES — FSDP x TP: weight d_model dims shard over "data"
    (ZeRO-3-style; DTensor's dispatch gathers them where an op needs
    them), wide dims (d_ff / heads / vocab / experts) over "model"; batch
    over ("pod","data").
  * SERVE_RULES — TP only: weights shard over "model"; batch over
    ("pod","data"); decode KV caches shard seq over "model"
    (flash-decode partial-softmax combine, see models/attention.py).

Where the reference returns a ``PartitionSpec``, ``spec_for`` returns a
tuple with one entry a tensor dim: None, a mesh axis name, or a tuple of
names. ``placements_for`` turns it into one ``Shard(d)`` or
``Replicate()`` a mesh dim, the form ``DTensor`` takes. A mesh is a
``DeviceMesh`` or anything with its ``mesh_dim_names`` and ``shape``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

AxisSpec = Union[None, str, Tuple[str, ...]]
Spec = Tuple[AxisSpec, ...]


class Rules:
    def __init__(self, table: Dict[str, AxisSpec], name: str = "rules"):
        self.table = dict(table)
        self.name = name

    def get(self, logical: Optional[str]) -> AxisSpec:
        if logical is None:
            return None
        return self.table.get(logical)

    def replace(self, **kw: AxisSpec) -> "Rules":
        t = dict(self.table)
        t.update(kw)
        return Rules(t, name=self.name + "+")

    def __repr__(self):
        return f"Rules({self.name})"


TRAIN_RULES = Rules(
    {
        "batch": ("pod", "data"),
        "seq": None,
        "seq_sp": "model",        # sequence-parallel inter-block activations
        "d_model": None,          # activation feature dim: replicated
        "d_model_w": "data",      # weight feature dim: FSDP over data
        "attn_dw": "data",        # attention in/out feature dim (== d_model_w at train)
        "d_sharded": None,        # transient constraint: replicated at train
        "experts_data": "data",   # ep2d storage (serve-only configs)
        "expert_dw": "data",      # expert weight feature dim (FSDP)
        "heads": "model",
        "kv_heads": "model",
        "d_ff": "model",
        "vocab": "model",
        "experts": "model",
        "state": None,
        "ssm_heads": "model",
        "ssm_inner": "model",
        "lru": "model",
        "lru_blocks": "model",
        "frames": None,
        "patches": None,
        "cache_seq": "model",
        "window": None,
        "conv": None,
        "layers": None,           # scan-stacked leading dim
    },
    name="train(FSDPxTP)",
)

SERVE_RULES = Rules(
    {
        "batch": ("pod", "data"),
        "seq": None,
        "seq_sp": "model",
        "d_model": None,
        "d_model_w": None,        # no FSDP at serve time: weights resident
        # attention projections of archs whose head count does NOT divide
        # the model axis (56, 12, 9 heads...) shard on the FEATURE dim at
        # serve: GBs of replicated projections become a tiny per-token psum
        "attn_dw": "model",
        "d_sharded": "model",     # transient activation constraint (out_proj)
        "experts_data": "data",   # ep2d resident-expert storage layout
        "expert_dw": "data",      # 480B experts can't be data-replicated
        "heads": "model",
        "kv_heads": "model",
        "d_ff": "model",
        "vocab": "model",
        "experts": "model",
        "state": None,
        "ssm_heads": "model",
        "ssm_inner": "model",
        "lru": "model",
        "lru_blocks": "model",
        "frames": None,
        "patches": None,
        "cache_seq": "model",     # sequence-sharded KV cache
        "window": None,
        "conv": None,
        "layers": None,
    },
    name="serve(TP)",
)


def _sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def axis_size(mesh, axes: AxisSpec) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= _sizes(mesh).get(a, 1)
    return n


def _present(mesh, axes: AxisSpec) -> AxisSpec:
    """Drop mesh axes that do not exist on this mesh (e.g. 'pod' single-pod)."""
    if axes is None:
        return None
    names = tuple(mesh.mesh_dim_names)
    if isinstance(axes, str):
        return axes if axes in names else None
    kept = tuple(a for a in axes if a in names)
    if not kept:
        return None
    return kept if len(kept) > 1 else kept[0]


def parse_dims(logical: Union[str, Sequence[Optional[str]]]) -> Tuple[Optional[str], ...]:
    """Logical dims are space-separated strings so they stay tree LEAVES.

    ``"layers d_model_w d_ff"`` -> ("layers", "d_model_w", "d_ff");
    ``"."`` marks a replicated dim: ``"batch . d_model"``.
    """
    if isinstance(logical, str):
        return tuple(None if t == "." else t for t in logical.split())
    return tuple(logical)


def spec_for(
    shape: Sequence[int],
    logical: Union[str, Sequence[Optional[str]]],
    rules: Rules,
    mesh,
) -> Spec:
    """The spec for ``shape`` whose dims carry ``logical`` names: one entry
    a dim, None or the mesh axes (a name, or a tuple of names) it shards
    over.

    A dim is sharded over its mapped mesh axes only if its size is divisible
    by the product of those axis sizes AND no axis is claimed twice within
    the same spec; otherwise it is replicated.
    """
    logical = parse_dims(logical)
    assert len(shape) == len(logical), (shape, logical)
    sizes = _sizes(mesh)
    out = []
    used: set = set()
    for size, name in zip(shape, logical):
        axes = _present(mesh, rules.get(name))
        if axes is None:
            out.append(None)
            continue
        tup = (axes,) if isinstance(axes, str) else tuple(axes)
        if any(a in used for a in tup):
            out.append(None)
            continue
        denom = math.prod(sizes[a] for a in tup)
        if denom > 1 and size % denom == 0:
            out.append(axes)
            used.update(tup)
        else:
            out.append(None)
    return tuple(out)


def placements_for(spec: Spec, mesh) -> tuple:
    """One placement a mesh dim: ``Shard(d)`` where tensor dim d shards
    over that axis, else ``Replicate()``. A dim over two axes (("pod",
    "data")) is ``Shard(d)`` on both, in mesh order: the first is the major
    one, as in the reference's layout."""
    from torch.distributed.tensor import Replicate, Shard

    owner = {}
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        for a in ((axes,) if isinstance(axes, str) else axes):
            owner[a] = d
    return tuple(Shard(owner[n]) if n in owner else Replicate()
                 for n in mesh.mesh_dim_names)


def placements(shape, logical, rules: Rules, mesh) -> tuple:
    return placements_for(spec_for(shape, logical, rules, mesh), mesh)


def local_slice(t: torch.Tensor, places, mesh) -> torch.Tensor:
    """This rank's block of a global tensor ``t`` under ``places`` (each
    sharded dim divides evenly, as ``spec_for`` guarantees): a view."""
    coord = mesh.get_coordinate()
    sizes = tuple(mesh.shape)
    out = t
    for d in range(t.dim()):
        idx, n = 0, 1
        for m, p in enumerate(places):
            if p.is_shard(d):
                idx, n = idx * sizes[m] + coord[m], n * sizes[m]
        if n > 1:
            step = t.shape[d] // n
            out = out.narrow(d, idx * step, step)
    return out


def from_global(t: torch.Tensor, places, mesh) -> torch.Tensor:
    """A ``DTensor`` of the global tensor ``t``, which every rank holds
    alike (a seeded draw, a host batch), with no collective: each rank
    keeps its block. A replicated tensor is wrapped as it is, with no
    copy; a sharded one keeps a contiguous copy of its block."""
    from torch.distributed.tensor import DTensor

    local = local_slice(t, places, mesh)
    if local is not t:
        local = local.contiguous()
    return DTensor.from_local(local, mesh, places, run_check=False,
                              shape=t.shape, stride=t.stride())


def distribute(t: torch.Tensor, logical, rules: Rules, mesh) -> torch.Tensor:
    """The reference's ``named_sharding`` + ``device_put``: ``t`` (the
    same global value on every rank) as a ``DTensor`` placed by its
    logical dims."""
    return from_global(t, placements(t.shape, logical, rules, mesh), mesh)


def batch_axes(mesh) -> AxisSpec:
    return _present(mesh, ("pod", "data"))


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def plain(x):
    """A ``DTensor``'s global value as a plain tensor; anything else as it
    is."""
    return x.full_tensor() if is_dtensor(x) else x


def constrain(x, logical: Union[str, Sequence[Optional[str]]], rules: Rules, mesh):
    """The reference's ``with_sharding_constraint`` by logical dim names:
    a ``DTensor`` is redistributed to the placements its logical dims
    resolve to; a plain tensor, or no mesh, is left as it is (the
    reference's off-mesh identity)."""
    if mesh is None or not is_dtensor(x):
        return x
    want = placements(x.shape, logical, rules, mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def tree_placements(shapes_tree, logical_tree, rules: Rules, mesh):
    """Map matching (name-keyed tensor dict, logical-dims dict) ->
    placements, over nested dicts."""
    if isinstance(shapes_tree, dict):
        return {k: tree_placements(shapes_tree[k], logical_tree[k], rules, mesh)
                for k in shapes_tree}
    return placements(shapes_tree.shape, logical_tree, rules, mesh)


def tree_distribute(tree, logical_tree, rules: Rules, mesh):
    """``distribute`` every plain tensor leaf of nested dicts by the
    matching leaf of ``logical_tree``; a ``DTensor`` leaf as it is."""
    if isinstance(tree, dict):
        return {k: tree_distribute(tree[k], logical_tree[k], rules, mesh)
                for k in tree}
    return tree if is_dtensor(tree) else distribute(tree, logical_tree,
                                                    rules, mesh)


def local_call(fn, args, places, mesh, outs):
    """``fn`` on each rank's blocks of ``args`` (the reference's
    ``shard_map`` body), so a kernel's wrapper sees plain tensors and never
    a ``DTensor``.

    ``places``: for each arg, the placements it is redistributed to before
    its block is taken, or None to pass it as it is (a non-tensor). A plain
    tensor arg is taken as the global value every rank holds. ``outs``: for
    each output, the placements its block is wrapped with, or the index of
    the arg whose placements it takes (an output that is that arg's block
    itself, written in place, comes back as the arg). Gradients flow: an
    arg replicated over a mesh dim that another arg is split over gets a
    partial (summed) gradient there, as a ``shard_map`` input's does."""
    from torch.distributed.tensor import DTensor, Partial

    split = [any(p is not None and p[m].is_shard() for p in places)
             for m in range(mesh.ndim)]
    local, kept = [], []
    for a, p in zip(args, places):
        if p is None or a is None:
            local.append(a)
            kept.append(None)
            continue
        same = isinstance(a, DTensor) and tuple(a.placements) == tuple(p)
        if not isinstance(a, DTensor):
            a = from_global(a, p, mesh)
        elif not same:
            a = a.redistribute(mesh, p)
        grad = tuple(Partial() if split[m] and not q.is_shard() else q
                     for m, q in enumerate(p))
        local.append(a.to_local(grad_placements=grad))
        kept.append(a if same else None)
    res = fn(*local)
    single = not isinstance(res, tuple)
    res = (res,) if single else res
    wrapped = []
    for r, o in zip(res, outs):
        if r is None or o is None:
            wrapped.append(r)
        elif isinstance(o, int) and r is local[o] and kept[o] is not None:
            wrapped.append(kept[o])   # written in place: the arg itself
        else:
            p = places[o] if isinstance(o, int) else o
            wrapped.append(DTensor.from_local(r, mesh, p, run_check=False))
    return wrapped[0] if single else tuple(wrapped)


def all_reduce(t: torch.Tensor, op: str, mesh, axes) -> torch.Tensor:
    """``t`` reduced (``op``: "sum" or "max") over the mesh ``axes`` (a
    name or a tuple of names) with ``torch.distributed``'s functional
    collectives: the reference's ``psum``/``pmax`` inside ``shard_map``.
    Not differentiable: the paths that call it take no gradient."""
    from torch.distributed import _functional_collectives as funcol

    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    for a in axes:
        if axis_size(mesh, a) > 1:
            t = funcol.all_reduce(t, op, mesh.get_group(a))
    return funcol.wait_tensor(t) if isinstance(
        t, funcol.AsyncCollectiveTensor) else t


def mesh_all_reduce(t: torch.Tensor, op: str, mesh) -> torch.Tensor:
    """``t`` reduced over every rank of ``mesh``, in one collective where
    the mesh is the whole world."""
    import torch.distributed as dist
    from torch.distributed import _functional_collectives as funcol

    if mesh.size() == dist.get_world_size():
        return funcol.wait_tensor(funcol.all_reduce(t, op, dist.group.WORLD))
    return all_reduce(t, op, mesh, tuple(mesh.mesh_dim_names))


def local(x):
    """A ``DTensor``'s block on this rank; anything else as it is."""
    return x.to_local() if is_dtensor(x) else x


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along the mesh axis ``axis`` (the
    reference's ``lax.axis_index``)."""
    return mesh.get_local_rank(axis)
