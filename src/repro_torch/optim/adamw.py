"""Optimizers: AdamW (+ dtype-configurable moments) and Adafactor.

Port of ``repro.optim.adamw`` with the reference's functional interface:
``init(params)``, ``update(grads, state, params) -> (updates, state)`` and
``global_norm``. Here ``params`` and ``grads`` are dicts of tensors keyed
by the parameters' dotted names, in ``models.params.param_leaves`` order
(the order ``jax.tree.flatten`` walks the reference's pytree in), each
leaf stacked over the layers as in the JAX package: Adafactor factors
every leaf of two or more dimensions, the stacked norms included, so the
layout decides its state. Every operation runs in float32 in the
reference's order: the clip scale, the bias correction by ``count``,
``eps`` outside the square root, weight decay inside ``lr``; the moments
are stored in ``moment_dtype``. Updates are returned (not applied) so the
train step controls the parameter dtype cast. Where the reference returns
new moment arrays, ``AdamW.update`` writes them into the state's own
tensors, a slice of ``UPDATE_SLICE`` elements at a time, and returns that
state: a step then holds one copy of the moments and float32 temporaries
of one slice, not two copies and a leaf's temporaries (recurrentgemma-9b's
embedding alone is 1.05 G elements, 4.2 GB a float32 temporary). ``state_shapes`` builds on
the meta device; ``state_logical`` gives the state's logical dims from the
parameters' (a name-keyed dict of them, as ``params.param_leaves`` walks
the family's ``param_logical``).

On a mesh the leaves are ``DTensor``s, each gradient, moment and
parameter in the same placements: ``AdamW.update`` runs its slices on
each rank's blocks, and the global norm sums each rank's blocks' squares
(a replicated leaf's divided by its copies) with one all-reduce over the
mesh. With one rank, or plain tensors, it is the float32 sum of the
leaves' sums in their order, as before.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict

import torch

from repro_torch.distributed.sharding import (
    is_dtensor, local as _local, mesh_all_reduce, parse_dims,
)

Tree = Dict[str, torch.Tensor]

UPDATE_SLICE = 1 << 26   # elements of a leaf AdamW.update works on at once


def constant_schedule(lr: float) -> Callable:
    """step (a 0-d tensor) -> lr as a float32 0-d tensor on its device."""
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=torch.as_tensor(step).device)


def cosine_schedule(peak_lr: float, warmup: int, total: int, floor: float = 0.1):
    def fn(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup, warm, cos)

    return fn


def _tree_global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, a plain float32 0-d
    tensor."""
    leaves = [torch.sum(torch.square(_local(x).to(torch.float32)))
              for x in tree.values()]
    mesh = next((x.device_mesh for x in tree.values() if is_dtensor(x)), None)
    if mesh is not None and mesh.size() > 1:
        sizes = tuple(mesh.shape)
        for i, x in enumerate(tree.values()):
            # a plain leaf (a stack of no layers) is on every rank
            copies = math.prod(n for n, p in zip(sizes, x.placements)
                               if not p.is_shard()) if is_dtensor(x) \
                else mesh.size()
            if copies > 1:
                leaves[i] = leaves[i] / copies
        return torch.sqrt(mesh_all_reduce(sum(leaves), "sum", mesh))
    return torch.sqrt(sum(leaves))


def _clip_scale(clip_norm: float, gnorm: torch.Tensor):
    if not clip_norm:
        return 1.0
    return torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)


def _count(state_count: torch.Tensor) -> torch.Tensor:
    return state_count + 1   # int32 stays int32


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


@dataclass(frozen=True)
class AdamW:
    schedule: Callable = field(default_factory=lambda: constant_schedule(1e-3))
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: float = 1.0
    moment_dtype: str = "float32"

    def init(self, params: Tree) -> Dict:
        mdt = getattr(torch, self.moment_dtype)
        device = next(iter(params.values())).device
        return {
            "m": {k: torch.zeros_like(p, dtype=mdt)
                  for k, p in params.items()},
            "v": {k: torch.zeros_like(p, dtype=mdt)
                  for k, p in params.items()},
            "count": torch.zeros((), dtype=torch.int32, device=device),
        }

    def state_shapes(self, param_shapes: Tree) -> Dict:
        """Meta tensors mirroring init() (for a dry run)."""
        mdt = getattr(torch, self.moment_dtype)
        return {
            "m": {k: _spec(s.shape, mdt) for k, s in param_shapes.items()},
            "v": {k: _spec(s.shape, mdt) for k, s in param_shapes.items()},
            "count": _spec((), torch.int32),
        }

    def state_logical(self, param_logical: Dict[str, str]) -> Dict:
        return {"m": dict(param_logical), "v": dict(param_logical),
                "count": ""}  # scalar

    def global_norm(self, tree: Tree) -> torch.Tensor:
        return _tree_global_norm(tree)

    def update(self, grads: Tree, state: Dict, params: Tree):
        count = _count(state["count"])
        scale = _clip_scale(self.clip_norm, _tree_global_norm(grads))
        lr = self.schedule(_local(count))
        b1, b2 = self.b1, self.b2
        mdt = getattr(torch, self.moment_dtype)
        cf = _local(count).to(torch.float32)
        c1, c2 = 1 - b1 ** cf, 1 - b2 ** cf
        updates = {}
        for k, g in grads.items():
            m, v = state["m"][k], state["v"][k]
            if m.dtype != mdt or v.dtype != mdt:
                raise ValueError(f"AdamW moments of {k} must be {mdt}")
            p = params[k]
            if is_dtensor(g) and not all(
                    is_dtensor(t) and t.placements == g.placements
                    for t in (m, v, p)):
                raise ValueError(f"AdamW leaf {k}: its gradient, moments "
                                 "and parameter must share placements")
            gl = _local(g)
            out = torch.empty(gl.shape, dtype=torch.float32, device=gl.device)
            updates[k] = out
            if is_dtensor(g):
                from torch.distributed.tensor import DTensor

                updates[k] = DTensor.from_local(
                    out, g.device_mesh, g.placements, run_check=False,
                    shape=g.shape, stride=g.stride())
            flat = (gl.reshape(-1), _local(m).view(-1), _local(v).view(-1),
                    _local(p).reshape(-1), out.view(-1))
            for i in range(0, gl.numel(), UPDATE_SLICE):
                gs, ms, vs, ps, us = (t[i:i + UPDATE_SLICE] for t in flat)
                gs = gs.to(torch.float32) * scale
                m32 = b1 * ms.to(torch.float32) + (1 - b1) * gs
                v32 = b2 * vs.to(torch.float32) + (1 - b2) * gs * gs
                mhat = m32 / c1
                vhat = v32 / c2
                us.copy_(-lr * (mhat / (torch.sqrt(vhat) + self.eps)
                                + self.weight_decay * ps.to(torch.float32)))
                ms.copy_(m32)
                vs.copy_(v32)
        return updates, {"m": state["m"], "v": state["v"], "count": count}


@dataclass(frozen=True)
class Adafactor:
    """Factored second moments for >=2D params: O(sum dims) optimizer memory."""

    schedule: Callable = field(default_factory=lambda: constant_schedule(1e-3))
    decay: float = 0.99
    eps: float = 1e-30
    clip_norm: float = 1.0

    @staticmethod
    def _factor_shapes(shape) -> Dict:
        shape = tuple(shape)
        if len(shape) >= 2:
            return {"row": shape[:-1], "col": shape[:-2] + shape[-1:]}
        return {"v": shape}

    def init(self, params: Tree) -> Dict:
        device = next(iter(params.values())).device
        return {
            "f": {k: {n: torch.zeros(s, dtype=torch.float32, device=p.device)
                      for n, s in self._factor_shapes(p.shape).items()}
                  for k, p in params.items()},
            "count": torch.zeros((), dtype=torch.int32, device=device),
        }

    def state_shapes(self, param_shapes: Tree) -> Dict:
        return {
            "f": {k: {n: _spec(s, torch.float32)
                      for n, s in self._factor_shapes(p.shape).items()}
                  for k, p in param_shapes.items()},
            "count": _spec((), torch.int32),
        }

    def state_logical(self, param_logical: Dict[str, str]) -> Dict:
        def z(logical):
            dims = parse_dims(logical)
            if len(dims) >= 2:
                row = " ".join(d or "." for d in dims[:-1])
                col = " ".join(d or "." for d in (dims[:-2] + dims[-1:]))
                return {"row": row, "col": col}
            return {"v": logical}

        return {"f": {k: z(lg) for k, lg in param_logical.items()},
                "count": ""}

    def global_norm(self, tree: Tree) -> torch.Tensor:
        return _tree_global_norm(tree)

    def update(self, grads: Tree, state: Dict, params: Tree):
        count = _count(state["count"])
        scale = _clip_scale(self.clip_norm, _tree_global_norm(grads))
        lr = self.schedule(count)
        d = self.decay
        updates, new_f = {}, {}
        for k, g in grads.items():
            f = state["f"][k]
            g = g.to(torch.float32) * scale
            g2 = g * g + self.eps
            if "row" in f:
                # the reference's expressions, each full-size intermediate
                # computed in place (the same operations in the same order,
                # so the same bits): a leaf of grok-1's experts is 6.4 GB
                # in float32
                row = d * f["row"] + (1 - d) * torch.mean(g2, dim=-1)
                col = d * f["col"] + (1 - d) * torch.mean(g2, dim=-2)
                del g2
                rms = row[..., :, None] * col[..., None, :]
                rms.div_(torch.clamp(
                    torch.mean(row, dim=-1, keepdim=True)[..., None],
                    min=self.eps)).sqrt_()
                updates[k] = g.mul_(-lr).div_(rms.clamp_(min=1e-12))
                del rms
                new_f[k] = {"row": row, "col": col}
            else:
                v = d * f["v"] + (1 - d) * g2
                updates[k] = -lr * g / torch.sqrt(torch.clamp(v, min=1e-12))
                new_f[k] = {"v": v}
        return updates, {"f": new_f, "count": count}
