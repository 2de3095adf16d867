"""Shared building blocks: RMSNorm, RoPE, SwiGLU MLP, embeddings, ShardCtx.

Port of ``repro.models.layers``. All model math runs in ``cfg.dtype`` with
float32 norms, activations and softmax, as in the JAX package. Every
function that the reference gives a ``ShardCtx`` (a ``DeviceMesh`` and
logical rules) takes one too, as its last argument with ``NULL_CTX`` by
default: with no mesh every constraint is the identity and the tensors
are plain; on a mesh the parameters and the batch are ``DTensor``s, each
constraint a redistribution (``distributed.sharding.constrain``), and a
kernel gets each rank's blocks as plain tensors (``ShardCtx.local``).
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (
    Rules,
    axis_size,
    constrain,
    is_dtensor,
    local_call,
    placements,
    placements_for,
)


@dataclass(frozen=True)
class ShardCtx:
    mesh: Optional[object] = None   # torch.distributed DeviceMesh
    rules: Optional[Rules] = None

    def constrain(self, x, logical: str):
        if self.mesh is None or self.rules is None:
            return x
        return constrain(x, logical, self.rules, self.mesh)

    def axis_size(self, name: str) -> int:
        if self.mesh is None or name not in self.mesh.mesh_dim_names:
            return 1
        return axis_size(self.mesh, name)

    def places(self, shape, logical: str) -> tuple:
        return placements(shape, logical, self.rules, self.mesh)

    def local(self, fn, args, logical, outs):
        """``fn(*args)`` on each rank's blocks (``sharding.local_call``),
        each tensor arg placed by its entry in ``logical``: logical dims, a
        spec tuple (``spec_for``'s form), or None to pass the arg as it
        is; ``outs`` gives each output the placements of the arg at that
        index, or placements of its own. With no mesh, or no ``DTensor``
        among the args, ``fn(*args)`` as it is."""
        from torch.distributed.tensor import DTensor

        if self.mesh is None or not any(isinstance(a, DTensor) for a in args):
            return fn(*args)
        places = [None if lg is None or a is None
                  else placements_for(lg, self.mesh) if isinstance(lg, tuple)
                  else self.places(a.shape, lg)
                  for a, lg in zip(args, logical)]
        return local_call(fn, args, places, self.mesh, outs)

    def scope(self):
        """The context a model entry runs in: on a mesh, plain tensors
        made inside the model (positions, masks) count as replicated."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return _replicate_plain()


_SCOPES = [0]   # model entries open now, on any thread (the flag is global)
_SCOPES_LOCK = threading.Lock()


@contextlib.contextmanager
def _replicate_plain():
    """``torch.distributed.tensor.experimental.implicit_replication``,
    entered by the outermost model entry only: the library's turns the
    flag off on exit, which would end an outer entry's scope early (a
    forward inside a loss, a remat recompute inside a backward pass)."""
    from torch.distributed.tensor.experimental import implicit_replication

    with _SCOPES_LOCK:
        outer = _SCOPES[0] == 0
        _SCOPES[0] += 1
    try:
        if outer:
            with implicit_replication():
                yield
        else:
            yield
    finally:
        with _SCOPES_LOCK:
            _SCOPES[0] -= 1


NULL_CTX = ShardCtx()


def dtype_of(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + w.to(torch.float32))).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, D); positions: (..., S)."""
    d = x.shape[-1]
    half = d // 2
    exponent = torch.arange(half, dtype=torch.float32, device=x.device) / half
    freq = 1.0 / (theta ** exponent)
    angles = positions[..., None].to(torch.float32) * freq  # (..., S, half)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    xf1 = x[..., :half].to(torch.float32)
    xf2 = x[..., half:].to(torch.float32)
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu_mlp(x, w_gate, w_up, w_down, ctx: ShardCtx = NULL_CTX):
    """(B, S, D) -> (B, S, D); d_ff TP-sharded."""
    g = torch.matmul(x, w_gate.to(x.dtype))
    u = torch.matmul(x, w_up.to(x.dtype))
    h = F.silu(g.to(torch.float32)).to(x.dtype) * u
    h = ctx.constrain(h, "batch seq d_ff")
    out = torch.matmul(h, w_down.to(x.dtype))
    return ctx.constrain(out, "batch seq d_model")


class _GradInPlace(torch.autograd.Function):
    """The identity, whose gradient comes back in the input's placements.
    A tied embedding's two uses (the lookup and the head) give gradients
    in different placements, and DTensor's sum of them may need a
    redistribution it lacks (from a shard to a partial, torch 2.11):
    brought to the parameter's placements first, they add as they are."""

    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.places = x.device_mesh, tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.places:
            g = g.redistribute(ctx.mesh, ctx.places)
        return g


def grad_in_place(w: torch.Tensor) -> torch.Tensor:
    """``w``, a ``DTensor``'s gradient through it in its own placements
    (``_GradInPlace``); a plain tensor as it is."""
    return _GradInPlace.apply(w) if is_dtensor(w) else w


def embed_tokens(tokens, embed, ctx: ShardCtx = NULL_CTX):
    return ctx.constrain(grad_in_place(embed)[tokens], "batch seq d_model")


def pad_dim(x: torch.Tensor, dim: int, before: int = 0,
            after: int = 0) -> torch.Tensor:
    """``x`` with ``before`` and ``after`` zero slices on dimension
    ``dim`` (``F.pad``). A ``DTensor`` is padded by a concatenation with
    zeros instead: DTensor's pad can lose a placement on a mesh of two or
    more dims (torch 2.11), which its concatenation keeps."""
    if not is_dtensor(x):
        return F.pad(x, [0, 0] * (x.dim() - 1 - dim) + [before, after])
    zero = torch.zeros_like(x.narrow(dim, 0, 1))
    return torch.cat([zero] * before + [x] + [zero] * after, dim=dim)


def position_ids(b: int, s: int, device) -> torch.Tensor:
    """(B, S) int32 positions 0..S-1 of every sequence."""
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def stacked(states: list) -> dict:
    """Per-layer cache dicts -> one dict of tensors stacked over the
    layers (the JAX package's scan outputs)."""
    return {k: torch.stack([st[k] for st in states]) for k in states[0]}


def lm_logits(h, out_head, vocab_size: int, ctx: ShardCtx = NULL_CTX):
    """Project to (padded) vocab and mask pad logits to -1e9 (exact loss)."""
    logits = torch.matmul(h, out_head.to(h.dtype))
    logits = ctx.constrain(logits, "batch seq vocab")
    vp = out_head.shape[-1]
    if vp != vocab_size:
        pad = torch.arange(vp, device=logits.device) >= vocab_size
        logits = logits.masked_fill(pad, -1e9)
    return logits


def softmax_xent(logits, labels, mask=None):
    """Mean next-token cross-entropy. logits (B,S,V) fp-any, labels (B,S).
    A ``DTensor``'s vocab is gathered first: its gather over a sharded
    vocab leaves a masked partial that the later reduction cannot take."""
    if is_dtensor(logits) and any(p.is_shard(logits.dim() - 1)
                                  for p in logits.placements):
        from torch.distributed.tensor import Replicate

        logits = logits.redistribute(logits.device_mesh, [
            Replicate() if p.is_shard(logits.dim() - 1) else p
            for p in logits.placements])
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is None:
        return torch.mean(nll)
    mask = mask.to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


# ------------------------------ init helpers ------------------------------ #
def trunc_normal(generator: torch.Generator, shape, std: float, dtype,
                 device=None) -> torch.Tensor:
    """A normal draw truncated to [-2, 2] in float32, times ``std``, in
    ``dtype``: the JAX package's initialiser, from a torch generator (so
    not its numbers)."""
    out = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return out.mul_(std).to(dtype)
