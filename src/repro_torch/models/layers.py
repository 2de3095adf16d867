"""Shared building blocks: RMSNorm, RoPE, SwiGLU MLP, embeddings.

Port of ``repro.models.layers``. All model math runs in ``cfg.dtype`` with
float32 norms, activations and softmax, as in the JAX package. The JAX
package's ``ShardCtx`` (a mesh and logical sharding rules) is left out, and
so is the ``ctx`` argument of every function: the port runs at world size
1, where the reference's context is ``NULL_CTX`` and every constraint is the
identity. Sharding is not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


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


def swiglu_mlp(x, w_gate, w_up, w_down):
    """(B, S, D) -> (B, S, D)."""
    g = torch.matmul(x, w_gate.to(x.dtype))
    u = torch.matmul(x, w_up.to(x.dtype))
    h = F.silu(g.to(torch.float32)).to(x.dtype) * u
    return torch.matmul(h, w_down.to(x.dtype))


def embed_tokens(tokens, embed):
    return embed[tokens]


def position_ids(b: int, s: int, device) -> torch.Tensor:
    """(B, S) int32 positions 0..S-1 of every sequence."""
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def stacked(states: list) -> dict:
    """Per-layer cache dicts -> one dict of tensors stacked over the
    layers (the JAX package's scan outputs)."""
    return {k: torch.stack([st[k] for st in states]) for k in states[0]}


def lm_logits(h, out_head, vocab_size: int):
    """Project to (padded) vocab and mask pad logits to -1e9 (exact loss)."""
    logits = torch.matmul(h, out_head.to(h.dtype))
    vp = out_head.shape[-1]
    if vp != vocab_size:
        pad = torch.arange(vp, device=logits.device) >= vocab_size
        logits = logits.masked_fill(pad, -1e9)
    return logits


def softmax_xent(logits, labels, mask=None):
    """Mean next-token cross-entropy. logits (B,S,V) fp-any, labels (B,S)."""
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
