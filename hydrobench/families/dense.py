"""Dense decoder (SmolLM, Llama-style blocks): the weights the benchmark
makes, and the plain float32 reference forward.

Weights are named and shaped as the program takes them (its parameter
layout: q as (d, H, D), o as (H, D, d), every layer's leaves stacked over
the layers, the embedding tied to the head) and drawn on the card from
the seed in one call of the generator: every matrix from a normal of
std 0.02, norm scales zero (stored as offsets from one).

The reference follows the block as published: x + Attn(RMSNorm(x)), then
h + SwiGLU(RMSNorm(h)); rotary embeddings on q and k (the rotation of
each head's two halves, frequencies theta^(-i / (D/2))); causal softmax
attention, kv heads shared by groups of H / Hkv query heads, scale
D^-1/2; final RMSNorm; logits against the tied embedding.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

import hb_counts
from hb_reference import linear, rms_norm

pad_to = 1   # the forward takes any length


def row_flops(cfg: dict, n: int) -> float:
    """Model FLOPs of a forward over one row of ``n`` live tokens."""
    return hb_counts.dense_row_flops(cfg, n)


def weight_shapes(cfg: dict) -> dict:
    d, hd = cfg["hidden_size"], cfg["head_dim"]
    h, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    f, L = cfg["intermediate_size"], cfg["num_hidden_layers"]
    return {
        "embed": (cfg["embedding_rows"], d),
        "final_norm": (d,),
        "layers.attn_norm": (L, d),
        "layers.wq": (L, d, h, hd),
        "layers.wk": (L, d, kv, hd),
        "layers.wv": (L, d, kv, hd),
        "layers.wo": (L, h, hd, d),
        "layers.mlp_norm": (L, d),
        "layers.w_gate": (L, d, f),
        "layers.w_up": (L, d, f),
        "layers.w_down": (L, f, d),
    }


def make_weights(cfg: dict, generator: torch.Generator, device,
                 dtype) -> dict:
    """Every leaf of ``weight_shapes`` in ``dtype`` on ``device``."""
    shapes = weight_shapes(cfg)
    mats = {k: s for k, s in shapes.items() if len(s) >= 2
            and not k.endswith("norm")}
    total = sum(math.prod(s) for s in mats.values())
    flat = torch.randn(total, generator=generator, device=device,
                       dtype=dtype).mul_(0.02)
    out, at = {}, 0
    for k, s in shapes.items():
        if k in mats:
            n = math.prod(s)
            out[k] = flat[at:at + n].view(s)
            at += n
        else:
            out[k] = torch.zeros(s, device=device, dtype=dtype)
    return out


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (R, n, H, D) rotated by position 0..n-1."""
    n, d = x.shape[1], x.shape[-1]
    half = d // 2
    freq = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                        device=x.device) / half)
    ang = torch.arange(n, dtype=torch.float32, device=x.device)[:, None] * freq
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def forward(cfg: dict, w: dict, tokens: torch.Tensor, quant=None):
    """(R, n) token ids -> (R, n, vocab) float32 logits."""
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    h_q, h_kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg["head_dim"]
    v = cfg["vocab_size"]
    emb = w["embed"][:v].to(torch.float32)
    x = emb[tokens]
    r, n, _ = x.shape
    mask = torch.ones(n, n, dtype=torch.bool, device=x.device).tril()
    for i in range(cfg["num_hidden_layers"]):
        lw = {k.split(".", 1)[1]: t[i] for k, t in w.items()
              if k.startswith("layers.")}
        a = rms_norm(x, lw["attn_norm"], eps)
        q = _rope(linear(a, lw["wq"], quant), theta)
        k = _rope(linear(a, lw["wk"], quant), theta)
        val = linear(a, lw["wv"], quant)
        rep = h_q // h_kv
        k = k.repeat_interleave(rep, dim=2)
        val = val.repeat_interleave(rep, dim=2)
        s = torch.einsum("rqhd,rkhd->rhqk", q, k) / math.sqrt(hd)
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        o = torch.einsum("rhqk,rkhd->rqhd", p, val).reshape(r, n, h_q * hd)
        x = x + linear(o, lw["wo"].reshape(h_q * hd, -1), quant)
        m = rms_norm(x, lw["mlp_norm"], eps)
        g = F.silu(linear(m, lw["w_gate"], quant)) * linear(m, lw["w_up"],
                                                            quant)
        x = x + linear(g, lw["w_down"], quant)
    x = rms_norm(x, w["final_norm"], eps)
    return linear(x, emb.T, quant)
