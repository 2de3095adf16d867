"""Public kernel entry points of the port.

The device of the input decides the path: a CUDA tensor runs the
hand-written kernel, a CPU tensor the plain version in ``ref.py``. There is
no switch that picks by whether a card is present. Every entry point
that launches a kernel launches through ``launch.kernel_call``, so timing
hooks see each launch; ``ssd_decode_step`` is plain torch, as in the JAX
package.
Each takes the JAX package's model-natural layout. The attention and SSD
kernels read it through strides as it is; the others need no transpose.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import launch, ref
from repro_torch.kernels.decode_attention import decode_attention_bshd
from repro_torch.kernels.flash_attention import flash_attention_bshd
from repro_torch.kernels.hsv_color import hsv_color_hist
from repro_torch.kernels.moe_router import moe_router_tk
from repro_torch.kernels.moe_router import moe_router_tokens as _router_tokens
from repro_torch.kernels.rglru import rglru_bsw
from repro_torch.kernels.rglru import rglru_tokens as _rglru_tokens
from repro_torch.kernels.ssd import ssd_bshp


def flash_attention(
    q: torch.Tensor,   # (B, S, H, D)
    k: torch.Tensor,   # (B, S, Hkv, D)
    v: torch.Tensor,   # (B, S, Hkv, D)
    *,
    causal: bool = True,
    window: int = 0,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """(B, S, H, D) attention, GQA over H // Hkv query heads per kv head.

    The kernel picks its own tiles and reads the (B, S, H, D) views through
    their strides: no transpose, no copy, no padding (a ragged causal S
    needs none: the mask keeps keys past a row from it). The block sizes
    keep the JAX package's one refusal: a non-causal S that is not a
    multiple of ``max(block_q, block_k)`` raises."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    if hkv == 0 or h % hkv:
        raise ValueError(f"Hkv must divide H, got H={h} Hkv={hkv}")
    if not causal and s % max(block_q, block_k):
        raise ValueError("the non-causal flash path needs S to be a "
                         f"multiple of the block, got S={s} block="
                         f"{max(block_q, block_k)}")
    return launch.kernel_call(
        lambda *a: flash_attention_bshd(*a, causal=causal, window=window),
        name="flash_attention", rows=b * h * s,
    )(q, k, v)


def decode_attention(
    q: torch.Tensor,        # (B, H, D)
    k_cache: torch.Tensor,  # (B, S, Hkv, D)
    v_cache: torch.Tensor,  # (B, S, Hkv, D)
    lengths: torch.Tensor,  # (B,)
    *,
    block_k: int = 256,
) -> torch.Tensor:
    """(B, H, D): each sequence's new token against its first ``lengths``
    cache entries. The kernel picks its own tiles and reads the views
    through their strides; as in the JAX package, S must be a multiple of
    ``min(block_k, S)``."""
    b, h, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    block = min(block_k, s)
    if block <= 0 or s % block:
        raise ValueError(f"S must be a positive multiple of min(block_k, S), "
                         f"got S={s} block_k={block_k}")
    if hkv == 0 or h % hkv:
        raise ValueError(f"Hkv must divide H, got H={h} Hkv={hkv}")
    return launch.kernel_call(
        decode_attention_bshd, name="decode_attention", rows=b * h,
    )(q, k_cache, v_cache, lengths)


def hsv_color_classify(
    crops: torch.Tensor,                 # (B, H, W, 3) RGB [0,255]
    ranges: torch.Tensor | None = None,  # (C, 6); default: ref.COLOR_RANGES
    *,
    block_rows: int = 64,
):
    """(hist (B, C+1) float32, label (B,) int64 argmax, lowest on ties).

    ``block_rows`` keeps the JAX package's signature; the kernel splits
    each crop by pixels and needs no row blocking."""
    if ranges is None:
        ranges = torch.as_tensor(ref.COLOR_RANGES, device=crops.device)
    hist = launch.kernel_call(
        hsv_color_hist, name="hsv_color", rows=int(crops.shape[0]),
    )(crops, ranges)
    return hist, torch.argmax(hist, dim=-1)


def moe_topk_router(logits: torch.Tensor, k: int):
    """(T, E) logits -> (weights (T, k) renormalised, idx (T, k) int32)."""
    return launch.kernel_call(
        moe_router_tk, name="moe_router", rows=int(logits.shape[0]),
    )(logits, k)


def moe_router_tokens(
    toks: torch.Tensor,    # (B, S) int32 token ids
    emb: torch.Tensor,     # (V, D)
    w_gate: torch.Tensor,  # (D, E)
    k: int,
):
    """(B, S) token ids -> (weights (B, k), idx (B, k) int32) of the router
    over each row's mean-pooled embeddings (``ref.router_logits``): the
    featurizer and the router in one launch."""
    return launch.kernel_call(
        _router_tokens, name="moe_router", rows=int(toks.shape[0]),
    )(toks, emb, w_gate, k)


def rglru(
    x: torch.Tensor,        # (B, S, W)
    r: torch.Tensor,
    i: torch.Tensor,
    a_param: torch.Tensor,  # (W,)
    h0: torch.Tensor | None = None,
    *,
    c: float = 8.0,
):
    """(out (B, S, W), h_last (B, W)); ``h0`` None is a zero state."""
    b, s, w = x.shape
    return launch.kernel_call(
        lambda *a: rglru_bsw(*a, c=c), name="rglru", rows=b * s,
    )(x, r, i, a_param, h0)


def rglru_tokens(
    toks: torch.Tensor,     # (B, S) int32 token ids
    emb_x: torch.Tensor,    # (V, W)
    emb_r: torch.Tensor,
    emb_i: torch.Tensor,
    a_param: torch.Tensor,  # (W,)
    h0: torch.Tensor | None = None,
):
    """(B, S) token ids -> (out (B, S, W), h_last (B, W)): ``rglru`` over
    the tables' rows of the tokens, the gather and the recurrence in one
    launch; ``h0`` None is a zero state."""
    b, s = toks.shape
    return launch.kernel_call(
        _rglru_tokens, name="rglru", rows=b * s,
    )(toks, emb_x, emb_r, emb_i, a_param, h0)


def ssd(
    x: torch.Tensor,    # (B, S, H, P)
    dt: torch.Tensor,   # (B, S, H)
    A: torch.Tensor,    # (H,)
    Bm: torch.Tensor,   # (B, S, G, N)
    Cm: torch.Tensor,   # (B, S, G, N)
    h0: torch.Tensor | None = None,
    *,
    chunk: int = 64,
):
    """(y (B, S, H, P), h_last (B, H, P, N) float32); ``h0`` defaults to
    zeros. The kernel reads the (B, S, H, P) views through their strides
    (a dt broadcast over heads included), starts from a zero state itself
    when ``h0`` is None and writes y in this layout: one launch, no copy."""
    b, s = x.shape[:2]
    return launch.kernel_call(
        lambda *a: ssd_bshp(*a, chunk=min(chunk, s)), name="ssd", rows=b * s,
    )(x, dt, A, Bm, Cm, h0)


def ssd_decode_step(x, dt, A, Bm, Cm, h):
    """One recurrent SSD step ((B, H, P) token, (B, H, P, N) float32
    state) -> (y (B, H, P), new state): tiny tensors, plain torch
    operations (``ref.ssd_decode_step``), as the JAX package runs it."""
    return ref.ssd_decode_step(x, dt, A, Bm, Cm, h)
