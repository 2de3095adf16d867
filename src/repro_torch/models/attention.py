"""GQA attention: training/prefill through the flash kernel, and decode.

Port of ``repro.models.attention`` at world size 1: the projections, the
full-sequence attention, the encoder-decoder's cross-attention and the
local decode path. The JAX package's ``shard_map`` branches (a
sequence-sharded cache combined with a psum rescale) wait for the port of
sharding.

The full-sequence attention and the cross-attention call the flash
kernel's wrapper (``kernels.flash_attention.flash_attention_bshd``) on the
(B, S, H, D) views as they are: a CUDA tensor launches the hand-written
kernel and a CPU tensor runs its plain version. The reference pins its
cross-attention to the XLA path (``impl="xla"``); the port's models ignore
``attention_impl`` everywhere, so on the card the cross-attention runs
the kernel, non-causal with Sq != Sk (the same function). It does not go
through
``ops.flash_attention``, whose ``launch.kernel_call`` waits on the stream
after every launch while timing hooks are connected: the JAX package's
model forward is jitted, and under jit a ``pallas_call`` records no launch
event either. So a model's launches are counted
(``flash_attention.launches``) but not timed; the predicate that runs the
model is timed as a whole.

Decode keeps the reference's math, which runs outside any kernel there
too: the grouped products with float32 sums, masked logits at -1e30, an
empty row's sum taken as 1, and ``ref.decode_attention`` for the ring
buffer. The new token's K/V is written into the cache tensors in place
(the JAX package donates its cache buffers to the same end).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention_bshd
from repro_torch.models.layers import rope


def qkv_proj(cfg, x, wq, wk, wv):
    dt = x.dtype

    def proj(w):  # "bsd,dhk->bshk"
        return torch.matmul(x, w.to(dt).flatten(1)).unflatten(-1, w.shape[1:])

    return proj(wq), proj(wk), proj(wv)


def out_proj(x, wo):
    # "bshk,hkd->bsd"
    return torch.matmul(x.flatten(2), wo.to(x.dtype).flatten(0, 1))


def attention_train(cfg, x, lp, positions, *, window: int = 0,
                    causal: bool = True):
    """Full training/prefill attention. lp: a layer's parameters with
    wq/wk/wv/wo."""
    q, k, v = qkv_proj(cfg, x, lp["wq"], lp["wk"], lp["wv"])
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    o = flash_attention_bshd(q, k, v, causal=causal, window=window)
    return out_proj(o, lp["wo"]), (k, v)


def cross_attention(cfg, x, lp, k, v):
    """Decoder cross-attention over precomputed encoder K/V (no mask).
    x (B, S, D); k, v (B, F, Hkv, D)."""
    wq = lp["xwq"].to(x.dtype)   # "bsd,dhk->bshk"
    q = torch.matmul(x, wq.flatten(1)).unflatten(-1, wq.shape[1:])
    o = flash_attention_bshd(q, k, v, causal=False)
    return out_proj(o, lp["xwo"])


# --------------------------------------------------------------------------- #
# decode                                                                       #
# --------------------------------------------------------------------------- #
def _write_rows(cache, new, index, *, keep_outside: bool):
    """cache (B, S, Hkv, D) <- new (B, Hkv, D) at row index[b] of each
    sequence, in place. An index outside [0, S) is clamped to it, as JAX's
    ``dynamic_update_slice`` clamps its start; with ``keep_outside`` the
    clamped row keeps its old value instead (the reference's row-wise
    select)."""
    s = cache.shape[1]
    rows = torch.arange(cache.shape[0], device=cache.device)
    at = index.to(torch.int64).clamp(0, s - 1)
    new = new.to(cache.dtype)
    if keep_outside:
        inside = ((index >= 0) & (index < s))[:, None, None]
        new = torch.where(inside, new, cache[rows, at])
    cache[rows, at] = new
    return cache


def _local_decode(q, k_cache, v_cache, new_k, new_v, lengths):
    """Write the new token's K/V, then attend over the cache.

    q: (B, H, D); caches: (B, S, Hkv, D); new_k/v: (B, Hkv, D);
    lengths: (B,) tokens already in cache (new token goes at this index).
    """
    s = k_cache.shape[1]
    k_cache = _write_rows(k_cache, new_k, lengths, keep_outside=True)
    v_cache = _write_rows(v_cache, new_v, lengths, keep_outside=True)
    valid = torch.clamp(lengths + 1, 0, s)  # entries after the write
    out = _partial_softmax_attend(q, k_cache, v_cache, valid)
    return out, k_cache, v_cache


def _partial_softmax_attend(q, k_cache, v_cache, valid):
    """Grouped-head attention without expanding the cache's kv heads.

    q (B, H, D), caches (B, S, Hkv, D): contract per kv-head group with
    float32 sums, as the reference's ``preferred_element_type`` does; the
    probabilities meet v in the cache's dtype, as there."""
    b, h, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    g = h // hkv
    qg = q.reshape(b, hkv, g, d)
    kc = k_cache.to(qg.dtype)
    vc = v_cache.to(qg.dtype)
    logits = torch.einsum("bhgd,bkhd->bhgk", qg.to(torch.float32),
                          kc.to(torch.float32)) * (d ** -0.5)
    kpos = torch.arange(s, device=q.device)[None, None, None, :]
    logits = torch.where(kpos < valid[:, None, None, None], logits,
                         torch.full_like(logits, ref.MASKED))
    m = torch.amax(logits, dim=-1)                     # (B, Hkv, G)
    p = torch.exp(logits - m[..., None])
    denom = torch.sum(p, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p.to(vc.dtype).to(torch.float32),
                     vc.to(torch.float32))
    denom = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    out = (o / denom[..., None]).to(q.dtype)
    return out.reshape(b, h, d)


def decode_attention_block(cfg, x, lp, cache_k, cache_v, lengths, *,
                           window: int = 0):
    """One decode step through an attention block. x: (B, 1, D).

    Returns (out (B,1,D), cache_k, cache_v), the caches written in place.
    ``window>0`` means the cache is a ring buffer of that size (positions
    stored mod window).
    """
    q, k, v = qkv_proj(cfg, x, lp["wq"], lp["wk"], lp["wv"])
    pos = lengths[:, None]  # (B, 1) absolute position of the new token
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)
    q1, k1, v1 = q[:, 0], k[:, 0], v[:, 0]

    if window == 0:
        out, kc, vc = _local_decode(q1, cache_k, cache_v, k1, v1, lengths)
    else:
        out, kc, vc = _ring_decode(q1, cache_k, cache_v, k1, v1, lengths,
                                   window)
    return out_proj(out[:, None], lp["wo"]), kc, vc


def _ring_decode(q, cache_k, cache_v, new_k, new_v, lengths, window):
    """SWA/local decode: ring-buffer cache of size ``window``.

    All slots are valid once length >= window; before that only the first
    ``length+1`` slots are. Softmax is permutation-invariant so slot order
    doesn't matter (RoPE already applied at absolute positions). A slot
    past a cache shorter than the window (a prompt shorter than it) is
    clamped to the last row, as the reference's update clamps it.
    """
    slot = lengths % window
    valid = torch.clamp(lengths + 1, max=window)
    kc = _write_rows(cache_k, new_k, slot, keep_outside=False)
    vc = _write_rows(cache_v, new_v, slot, keep_outside=False)
    out = ref.decode_attention(q, kc, vc, valid)
    return out, kc, vc
