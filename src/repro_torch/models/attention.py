"""GQA attention: training/prefill through the flash kernel, and decode.

Port of ``repro.models.attention``: the projections, the full-sequence
attention, the encoder-decoder's cross-attention and decode, each with
the reference's ``ShardCtx`` constraints. On a mesh the kernel's wrapper
gets each rank's blocks as plain tensors (``ShardCtx.local``): batch over
the batch axes and heads over "model" where the kv heads divide it (else
every head on every rank of "model", so each query head finds its kv
head). Decode keeps the reference's design for a 32k cache: with
"model" > 1 the cache's SEQUENCE dim is sharded over it, each shard
computes partial softmax stats (m, l, o) over its rows
(``_local_decode`` with ``seq_per_shard`` and ``axis``), and a max and
two sums across "model" combine them — exact flash-decode across shards
(``decode_attention_seqsharded``; the reference's ``shard_map`` and
``psum``, here ``sharding.local_call`` and functional collectives).

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
(the JAX package donates its cache buffers to the same end); on a mesh,
into each rank's block.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.distributed.sharding import all_reduce, axis_index, is_dtensor
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention_bshd
from repro_torch.models.layers import NULL_CTX, ShardCtx, rope


def _head_product(x, w):  # "bsd,dhk->bshk"
    return torch.matmul(x, w.to(x.dtype).flatten(1)).unflatten(-1, w.shape[1:])


def head_proj(x, w, logical: str, ctx: ShardCtx = NULL_CTX):
    """x (B, S, D) times a (D, H, hd) weight -> (B, S, H, hd), placed by
    ``logical``. Where the mesh leaves the heads unsplit (a model axis that
    does not divide them), the flat product and its weight's gradient may
    come out split off the heads' boundaries, which no view can unflatten:
    each rank then projects its rows with the whole weight (gathered, as
    the reference's partitioner gathers it)."""
    if ctx.mesh is not None:
        places = ctx.places((*x.shape[:2], *w.shape[1:]), logical)
        if not any(p.is_shard(2) for p in places):
            return ctx.local(_head_product, (x, w),
                             ("batch seq d_model", ". . ."), (places,))
    return ctx.constrain(_head_product(x, w), logical)


def qkv_proj(cfg, x, wq, wk, wv, ctx: ShardCtx = NULL_CTX):
    q = head_proj(x, wq, "batch seq heads .", ctx)
    k = head_proj(x, wk, "batch seq kv_heads .", ctx)
    v = head_proj(x, wv, "batch seq kv_heads .", ctx)
    return q, k, v


def _out_product(x, wo):  # "bshk,hkd->bsd"
    return torch.matmul(x.flatten(2), wo.to(x.dtype).flatten(0, 1))


def out_proj(x, wo, ctx: ShardCtx = NULL_CTX):
    if ctx.mesh is not None and not any(
            p.is_shard(2) for p in ctx.places(x.shape, "batch seq heads .")):
        # heads the model axis does not divide: as in ``head_proj``, the
        # flat product's gradient may come back split off the heads'
        # boundaries, so each rank projects its rows with the whole weight
        return ctx.local(_out_product, (x, wo), ("batch seq . .", ". . ."),
                         (ctx.places((*x.shape[:2], wo.shape[-1]),
                                     "batch seq d_model"),))
    out = ctx.constrain(_out_product(x, wo), "batch seq d_sharded")
    return ctx.constrain(out, "batch seq d_model")


def flash(q, k, v, ctx: ShardCtx = NULL_CTX, **kw):
    """``flash_attention_bshd`` on each rank's blocks: batch over the
    batch axes, heads over "model" where the kv heads divide it, else
    every head (the reference's partitioner gathers them the same way)."""
    heads = ("heads", "kv_heads")
    if ctx.mesh is not None and ctx.places(k.shape, "batch seq kv_heads .") \
            == ctx.places(k.shape, "batch seq . ."):
        heads = (".", ".")
    lq, lk = (f"batch seq {h} ." for h in heads)
    return ctx.local(functools.partial(flash_attention_bshd, **kw),
                     (q, k, v), (lq, lk, lk), (0,))


def attention_train(cfg, x, lp, positions, ctx: ShardCtx = NULL_CTX, *,
                    window: int = 0, causal: bool = True):
    """Full training/prefill attention. lp: a layer's parameters with
    wq/wk/wv/wo."""
    q, k, v = qkv_proj(cfg, x, lp["wq"], lp["wk"], lp["wv"], ctx)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    o = flash(q, k, v, ctx, causal=causal, window=window)
    return out_proj(o, lp["wo"], ctx), (k, v)


def cross_attention(cfg, x, lp, k, v, ctx: ShardCtx = NULL_CTX):
    """Decoder cross-attention over precomputed encoder K/V (no mask).
    x (B, S, D); k, v (B, F, Hkv, D)."""
    q = head_proj(x, lp["xwq"], "batch seq heads .", ctx)
    o = flash(q, k, v, ctx, causal=False)
    return out_proj(o, lp["xwo"], ctx)


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


def _local_decode(q, k_cache, v_cache, new_k, new_v, lengths, *,
                  seq_per_shard=None, axis=None, mesh=None):
    """Body run per model-shard: write the new token's K/V into the local
    cache rows, then partial attention over them.

    q: (B, H, D); caches: (B, S_loc, Hkv, D); new_k/v: (B, Hkv, D);
    lengths: (B,) tokens already in cache (new token goes at this index).
    ``axis``: the mesh axis the cache's rows are split over (None: the
    whole cache is here), its shards ``seq_per_shard`` rows each.
    """
    sl = k_cache.shape[1] if seq_per_shard is None else seq_per_shard
    offset = axis_index(mesh, axis) * sl if axis else 0
    local_idx = lengths - offset  # (B,) position of the new token locally
    k_cache = _write_rows(k_cache, new_k, local_idx, keep_outside=True)
    v_cache = _write_rows(v_cache, new_v, local_idx, keep_outside=True)
    # valid entries in THIS shard after the write
    local_len = torch.clamp(lengths + 1 - offset, 0, sl)
    out = _partial_softmax_attend(q, k_cache, v_cache, local_len, axis, mesh)
    return out, k_cache, v_cache


def _partial_softmax_attend(q, k_cache, v_cache, valid, axis=None,
                            mesh=None):
    """Grouped-head attention without expanding the cache's kv heads.

    q (B, H, D), caches (B, S, Hkv, D): contract per kv-head group with
    float32 sums, as the reference's ``preferred_element_type`` does; the
    probabilities meet v in the cache's dtype, as there. With ``axis``,
    each shard's (max, sum, output) are combined across it."""
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
    if axis:
        g_m = all_reduce(m, "max", mesh, axis)
        scale = torch.exp(m - g_m)
        denom = all_reduce(denom * scale, "sum", mesh, axis)
        o = all_reduce(o * scale[..., None], "sum", mesh, axis)
    denom = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    out = (o / denom[..., None]).to(q.dtype)
    return out.reshape(b, h, d)


def _batch_spec(mesh, batch: int):
    """Batch-dim spec: ('pod','data') when divisible, else the largest
    prefix that divides, else replicated (the long_500k batch=1 case)."""
    ba = tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
    sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    kept = []
    denom = 1
    for a in ba:
        if batch % (denom * sizes[a]) == 0:
            kept.append(a)
            denom *= sizes[a]
    if not kept:
        return None
    return tuple(kept) if len(kept) > 1 else kept[0]


def _decode_specs(ctx, batch: int, seq_axis):
    """(q, cache, new K/V, lengths) specs of a decode body's args."""
    bspec = _batch_spec(ctx.mesh, batch)
    return ((bspec, None, None), (bspec, seq_axis, None, None),
            (bspec, None, None), (bspec,))


def decode_attention_seqsharded(cfg, q, k_cache, v_cache, new_k, new_v,
                                lengths, ctx: ShardCtx = NULL_CTX):
    """q (B,H,D), caches (B,S,Hkv,D) with S sharded over 'model'."""
    model_size = ctx.axis_size("model")
    args = (q, k_cache, v_cache, new_k, new_v, lengths)
    if ctx.mesh is None or model_size <= 1:
        fn, seq_axis = _local_decode, None
    else:
        s = k_cache.shape[1]
        assert s % model_size == 0, (s, model_size)
        fn = functools.partial(_local_decode, seq_per_shard=s // model_size,
                               axis="model", mesh=ctx.mesh)
        seq_axis = "model"
    if ctx.mesh is None:
        return fn(*args)
    qs, cs, ks, ls = _decode_specs(ctx, q.shape[0], seq_axis)
    return ctx.local(fn, args, (qs, cs, cs, ks, ks, ls), (0, 1, 2))


def decode_attention_block(cfg, x, lp, cache_k, cache_v, lengths,
                           ctx: ShardCtx = NULL_CTX, *, window: int = 0):
    """One decode step through an attention block. x: (B, 1, D).

    Returns (out (B,1,D), cache_k, cache_v), the caches written in place
    (on a mesh: each rank's blocks of them). ``window>0`` means the cache
    is a ring buffer of that size (positions stored mod window).
    """
    q, k, v = qkv_proj(cfg, x, lp["wq"], lp["wk"], lp["wv"], ctx)
    pos = lengths[:, None]  # (B, 1) absolute position of the new token
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)
    q1, k1, v1 = q[:, 0], k[:, 0], v[:, 0]

    if window == 0:
        out, kc, vc = decode_attention_seqsharded(
            cfg, q1, cache_k, cache_v, k1, v1, lengths, ctx)
    else:
        out, kc, vc = _ring_decode(q1, cache_k, cache_v, k1, v1, lengths,
                                   window, ctx)
    kc, vc = _into(cache_k, kc), _into(cache_v, vc)
    return out_proj(out[:, None], lp["wo"], ctx), kc, vc


def _into(cache, new):
    """``cache`` holding ``new``: the same tensor when the body wrote its
    rows in place, else ``new`` copied in (a cache the body took in
    another layout)."""
    if new is cache:
        return cache
    if is_dtensor(new):
        new = (new.redistribute(cache.device_mesh, cache.placements)
               if is_dtensor(cache) else new.full_tensor())
    with torch.no_grad():
        cache.copy_(new)
    return cache


def _ring_local(q, cache_k, cache_v, new_k, new_v, lengths, *, window):
    slot = lengths % window
    valid = torch.clamp(lengths + 1, max=window)
    kc = _write_rows(cache_k, new_k, slot, keep_outside=False)
    vc = _write_rows(cache_v, new_v, slot, keep_outside=False)
    out = ref.decode_attention(q, kc, vc, valid)
    return out, kc, vc


def _ring_sharded(q, kc, vc, nk, nv, lengths, *, window, mesh):
    """The ring buffer's rows split over "model": each shard writes the
    new row if it owns its slot, then partial attention combined across
    the shards."""
    sl = kc.shape[1]
    offset = axis_index(mesh, "model") * sl
    li = lengths % window - offset
    kc = _write_rows(kc, nk, li, keep_outside=True)
    vc = _write_rows(vc, nv, li, keep_outside=True)
    valid = torch.clamp(lengths + 1, max=window)
    local_valid = torch.clamp(valid - offset, 0, sl)
    out = _partial_softmax_attend(q, kc, vc, local_valid, "model", mesh)
    return out, kc, vc


def _ring_decode(q, cache_k, cache_v, new_k, new_v, lengths, window,
                 ctx: ShardCtx = NULL_CTX):
    """SWA/local decode: ring-buffer cache of size ``window``.

    All slots are valid once length >= window; before that only the first
    ``length+1`` slots are. Softmax is permutation-invariant so slot order
    doesn't matter (RoPE already applied at absolute positions). A slot
    past a cache shorter than the window (a prompt shorter than it) is
    clamped to the last row, as the reference's update clamps it. With
    "model" > 1 dividing the window, the ring's rows are split over it
    (the reference's sharded branch).
    """
    model_size = ctx.axis_size("model")
    args = (q, cache_k, cache_v, new_k, new_v, lengths)
    if ctx.mesh is None or model_size <= 1 or window % model_size != 0:
        fn, seq_axis = functools.partial(_ring_local, window=window), None
    else:
        fn = functools.partial(_ring_sharded, window=window, mesh=ctx.mesh)
        seq_axis = "model"
    if ctx.mesh is None:
        return fn(*args)
    qs, cs, ks, ls = _decode_specs(ctx, q.shape[0], seq_axis)
    return ctx.local(fn, args, (qs, cs, cs, ks, ks, ls), (0, 1, 2))
