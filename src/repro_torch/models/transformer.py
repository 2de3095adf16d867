"""Dense GQA decoder LM: parameters, forward, prefill and decode.

Port of ``repro.models.transformer``. The parameters live
in a ``Transformer`` module (``models/params.py``) whose tensors keep the
JAX package's shapes, one ``nn.ParameterDict`` a layer (``wq`` (d, H,
hd), ``wo`` (H, hd, d), ...), so that ``convert.transformer_params`` is a
copy; a loop over the layers takes the place of ``lax.scan``. The
functions take the module where the reference takes its parameter
pytree.

Training: ``loss_fn`` and ``make_train_step`` as the reference's, with
``torch.autograd`` over the trainable leaves (the flash kernel's gradient
is a kernel too: ``kernels.flash_attention.FlashAttention``) and
``cfg.remat`` as ``torch.utils.checkpoint`` around each block
(``_remat``).

Sharding: every function takes the reference's ``ShardCtx`` (last,
``NULL_CTX`` by default) with its constraints at the reference's sites
(``seq_parallel``'s "batch seq_sp d_model", the microbatches, the
prefill cache), and ``param_logical`` / ``layer_param_logical`` /
``cache_logical`` give the reference's logical names (``cache_shapes``
returns the shapes alone; ``cache_logical`` is the reference's second
half). On a mesh the parameter module holds ``DTensor``s
(``params.distribute_params``) and the step updates each rank's blocks.
Not here yet: ``input_specs`` and ``roofline_units`` (the dry run,
ROADMAP.md).
"""
from __future__ import annotations

import functools
from typing import Dict

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.distributed.sharding import distribute, is_dtensor, plain
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    NULL_CTX,
    ShardCtx,
    dtype_of,
    embed_tokens,
    grad_in_place,
    lm_logits,
    pad_dim,
    position_ids,
    rms_norm,
    softmax_xent,
    swiglu_mlp,
)
from repro_torch.models.params import Params, count, get_param, init, param_leaves
from repro_torch.models.params import spec as _spec
from repro_torch.models.params import stack_layers, stacked

VISION_FEAT_DIM = 1024  # stub frontend feature width (llava patch embeddings)


# --------------------------------------------------------------------------- #
# parameter schema (dense)                                                     #
# --------------------------------------------------------------------------- #
def layer_param_shapes(cfg) -> Dict[str, torch.Tensor]:
    """Every layer's parameters, stacked over the layers as in the JAX
    package, as tensors on the meta device."""
    d, h, kv, hd, f = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    L = cfg.num_layers
    dt = dtype_of(cfg)
    return {
        "attn_norm": _spec((L, d), dt),
        "wq": _spec((L, d, h, hd), dt),
        "wk": _spec((L, d, kv, hd), dt),
        "wv": _spec((L, d, kv, hd), dt),
        "wo": _spec((L, h, hd, d), dt),
        "mlp_norm": _spec((L, d), dt),
        "w_gate": _spec((L, d, f), dt),
        "w_up": _spec((L, d, f), dt),
        "w_down": _spec((L, f, d), dt),
    }


PRODUCTION_MODEL_AXIS = 16  # the reference's production mesh's model axis


def layer_param_logical(cfg) -> Dict[str, str]:
    # Archs whose head count doesn't divide the model axis (arctic/llava 56,
    # whisper 12, smollm 9) would REPLICATE their attention projections —
    # GBs per chip at serve. Shard them on the feature dim instead
    # ("attn_dw": data at train [= FSDP, unchanged], model at serve).
    div = cfg.num_heads % PRODUCTION_MODEL_AXIS == 0
    adw = "d_model_w" if div else "attn_dw"
    return {
        "attn_norm": "layers .",
        "wq": f"layers {adw} heads .",
        "wk": f"layers {adw} kv_heads .",
        "wv": f"layers {adw} kv_heads .",
        "wo": f"layers heads . {adw}",
        "mlp_norm": "layers .",
        "w_gate": "layers d_model_w d_ff",
        "w_up": "layers d_model_w d_ff",
        "w_down": "layers d_ff d_model_w",
    }


def param_shapes(cfg) -> Dict:
    d, vp = cfg.d_model, cfg.vocab_padded
    dt = dtype_of(cfg)
    out = {
        "embed": _spec((vp, d), dt),
        "final_norm": _spec((d,), dt),
        "layers": layer_param_shapes(cfg),
    }
    if not cfg.tie_embeddings:
        out["out_head"] = _spec((d, vp), dt)
    if cfg.family == "vlm":
        out["vision_proj"] = _spec((VISION_FEAT_DIM, d), dt)
    return out


def param_logical(cfg) -> Dict:
    out = {
        "embed": "vocab d_model_w",
        "final_norm": ".",
        "layers": layer_param_logical(cfg),
    }
    if not cfg.tie_embeddings:
        out["out_head"] = "d_model_w vocab"
    if cfg.family == "vlm":
        out["vision_proj"] = ". d_model_w"
    return out


def param_count(cfg) -> int:
    return count(param_shapes(cfg))


def active_param_count(cfg) -> int:
    return param_count(cfg)


class Transformer(Params):
    """The dense (and vlm) decoder's parameters: ``embed``, ``final_norm``,
    ``out_head`` unless the embeddings are tied, ``vision_proj`` for a vlm,
    and ``layers``, one ``nn.ParameterDict`` a layer holding one layer's
    slice of each stacked tensor of ``layer_param_shapes``. Made empty;
    ``init_params`` and ``convert.transformer_params`` fill it."""

    def __init__(self, cfg, *, device="cuda"):
        super().__init__(cfg, param_shapes(cfg), device=device)

    def forward(self, batch):
        return forward(self.cfg, self, batch)


Model = Transformer  # the family's parameter module (convert.model_params)


def init_params(cfg, generator: torch.Generator, *, device="cuda") -> Transformer:
    """A ``Transformer`` drawn as the JAX package draws its parameters
    (``params.init``: the 1-d leaves zero)."""
    return init(Transformer(cfg, device=device), param_shapes(cfg),
                generator, fill=0.0, device=device)


# --------------------------------------------------------------------------- #
# forward                                                                      #
# --------------------------------------------------------------------------- #
def sp_constrain(cfg, h, ctx: ShardCtx):
    """Megatron-SP: with ``cfg.seq_parallel`` the inter-block activations
    shard SEQ over 'model'."""
    if getattr(cfg, "seq_parallel", False):
        return ctx.constrain(h, "batch seq_sp d_model")
    return h


def sp_gather(cfg, x, ctx: ShardCtx):
    """With ``cfg.seq_parallel``, a normed input (a block's, the final
    norm's) on whole sequences again before its matmuls: the gather the
    reference's partitioner puts there (DTensor on torch 2.11 cannot fold
    a batch- and sequence-sharded activation into a matmul's rows)."""
    if getattr(cfg, "seq_parallel", False):
        return ctx.constrain(x, "batch seq d_model")
    return x


def dense_block(cfg, lp, h, positions, ctx: ShardCtx = NULL_CTX):
    a_in = sp_gather(cfg, rms_norm(h, lp["attn_norm"], cfg.norm_eps), ctx)
    a_out, _ = attn.attention_train(cfg, a_in, lp, positions, ctx,
                                    window=cfg.sliding_window)
    h = sp_constrain(cfg, h + a_out, ctx)
    m_in = sp_gather(cfg, rms_norm(h, lp["mlp_norm"], cfg.norm_eps), ctx)
    h = h + swiglu_mlp(m_in, lp["w_gate"], lp["w_up"], lp["w_down"], ctx)
    return sp_constrain(cfg, h, ctx)


# the matrix products remat's "dots" policies keep: with and without batch
# dimensions (torch.matmul reaches mm for a product it can fold to 2-d, as
# the layers' projections; bmm keeps its batch dimension)
_DOTS_NO_BATCH = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_DOTS = _DOTS_NO_BATCH + (torch.ops.aten.bmm.default,
                          torch.ops.aten.baddbmm.default)


def _save_dots(dots: tuple):
    def policy(ctx, op, *args, **kwargs):
        if op in dots:
            return ckpt.CheckpointPolicy.MUST_SAVE
        return ckpt.CheckpointPolicy.PREFER_RECOMPUTE

    return functools.partial(ckpt.create_selective_checkpoint_contexts, policy)


def _remat(cfg, fn):
    """``fn`` recomputed in the backward pass, as the reference's
    ``jax.checkpoint``: ``cfg.remat_policy`` "nothing" saves nothing,
    "dots" the matrix products' results and "dots_no_batch" those without a
    batch dimension. The flash kernel's autograd function is recomputed
    under every policy."""
    if not cfg.remat:
        return fn
    name = getattr(cfg, "remat_policy", "nothing")
    kw = {}
    if name == "dots":
        kw["context_fn"] = _save_dots(_DOTS)
    elif name == "dots_no_batch":
        kw["context_fn"] = _save_dots(_DOTS_NO_BATCH)
    return functools.partial(ckpt.checkpoint, fn, use_reentrant=False, **kw)


def remat_where_grad(cfg, fn, h, params: torch.nn.Module):
    """``fn`` under ``_remat`` where a gradient is taken (grad mode on and
    ``h`` or a parameter of ``params`` requiring one), else as it is:
    serving runs the blocks as they are (its parameters need none, and
    inference mode takes none)."""
    if torch.is_grad_enabled() and (h.requires_grad or any(
            p.requires_grad for p in params.parameters())):
        return _remat(cfg, fn)
    return fn


def stack_forward(cfg, params: Transformer, h, positions,
                  ctx: ShardCtx = NULL_CTX, block_fn=dense_block):
    block = remat_where_grad(cfg, functools.partial(block_fn, cfg), h,
                             params.layers)
    for lp in params.layers:
        h = block(lp, h, positions, ctx)
    return h


def embed_input(cfg, params: Transformer, batch, ctx: ShardCtx = NULL_CTX):
    """Token (+ optional patch) embedding. Returns (h, positions)."""
    tokens = batch["tokens"]
    h = embed_tokens(tokens, params.embed, ctx)
    b, s = tokens.shape
    if cfg.family == "vlm":
        patches = batch["patches"].to(h.dtype)  # (B, P, VISION_FEAT_DIM)
        pe = torch.matmul(patches, params.vision_proj.to(h.dtype))
        pe = ctx.constrain(pe, "batch seq d_model")
        h = torch.cat([pe, h], dim=1)
        s = h.shape[1]
    return h, position_ids(b, s, h.device)


def head(cfg, params: Transformer) -> torch.Tensor:
    return (grad_in_place(params.embed).T if cfg.tie_embeddings
            else params.out_head)


def forward(cfg, params: Transformer, batch, ctx: ShardCtx = NULL_CTX,
            block_fn=dense_block):
    with ctx.scope():
        h, positions = embed_input(cfg, params, batch, ctx)
        h = stack_forward(cfg, params, h, positions, ctx, block_fn)
        h = sp_gather(cfg, rms_norm(h, params.final_norm, cfg.norm_eps), ctx)
        return lm_logits(h, head(cfg, params), cfg.vocab_size, ctx)


def loss_fn(cfg, params: Transformer, batch, ctx: ShardCtx = NULL_CTX,
            block_fn=dense_block):
    logits = forward(cfg, params, batch, ctx, block_fn)
    labels = batch["labels"]
    mask = batch.get("loss_mask")
    if cfg.family == "vlm":
        # image patch positions carry no next-token loss
        logits = logits[:, cfg.num_patches:]
    with ctx.scope():
        loss = softmax_xent(logits, labels, mask)
    return loss, {"loss": loss}


def make_train_step(cfg, optimizer, ctx: ShardCtx = NULL_CTX,
                    block_fn=dense_block, loss=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), the reference's step: ``params`` is the family's parameter
    module, updated in place (the reference donates its buffers) and
    returned; ``opt_state`` is ``optimizer.init`` of ``stacked(params)``;
    ``batch`` a dict of tensors on the parameters' device. Gradients come
    from ``torch.autograd`` over every leaf, with requires_grad turned on
    for the step only (serving keeps it off). ``cfg.grad_accum > 1``
    splits the batch on its leading dim into that many microbatches, sums
    their gradients in ``cfg.grad_accum_dtype``, divides by the count and
    averages the loss. The update is ``optimizer.update`` on the stacked
    leaves, then p <- (p + u) in p's dtype; metrics are ``loss`` and
    ``grad_norm``, plain tensors.

    On a mesh (``ctx``), the module's parameters and ``opt_state`` are
    ``DTensor``s and ``batch`` is placed with batch sharding; each
    gradient is brought to its parameter's placements before the update,
    which works on each rank's blocks."""
    from repro_torch.models.registry import family_module

    loss = loss or functools.partial(loss_fn, block_fn=block_fn)
    accum = max(1, getattr(cfg, "grad_accum", 1))
    acc_dt = getattr(torch, getattr(cfg, "grad_accum_dtype", "float32"))
    shapes = family_module(cfg.family).param_shapes(cfg)
    specs = dict(param_leaves(shapes))

    def _grad(params, leaves, batch):
        """(loss, metrics, grads): grads keyed as ``leaves``, a layer
        stack's stacked over the layers."""
        with torch.enable_grad(), ctx.scope():
            value, metrics = loss(cfg, params, batch, ctx)
            flat = [t for ts in leaves.values() for t in ts]
            grads = iter(torch.autograd.grad(value, flat))
            out = {}
            for name, ts in leaves.items():
                gs = [_like(next(grads), t) for t in ts]
                out[name] = (stack_layers(gs, specs[name], value.device)
                             if "." in name else gs[0])
        return plain(value.detach()), metrics, out

    def _micro(v):
        """(accum, B / accum, ...) microbatches, batch-sharded on a mesh
        (the reference's ". batch ..." constraint)."""
        if not is_dtensor(v):
            return v.reshape((accum, v.shape[0] // accum) + v.shape[1:])
        v = v.full_tensor()
        v = v.reshape((accum, v.shape[0] // accum) + v.shape[1:])
        return distribute(v, ". batch" + " ." * (v.dim() - 2), ctx.rules,
                          ctx.mesh)

    def train_step(params, opt_state, batch):
        # each leaf's tensors: a top-level leaf (no dot in its name) alone,
        # a layer stack's one a layer
        leaves = {}
        for name in specs:
            value = get_param(params, name)
            leaves[name] = value if "." in name else [value]
        for ts in leaves.values():
            for t in ts:
                t.requires_grad_(True)
        try:
            if accum <= 1:
                _, metrics, grads = _grad(params, leaves, batch)
            else:
                micro = {k: _micro(v) for k, v in batch.items()}
                gsum = lsum = None
                for i in range(accum):
                    value, _, g = _grad(params, leaves,
                                        {k: v[i] for k, v in micro.items()})
                    if gsum is None:
                        gsum = {n: torch.zeros_like(t, dtype=acc_dt)
                                for n, t in g.items()}
                        lsum = torch.zeros((), dtype=torch.float32,
                                           device=value.device)
                    gsum = {n: gsum[n] + g[n].to(acc_dt) for n in gsum}
                    lsum = lsum + value
                grads = {n: t / accum for n, t in gsum.items()}
                metrics = {"loss": lsum / accum}
        finally:
            for ts in leaves.values():
                for t in ts:
                    t.requires_grad_(False)
        values = stacked(params, shapes)
        updates, opt_state = optimizer.update(grads, opt_state, values)
        with torch.no_grad():
            for name, ts in leaves.items():
                new = (values[name] + updates[name]).to(values[name].dtype)
                for t, v in zip(ts, new if "." in name else [new]):
                    t.copy_(v)
        metrics = {k: plain(v.detach()) for k, v in metrics.items()}
        metrics["grad_norm"] = optimizer.global_norm(grads)
        return params, opt_state, metrics

    return train_step


def _like(g, t):
    """A parameter's gradient in the parameter's placements (autograd may
    leave a ``DTensor`` gradient partial or laid out otherwise)."""
    if is_dtensor(g) and tuple(g.placements) != tuple(t.placements):
        return g.redistribute(t.device_mesh, t.placements)
    return g


# --------------------------------------------------------------------------- #
# serving                                                                      #
# --------------------------------------------------------------------------- #
def cache_len(cfg, seq_len: int) -> int:
    if cfg.sliding_window:
        return min(cfg.sliding_window, seq_len)
    return seq_len


def cache_dtype_of(cfg) -> torch.dtype:
    """KV-cache storage dtype ("" = the model's)."""
    cd = getattr(cfg, "cache_dtype", "")
    return getattr(torch, cd) if cd else dtype_of(cfg)


def cache_shapes(cfg, batch: int, seq_len: int) -> Dict[str, torch.Tensor]:
    """The cache's tensors on the meta device (the reference's first half;
    ``cache_logical`` is its second)."""
    L, kv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    s = cache_len(cfg, seq_len)
    dt = cache_dtype_of(cfg)
    return {
        "k": _spec((L, batch, s, kv, hd), dt),
        "v": _spec((L, batch, s, kv, hd), dt),
        "lengths": _spec((batch,), torch.int32),
    }


def cache_logical(cfg) -> Dict[str, str]:
    """The logical dims of ``cache_shapes``' tensors (the second half of
    the reference's ``cache_shapes``)."""
    return {
        "k": "layers batch cache_seq kv_heads .",
        "v": "layers batch cache_seq kv_heads .",
        "lengths": "batch",
    }


def prefill(cfg, params: Transformer, batch, ctx: ShardCtx = NULL_CTX,
            pad_cache_to: int | None = None, mlp_fn=None):
    """Run the full prompt; returns (cache, last-position logits).

    ``pad_cache_to`` reserves decode headroom: the returned cache's seq dim
    is padded to that length (ring-buffer SWA caches are fixed-size and
    ignore it). ``mlp_fn`` as in ``decode_step``. On a mesh the cache comes
    back placed by ``cache_logical``."""
    with ctx.scope():
        return _prefill(cfg, params, batch, ctx, pad_cache_to, mlp_fn)


def _prefill(cfg, params, batch, ctx, pad_cache_to, mlp_fn):
    h, positions = embed_input(cfg, params, batch, ctx)
    w = cfg.sliding_window
    cdt = cache_dtype_of(cfg)
    ks, vs = [], []
    for lp in params.layers:
        a_in = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
        a_out, (k, v) = attn.attention_train(cfg, a_in, lp, positions, ctx,
                                             window=w)
        h = h + a_out
        m_in = rms_norm(h, lp["mlp_norm"], cfg.norm_eps)
        if mlp_fn is None:
            h = h + swiglu_mlp(m_in, lp["w_gate"], lp["w_up"], lp["w_down"],
                               ctx)
        else:
            h = h + mlp_fn(cfg, lp, m_in, ctx)
        if w:
            # ring-buffer layout: slot = position % window
            s = k.shape[1]
            keep = min(w, s)
            shift = s % w if s >= w else 0
            k = torch.roll(k[:, -keep:], shift, dims=1)
            v = torch.roll(v[:, -keep:], shift, dims=1)
        ks.append(ctx.constrain(k.to(cdt), "batch cache_seq kv_heads ."))
        vs.append(ctx.constrain(v.to(cdt), "batch cache_seq kv_heads ."))
    h = rms_norm(h, params.final_norm, cfg.norm_eps)
    logits = lm_logits(h[:, -1:], head(cfg, params), cfg.vocab_size,
                       ctx)[:, 0]
    b, s = h.shape[0], h.shape[1]
    ks, vs = torch.stack(ks), torch.stack(vs)
    if pad_cache_to is not None and not w and pad_cache_to > ks.shape[2]:
        pad = pad_cache_to - ks.shape[2]
        ks = pad_dim(ks, 2, after=pad)
        vs = pad_dim(vs, 2, after=pad)
    logical = cache_logical(cfg)
    cache = {
        "k": ctx.constrain(ks, logical["k"]),
        "v": ctx.constrain(vs, logical["v"]),
        "lengths": torch.full((b,), s, dtype=torch.int32, device=h.device),
    }
    return cache, logits


def decode_step(cfg, params: Transformer, cache, batch,
                ctx: ShardCtx = NULL_CTX, mlp_fn=None):
    """One token for every sequence. batch: {"token": (B,) int32}.

    Writes the new token's K/V into ``cache["k"]`` and ``cache["v"]`` in
    place and returns them with the lengths advanced by one. ``mlp_fn(cfg,
    lp, m_in, ctx)``, if given, takes the SwiGLU MLP's place (the moe
    family's FFN)."""
    with ctx.scope():
        token = batch["token"]
        h = embed_tokens(token[:, None], params.embed, ctx)  # (B, 1, D)
        lengths = cache["lengths"]
        w = cfg.sliding_window
        for lp, ck, cv in zip(params.layers, cache["k"], cache["v"]):
            a_in = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
            a_out, _, _ = attn.decode_attention_block(cfg, a_in, lp, ck, cv,
                                                      lengths, ctx, window=w)
            h = h + a_out
            m_in = rms_norm(h, lp["mlp_norm"], cfg.norm_eps)
            if mlp_fn is None:
                h = h + swiglu_mlp(m_in, lp["w_gate"], lp["w_up"],
                                   lp["w_down"], ctx)
            else:
                h = h + mlp_fn(cfg, lp, m_in, ctx)
        h = rms_norm(h, params.final_norm, cfg.norm_eps)
        logits = lm_logits(h, head(cfg, params), cfg.vocab_size, ctx)[:, 0]
    new_cache = {"k": cache["k"], "v": cache["v"], "lengths": lengths + 1}
    return new_cache, logits
