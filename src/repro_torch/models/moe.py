"""MoE decoder family (arctic-480b, grok-1-314b).

Port of ``repro.models.moe``. With no mesh ``moe_ffn`` runs
``_moe_local`` with ``axis=None`` and ``ep=False`` (every expert local,
no psum). On a mesh it keeps the reference's two ``shard_map`` branches
as ``ShardCtx.local`` calls (each rank's blocks as plain tensors, a sum
across ranks by functional collectives): activations replicated over
"model", experts sharded over it where they divide it (EP: each shard
owns E/model experts) or else d_ff (TP: each shard computes every expert
on its f-slice), one sum over "model"; and with ``moe_serve_ep2d`` the
resident-expert layout, experts over "data" and d_ff over "model", the
tokens replicated, one sum over both. Capacity comes from the tokens of
one data shard, as there. A mesh whose "model" axis is 1 runs the
function on every token, replicated. The router kernel runs inside on
each rank's tokens. The aux loss of a data-sharded call is each rank's
own (the reference's ``P()`` out-spec with its replication check off
takes one device's value). The parameters live in a
``MoE`` module (``models/params.py``), one ``nn.ParameterDict`` a layer
holding the dense decoder's attention leaves, the router and the stacked
experts (``e_gate``/``e_up`` (E, d, f), ``e_down`` (E, f, d)), and the
dense MLP only where ``moe_dense_residual`` keeps it (arctic); a loop
over the layers takes the place of ``lax.scan``.

Routing goes through the router kernel's wrapper
(``kernels.moe_router.moe_router_tk``, one launch a layer, counted by
``moe_router.launches``): on the card it launches the hand-written
kernel, on the CPU its plain version. The reference's model calls the
plain math (``kref.moe_topk_router``); both take a softmax, then k rounds
of argmax with the lowest index winning a tie, then renormalise. Every
other operation is the reference's, in its order and with its casts: a
stable sort ranks each assignment within its expert, the first
``capacity`` of each expert keep their slot, the rest go to a sentinel
slot that is cut off, empty slots read a zero token row, the experts'
products are batched matrix products (outside any kernel in the
reference too), and a scatter-add sums each token's k contributions in
the model's dtype (order-free for the two a token has here).

``init_params`` draws as the reference does (trunc-normal with std 0.02
for leaves of two or more dimensions, zero for the rest), but a layer at
a time and an expert leaf an expert at a time: drawing a whole stacked
expert leaf in float32 first would need 38.7 GB for grok-1's ``e_gate``
at 6 layers. The numbers are torch's, not ``jax.random``'s.

``param_logical`` and ``layer_param_logical`` are the reference's
(``moe_serve_ep2d`` picks the resident-expert layout). ``loss_fn`` is
the task loss plus ``AUX_LOSS_COEF`` times the aux loss, as the
reference's; training runs each layer under ``tf.remat_where_grad``, and
the router's gradient is the router kernel's
(``kernels.moe_router.RouterTopK``). The aux loss carries a gradient
through torch's softmax of the logits, its expert counts none. On a mesh
the sum over "model" (and "data" for ep2d) passes its cotangent through,
and the aux loss's is divided by the mesh's size
(``sharding.sum_across``, ``sharding.per_rank``), as the reference's
``shard_map`` transpose makes them. ``input_specs`` and
``roofline_units`` are the dense decoder's.
"""
from __future__ import annotations

import functools
import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import axis_index, per_rank, sum_across
from repro_torch.kernels import ref
from repro_torch.kernels.moe_router import moe_router_tk
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tf
from repro_torch.models.layers import (
    NULL_CTX,
    ShardCtx,
    dtype_of,
    lm_logits,
    rms_norm,
    softmax_xent,
    swiglu_mlp,
    trunc_normal,
)
from repro_torch.models.params import Params, count, param_leaves
from repro_torch.models.params import spec as _spec

AUX_LOSS_COEF = 0.01   # the reference's weight of the aux loss in its loss

EXPERT_LEAVES = ("e_gate", "e_up", "e_down")
DENSE_MLP = ("w_gate", "w_up", "w_down")


# --------------------------------------------------------------------------- #
# parameters                                                                   #
# --------------------------------------------------------------------------- #
def layer_param_shapes(cfg) -> Dict[str, torch.Tensor]:
    shapes = tf.layer_param_shapes(cfg)
    L, d, f, e = cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.num_experts
    dt = dtype_of(cfg)
    shapes.update({
        "router": _spec((L, d, e), dt),
        "e_gate": _spec((L, e, d, f), dt),
        "e_up": _spec((L, e, d, f), dt),
        "e_down": _spec((L, e, f, d), dt),
    })
    if not cfg.moe_dense_residual:
        # pure-MoE layers have no dense MLP
        for k in DENSE_MLP:
            shapes.pop(k)
    return shapes


def layer_param_logical(cfg) -> Dict[str, str]:
    logical = tf.layer_param_logical(cfg)
    if getattr(cfg, "moe_serve_ep2d", False):
        # resident-expert serving layout: experts over 'data', d_ff over
        # 'model' — matches the ep2d local call's placements exactly
        logical.update({
            "router": "layers d_model_w .",
            "e_gate": "layers experts_data . d_ff",
            "e_up": "layers experts_data . d_ff",
            "e_down": "layers experts_data d_ff .",
        })
    else:
        logical.update({
            # expert_dw shards over "data" in BOTH train (FSDP) and serve
            # rules: 480B of experts cannot be data-replicated at serve
            "router": "layers d_model_w .",
            "e_gate": "layers experts expert_dw d_ff",
            "e_up": "layers experts expert_dw d_ff",
            "e_down": "layers experts d_ff expert_dw",
        })
    if not cfg.moe_dense_residual:
        for k in DENSE_MLP:
            logical.pop(k)
    return logical


def param_shapes(cfg) -> Dict:
    out = tf.param_shapes(cfg)
    out["layers"] = layer_param_shapes(cfg)
    return out


def param_logical(cfg) -> Dict:
    out = tf.param_logical(cfg)
    out["layers"] = layer_param_logical(cfg)
    return out


def param_count(cfg) -> int:
    return count(param_shapes(cfg))


def active_param_count(cfg) -> int:
    """6*N_active*D accounting: experts count k/E of their params."""
    L, e, d, f = cfg.num_layers, cfg.num_experts, cfg.d_model, cfg.d_ff
    expert_params = L * e * 3 * d * f
    active_expert = L * cfg.num_experts_per_tok * 3 * d * f
    return param_count(cfg) - expert_params + active_expert


class MoE(Params):
    """The MoE decoder's parameters: ``embed``, ``final_norm``,
    ``out_head`` unless the embeddings are tied, and ``layers``, one
    ``nn.ParameterDict`` a layer. Made empty; ``init_params`` and
    ``convert.model_params`` fill it."""

    def __init__(self, cfg, *, device="cuda"):
        super().__init__(cfg, param_shapes(cfg), device=device)

    def forward(self, batch):
        return forward(self.cfg, self, batch)


Model = MoE  # the family's parameter module (convert.model_params)


def init_params(cfg, generator: torch.Generator, *, device="cuda") -> MoE:
    """A ``MoE`` drawn as the JAX package draws its parameters: every leaf
    of two or more dimensions in the stacked layout from a normal
    truncated at ±2 with std 0.02, the rest zero. The top-level leaves are
    drawn first, then the layers in order, each layer's leaves by name and
    an expert leaf an expert at a time, each piece in float32 and then
    cast: no whole stacked leaf exists in float32, and a model cut to
    fewer layers holds the first layers' draws of a deeper one.
    ``generator`` (seeded by the caller) lives on ``device``."""
    model = MoE(cfg, device=device)

    def draw(piece):
        piece.copy_(trunc_normal(generator, piece.shape, 0.02, piece.dtype,
                                 device))

    with torch.no_grad():
        for name, s in param_leaves(param_shapes(cfg)):
            if name.startswith("layers."):
                continue
            if len(s.shape) < 2:
                getattr(model, name).zero_()
            else:
                draw(getattr(model, name))
        for layer in model.layers:   # every stacked leaf has >= 2 dims
            for key in sorted(layer.keys()):
                for piece in (layer[key] if key in EXPERT_LEAVES
                              else [layer[key]]):
                    draw(piece)
    return model


# --------------------------------------------------------------------------- #
# MoE FFN                                                                      #
# --------------------------------------------------------------------------- #
def _capacity(cfg, tokens: int) -> int:
    c = math.ceil(cfg.num_experts_per_tok * tokens / cfg.num_experts
                  * cfg.capacity_factor)
    return max(8, ((c + 7) // 8) * 8)


def _counts(flat_e: torch.Tensor, e: int) -> torch.Tensor:
    """Assignments an expert (integer adds: exact in any order; unlike
    ``torch.bincount``, no wait for the card to size the output)."""
    return torch.zeros(e, dtype=torch.int64, device=flat_e.device).index_add_(
        0, flat_e, torch.ones_like(flat_e))


def aux_loss(logits: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The switch-style load-balance aux of (T, E) float32 logits and
    their (T, k) experts: E * sum(mean_prob_e * frac_assignments_e)."""
    e = logits.shape[1]
    me = ref.softmax(logits).mean(dim=0)
    ce = _counts(idx.reshape(-1).to(torch.int64), e).to(
        torch.float32) / idx.numel()
    return e * torch.sum(me * ce)


def dispatch(idx: torch.Tensor, weights: torch.Tensor, num_experts: int,
             capacity: int):
    """The slots of the (T, k) routing, as the reference's ``_moe_local``
    fills them: (tok (E, C) int64, each slot's token or T for an empty
    slot; w (E, C) float32, its weight). Each expert keeps its first
    ``capacity`` assignments in (token, k) order; the rest are dropped."""
    t, k = idx.shape
    e, dev = num_experts, idx.device
    flat_e = idx.reshape(-1).to(torch.int64)                 # (T*k,)
    flat_t = torch.arange(t, device=dev).repeat_interleave(k)
    flat_w = weights.to(torch.float32).reshape(-1)
    # rank of each assignment within its expert (stable: token order)
    counts = _counts(flat_e, e)
    starts = torch.cumsum(counts, 0) - counts
    order = torch.sort(flat_e, stable=True).indices
    rank_sorted = torch.arange(t * k, device=dev) - starts[flat_e[order]]
    rank = torch.empty_like(rank_sorted).index_put_((order,), rank_sorted)

    keep = rank < capacity
    slot = torch.where(keep, flat_e * capacity + rank, e * capacity)
    tok = torch.full((e * capacity + 1,), t, dtype=torch.int64, device=dev)
    w = torch.zeros((e * capacity + 1,), dtype=torch.float32, device=dev)
    tok.index_put_((slot,), flat_t)
    w.index_put_((slot,), flat_w)
    return (tok[: e * capacity].reshape(e, capacity),
            w[: e * capacity].reshape(e, capacity))


def _moe_local(x, router_w, wg, wu, wd, *, cfg, capacity, axis=None,
               ep: bool = False, expert_axis=None, mesh=None):
    """Per-shard MoE computation. x: (B_loc, S, D) replicated over
    ``axis`` -> ((B_loc, S, D), aux).

    ``axis``: the mesh axis (or axes) the partial outputs are summed over
    (None: every expert and the whole d_ff here, no sum). With ``ep`` this
    shard holds a block of ``wg.shape[0]`` experts, the one at its
    coordinate along ``expert_axis`` (default ``axis``)."""
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    logits = (xf @ router_w.to(xf.dtype)).to(torch.float32)   # (T, E)
    weights, idx = moe_router_tk(logits, cfg.num_experts_per_tok)
    aux = aux_loss(logits, idx)
    tok, w = dispatch(idx, weights, cfg.num_experts, capacity)
    e_loc = wg.shape[0]
    if ep and axis is not None:   # local expert slice
        e0 = axis_index(mesh, expert_axis or axis) * e_loc
        tok, w = tok[e0:e0 + e_loc], w[e0:e0 + e_loc]

    xpad = torch.cat([xf, torch.zeros((1, d), dtype=xf.dtype,
                                      device=xf.device)])
    xe = xpad[tok]                                            # (E, C, D)
    g = torch.bmm(xe, wg.to(xe.dtype))
    u = torch.bmm(xe, wu.to(xe.dtype))
    h = F.silu(g.to(torch.float32)).to(xe.dtype) * u
    ye = torch.bmm(h, wd.to(xe.dtype))
    ye = ye * w[..., None].to(ye.dtype)

    y = torch.zeros((t + 1, d), dtype=ye.dtype, device=ye.device).index_add_(
        0, tok.reshape(-1), ye.reshape(-1, d))[:t]
    if axis is not None:
        y = sum_across(y, mesh, axis)
        aux = per_rank(aux, mesh)
    return y.reshape(b, s, d), aux


def moe_ffn(cfg, lp, x, ctx: ShardCtx = NULL_CTX):
    """(B, S, D) -> ((B, S, D), aux_loss)."""
    e = cfg.num_experts
    model_size = ctx.axis_size("model")
    # capacity from the PER-DATA-SHARD token count (what each shard routes)
    dp = 1
    if ctx.mesh is not None:
        for a in ("pod", "data"):
            dp *= ctx.axis_size(a)
    b, s, _ = x.shape
    local_tokens = max(1, (b // max(dp, 1)) * s) if b >= dp else b * s
    capacity = _capacity(cfg, local_tokens)
    args = (x, lp["router"], lp["e_gate"], lp["e_up"], lp["e_down"])
    fn = functools.partial(_moe_local, cfg=cfg, mesh=ctx.mesh)

    if ctx.mesh is None or model_size <= 1:
        fn = functools.partial(fn, capacity=capacity)
        if ctx.mesh is None:
            return fn(*args)
        rep = (None, None, None)   # every token and expert on every rank
        return ctx.local(fn, args, (rep, rep[:2], rep, rep, rep),
                         (0, ctx.places((), "")))

    scalar = ctx.places((), "")
    rs = (None, None)
    # resident-expert 2D EP for small-token steps: experts over 'data',
    # d_ff over 'model', tokens replicated; one sum over both axes
    data_size = ctx.axis_size("data")
    if (getattr(cfg, "moe_serve_ep2d", False) and data_size > 1
            and e % data_size == 0 and b * s <= 4096):
        fn = functools.partial(fn, capacity=_capacity(cfg, b * s),
                               axis=("data", "model"), ep=True,
                               expert_axis="data")
        y, aux = ctx.local(
            fn, args,
            ((None, None, None), rs, ("data", None, "model"),
             ("data", None, "model"), ("data", "model", None)),
            (0, scalar))
        return ctx.constrain(y, "batch seq d_model"), aux

    ep = e % model_size == 0
    ba = tuple(a for a in ("pod", "data") if a in ctx.mesh.mesh_dim_names)
    bspec = ba if len(ba) > 1 else (ba[0] if ba else None)
    if ep:
        ws_gu = ws_d = ("model", None, None)
    else:
        ws_gu, ws_d = (None, None, "model"), (None, "model", None)
    fn = functools.partial(fn, capacity=capacity, axis="model", ep=ep)
    return ctx.local(fn, args, ((bspec, None, None), rs, ws_gu, ws_gu, ws_d),
                     (0, scalar))


def _moe_mlp_fn(cfg, lp, m_in, ctx: ShardCtx = NULL_CTX):
    y, _aux = moe_ffn(cfg, lp, m_in, ctx)
    if cfg.moe_dense_residual:
        y = y + swiglu_mlp(m_in, lp["w_gate"], lp["w_up"], lp["w_down"], ctx)
    return y


# --------------------------------------------------------------------------- #
# blocks / steps                                                               #
# --------------------------------------------------------------------------- #
def moe_block(cfg, lp, h, positions, ctx: ShardCtx = NULL_CTX):
    """One layer: ((B, S, D), its aux loss)."""
    a_in = tf.sp_gather(cfg, rms_norm(h, lp["attn_norm"], cfg.norm_eps), ctx)
    a_out, _ = attn.attention_train(cfg, a_in, lp, positions, ctx,
                                    window=cfg.sliding_window)
    h = tf.sp_constrain(cfg, h + a_out, ctx)
    m_in = tf.sp_gather(cfg, rms_norm(h, lp["mlp_norm"], cfg.norm_eps), ctx)
    y, aux = moe_ffn(cfg, lp, m_in, ctx)
    if cfg.moe_dense_residual:
        y = y + swiglu_mlp(m_in, lp["w_gate"], lp["w_up"], lp["w_down"], ctx)
    return tf.sp_constrain(cfg, h + y, ctx), aux


def forward(cfg, params: MoE, batch, ctx: ShardCtx = NULL_CTX):
    """(logits (B, S, V_padded), the layers' aux losses summed)."""
    with ctx.scope():
        h, positions = tf.embed_input(cfg, params, batch, ctx)
        aux_sum = torch.zeros((), dtype=torch.float32, device=h.device)
        block = tf.remat_where_grad(cfg, functools.partial(moe_block, cfg), h,
                                    params.layers)
        for lp in params.layers:
            h, aux = block(lp, h, positions, ctx)
            aux_sum = aux_sum + aux
        h = tf.sp_gather(cfg, rms_norm(h, params.final_norm, cfg.norm_eps),
                         ctx)
        return (lm_logits(h, tf.head(cfg, params), cfg.vocab_size, ctx),
                aux_sum)


def loss_fn(cfg, params: MoE, batch, ctx: ShardCtx = NULL_CTX):
    """(task + AUX_LOSS_COEF * aux, {"loss": task, "aux_loss": aux})."""
    logits, aux = forward(cfg, params, batch, ctx)
    with ctx.scope():
        task = softmax_xent(logits, batch["labels"], batch.get("loss_mask"))
        loss = task + AUX_LOSS_COEF * aux
    return loss, {"loss": task, "aux_loss": aux}


def make_train_step(cfg, optimizer, ctx: ShardCtx = NULL_CTX):
    return tf.make_train_step(cfg, optimizer, ctx, loss=loss_fn)


cache_shapes = tf.cache_shapes
cache_logical = tf.cache_logical
input_specs = tf.input_specs
roofline_units = tf.roofline_units


def prefill(cfg, params: MoE, batch, ctx: ShardCtx = NULL_CTX,
            pad_cache_to: int | None = None):
    """Run the full prompt through the dense decoder's prefill with the MoE
    FFN as its MLP; returns (cache, last-position logits). No moe config
    sets a window or a cache dtype, so the cache keeps K/V in the model's
    dtype as the layers made them, as the reference's does."""
    return tf.prefill(cfg, params, batch, ctx, pad_cache_to,
                      mlp_fn=_moe_mlp_fn)


def decode_step(cfg, params: MoE, cache, batch, ctx: ShardCtx = NULL_CTX):
    """One token for every sequence through the dense decoder's step with
    the MoE FFN as its MLP (capacity from the B tokens of the step)."""
    return tf.decode_step(cfg, params, cache, batch, ctx, mlp_fn=_moe_mlp_fn)
