"""Hybrid family (recurrentgemma-9b): Griffin-style RG-LRU + local attention.

Port of ``repro.models.hybrid``. Block pattern = (rglru,
rglru, local-attn) repeated; remainder layers are rglru. The parameters
live in a ``Hybrid`` module (``models/params.py``): ``groups``, one
``nn.ModuleDict`` of (rg1, rg2, attn) layers a group, and ``rest``, one
layer a remainder block, each holding its slice of the JAX package's
stacked tensors. Two loops take the place of the reference's two scans.

RG-LRU gates use Griffin's block-diagonal linears (NB = 16 blocks); the
recurrence itself is the RG-LRU kernel's wrapper
(``kernels.rglru.rglru_bsw``), called directly, as the dense decoder calls
the flash kernel's: on the card it launches the hand-written kernel (one
launch a block and call, counted by ``rglru.launches``, not timed), on
the CPU its plain version. The local attention runs through the flash
kernel with the window. Serving state is O(1): conv tail (width-1
inputs) + LRU hidden state + a local-attention ring buffer, the ring as
long as the window or, for a shorter prompt, the prompt (the reference's
rule, reproduced).

Training: ``loss_fn`` and ``make_train_step`` as the reference's. The
RG-LRU wrapper and the flash wrapper are differentiable (their backward
passes are the hand-written gradient kernels on the card), and where a
gradient is taken each (rglru, rglru, local) group and each remainder
layer runs under ``cfg.remat``, as the reference's scanned bodies do.

Sharding: the reference's ``ShardCtx`` through every function (its three
constraints), ``param_logical`` and ``cache_logical``; on a mesh the
RG-LRU kernel gets each rank's blocks (``ShardCtx.local``: batch over
the batch axes, the LRU width over "model"). Not here yet, as in
transformer.py: ``input_specs`` and ``roofline_units`` (the dry run).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.kernels.rglru import rglru_bsw
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tf
from repro_torch.models.layers import (
    NULL_CTX,
    ShardCtx,
    dtype_of,
    embed_tokens,
    lm_logits,
    pad_dim,
    position_ids,
    rms_norm,
    softmax_xent,
    stacked,
    swiglu_mlp,
)
from repro_torch.models.params import Params, count, init, spec

NB = 16          # block-diagonal gate blocks (Griffin)
CONV_W = 4       # temporal conv width
RG_C = 8.0       # RG-LRU `c` constant


def _counts(cfg):
    return cfg.num_layers // 3, cfg.num_layers % 3  # (groups, rest rg layers)


# --------------------------------------------------------------------------- #
# parameters                                                                   #
# --------------------------------------------------------------------------- #
def _mlp_shapes(cfg, L, dt):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mlp_norm": spec((L, d), dt),
        "w_gate": spec((L, d, f), dt),
        "w_up": spec((L, d, f), dt),
        "w_down": spec((L, f, d), dt),
    }


def rg_param_shapes(cfg, L):
    d = cfg.d_model
    w = cfg.d_model  # lru width == d_model for recurrentgemma
    dt = dtype_of(cfg)
    shapes = {
        "norm": spec((L, d), dt),
        "w_x": spec((L, d, w), dt),
        "w_g": spec((L, d, w), dt),
        "conv_w": spec((L, w, CONV_W), dt),
        "conv_b": spec((L, w), dt),
        "w_r": spec((L, NB, w // NB, w // NB), dt),
        "b_r": spec((L, w), dt),
        "w_i": spec((L, NB, w // NB, w // NB), dt),
        "b_i": spec((L, w), dt),
        "a_param": spec((L, w), dt),
        "w_out": spec((L, w, d), dt),
    }
    shapes.update(_mlp_shapes(cfg, L, dt))
    return shapes


def attn_param_shapes(cfg, L):
    # every Griffin block has its own MLP: the dense layer's schema
    return tf.layer_param_shapes(dataclasses.replace(cfg, num_layers=L))


def param_shapes(cfg) -> Dict:
    g, r = _counts(cfg)
    d, vp = cfg.d_model, cfg.vocab_padded
    dt = dtype_of(cfg)
    return {
        "embed": spec((vp, d), dt),
        "out_head": spec((d, vp), dt),
        "final_norm": spec((d,), dt),
        "groups": {
            "rg1": rg_param_shapes(cfg, g),
            "rg2": rg_param_shapes(cfg, g),
            "attn": attn_param_shapes(cfg, g),
        },
        "rest": rg_param_shapes(cfg, r),
    }


_MLP_LOGICAL = {
    "mlp_norm": "layers .",
    "w_gate": "layers d_model_w d_ff",
    "w_up": "layers d_model_w d_ff",
    "w_down": "layers d_ff d_model_w",
}

RG_LOGICAL = {
    "norm": "layers .",
    "w_x": "layers d_model_w lru",
    "w_g": "layers d_model_w lru",
    "conv_w": "layers lru conv",
    "conv_b": "layers lru",
    "w_r": "layers lru_blocks . .",
    "b_r": "layers lru",
    "w_i": "layers lru_blocks . .",
    "b_i": "layers lru",
    "a_param": "layers lru",
    "w_out": "layers lru d_model_w",
    **_MLP_LOGICAL,
}


def param_logical(cfg) -> Dict:
    return {
        "embed": "vocab d_model_w",
        "out_head": "d_model_w vocab",
        "final_norm": ".",
        "groups": {
            "rg1": dict(RG_LOGICAL),
            "rg2": dict(RG_LOGICAL),
            "attn": tf.layer_param_logical(cfg),
        },
        "rest": dict(RG_LOGICAL),
    }


def param_count(cfg) -> int:
    return count(param_shapes(cfg))


def active_param_count(cfg) -> int:
    return param_count(cfg)


class Hybrid(Params):
    """The hybrid model's parameters: ``embed``, ``out_head``,
    ``final_norm``, ``groups`` (a ``ModuleDict`` of ``rg1``, ``rg2`` and
    ``attn`` layers a group) and ``rest`` (one layer a remainder RG-LRU
    block). Made empty; ``init_params`` and ``convert.model_params`` fill
    it."""

    def __init__(self, cfg, *, device="cuda"):
        super().__init__(cfg, param_shapes(cfg), device=device)

    def forward(self, batch):
        return forward(self.cfg, self, batch)


Model = Hybrid  # the family's parameter module (convert.model_params)


def init_params(cfg, generator: torch.Generator, *, device="cuda") -> Hybrid:
    """A ``Hybrid`` drawn as the JAX package draws its parameters
    (``params.init``: the 1-d leaves zero)."""
    return init(Hybrid(cfg, device=device), param_shapes(cfg), generator,
                fill=0.0, device=device)


# --------------------------------------------------------------------------- #
# RG-LRU block                                                                 #
# --------------------------------------------------------------------------- #
def _blockdiag(x, w, b):
    """x (B,S,W) @ block-diagonal (NB, W/NB, W/NB) + b."""
    bsz, s, wdim = x.shape
    xb = x.reshape(bsz, s, NB, wdim // NB)
    y = torch.einsum("bsnw,nwv->bsnv", xb, w.to(x.dtype))
    return y.reshape(bsz, s, wdim) + b.to(x.dtype)


def causal_conv1d(x, w, b, state=None):
    """Depthwise causal conv. x (B,S,W), w (W,cw). state: (B,cw-1,W) tail.

    The taps are summed in the reference's order, j = 0..cw-1, each
    product and sum rounded to x's dtype."""
    cw = w.shape[-1]
    if state is None:
        pad = pad_dim(x, 1, cw - 1)
    else:
        pad = torch.cat([state.to(x.dtype), x], dim=1)
    s = x.shape[1]
    out = pad[:, 0:s] * w[:, 0].to(x.dtype)
    for j in range(1, cw):
        out = out + pad[:, j:j + s] * w[:, j].to(x.dtype)
    return out + b.to(x.dtype)


def _recur(ctx, xr, r, i, a_param, h0):
    """``rglru_bsw`` on each rank's blocks: batch over the batch axes, the
    LRU width over "model"."""
    outs = (0, None)
    if ctx.mesh is not None:
        outs = (0, ctx.places((xr.shape[0], xr.shape[2]), "batch lru"))
    return ctx.local(
        functools.partial(rglru_bsw, c=RG_C), (xr, r, i, a_param, h0),
        ("batch seq lru",) * 3 + ("lru", "batch lru"), outs)


def rg_block(cfg, lp, h, state=None, ctx: ShardCtx = NULL_CTX):
    """Griffin recurrent block (+MLP). state: None (train) or {"conv":
    (B, cw-1, W), "h": (B, W)}; returns (h, new state or None)."""
    x_in = rms_norm(h, lp["norm"], cfg.norm_eps)
    gate = F.gelu(torch.matmul(x_in, lp["w_g"].to(x_in.dtype)).to(
        torch.float32), approximate="tanh").to(x_in.dtype)
    gate = ctx.constrain(gate, "batch seq lru")
    xr_raw = torch.matmul(x_in, lp["w_x"].to(x_in.dtype))
    xr_raw = ctx.constrain(xr_raw, "batch seq lru")

    conv_state = None if state is None else state["conv"]
    xr = causal_conv1d(xr_raw, lp["conv_w"], lp["conv_b"], conv_state)
    r = _blockdiag(xr, lp["w_r"], lp["b_r"])
    i = _blockdiag(xr, lp["w_i"], lp["b_i"])
    h0 = None if state is None else state["h"]
    y, h_last = _recur(ctx, xr, r, i, lp["a_param"], h0)
    out = torch.matmul(y * gate, lp["w_out"].to(y.dtype))
    h = h + ctx.constrain(out, "batch seq d_model")
    m_in = rms_norm(h, lp["mlp_norm"], cfg.norm_eps)
    h = h + swiglu_mlp(m_in, lp["w_gate"], lp["w_up"], lp["w_down"], ctx)

    if state is None:
        return h, None
    tail_src = torch.cat([state["conv"].to(xr_raw.dtype), xr_raw], dim=1)
    return h, {"conv": tail_src[:, -(CONV_W - 1):], "h": h_last}


def attn_block(cfg, lp, h, positions, ctx: ShardCtx = NULL_CTX):
    a_in = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
    a_out, kv = attn.attention_train(cfg, a_in, lp, positions, ctx,
                                     window=cfg.local_window)
    h = h + a_out
    m_in = rms_norm(h, lp["mlp_norm"], cfg.norm_eps)
    h = h + swiglu_mlp(m_in, lp["w_gate"], lp["w_up"], lp["w_down"], ctx)
    return h, kv


# --------------------------------------------------------------------------- #
# forward                                                                      #
# --------------------------------------------------------------------------- #
def _group(cfg, gp, h, pos, ctx: ShardCtx = NULL_CTX):
    h, _ = rg_block(cfg, gp["rg1"], h, None, ctx)
    h, _ = rg_block(cfg, gp["rg2"], h, None, ctx)
    return attn_block(cfg, gp["attn"], h, pos, ctx)[0]


def _rest(cfg, lp, h, ctx: ShardCtx = NULL_CTX):
    return rg_block(cfg, lp, h, None, ctx)[0]


def _stack(cfg, params: Hybrid, h, pos, ctx: ShardCtx = NULL_CTX):
    group = tf.remat_where_grad(cfg, functools.partial(_group, cfg), h,
                                params)
    rest = tf.remat_where_grad(cfg, functools.partial(_rest, cfg), h, params)
    for gp in params.groups:
        h = group(gp, h, pos, ctx)
    for lp in params.rest:
        h = rest(lp, h, ctx)
    return h


def forward(cfg, params: Hybrid, batch, ctx: ShardCtx = NULL_CTX):
    with ctx.scope():
        tokens = batch["tokens"]
        h = embed_tokens(tokens, params.embed, ctx)
        h = _stack(cfg, params, h,
                   position_ids(*tokens.shape, tokens.device), ctx)
        h = rms_norm(h, params.final_norm, cfg.norm_eps)
        return lm_logits(h, params.out_head, cfg.vocab_size, ctx)


def loss_fn(cfg, params: Hybrid, batch, ctx: ShardCtx = NULL_CTX):
    logits = forward(cfg, params, batch, ctx)
    with ctx.scope():
        loss = softmax_xent(logits, batch["labels"], batch.get("loss_mask"))
    return loss, {"loss": loss}


def make_train_step(cfg, optimizer, ctx: ShardCtx = NULL_CTX):
    return tf.make_train_step(cfg, optimizer, ctx, loss=loss_fn)


# --------------------------------------------------------------------------- #
# serving                                                                      #
# --------------------------------------------------------------------------- #
def _rg_state_shapes(cfg, L, batch):
    w = cfg.d_model
    dt = dtype_of(cfg)
    return {"conv": spec((L, batch, CONV_W - 1, w), dt),
            "h": spec((L, batch, w), dt)}


def cache_shapes(cfg, batch: int, seq_len: int) -> Dict:
    """The cache's tensors on the meta device (the reference's first half;
    ``cache_logical`` is its second)."""
    g, r = _counts(cfg)
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    win = min(cfg.local_window, seq_len)
    dt = dtype_of(cfg)
    rg = _rg_state_shapes(cfg, g, batch)
    return {
        "groups": {
            "rg1": rg,
            "rg2": rg,
            "attn_k": spec((g, batch, win, kv, hd), dt),
            "attn_v": spec((g, batch, win, kv, hd), dt),
        },
        "rest": _rg_state_shapes(cfg, r, batch),
        "lengths": spec((batch,), torch.int32),
    }


def cache_logical(cfg) -> Dict:
    """The logical dims of ``cache_shapes``' tensors."""
    rg = {"conv": "layers batch . lru", "h": "layers batch lru"}
    return {
        "groups": {
            "rg1": dict(rg),
            "rg2": dict(rg),
            "attn_k": "layers batch cache_seq kv_heads .",
            "attn_v": "layers batch cache_seq kv_heads .",
        },
        "rest": dict(rg),
        "lengths": "batch",
    }


def prefill(cfg, params: Hybrid, batch, ctx: ShardCtx = NULL_CTX):
    """Run the full prompt; returns (cache, last-position logits). The
    local-attention caches keep the last min(window, S) keys and values in
    ring order (position p at slot p % window)."""
    with ctx.scope():
        return _prefill(cfg, params, batch, ctx)


def _prefill(cfg, params, batch, ctx):
    tokens = batch["tokens"]
    h = embed_tokens(tokens, params.embed, ctx)
    b, s = tokens.shape
    pos = position_ids(b, s, tokens.device)
    w = cfg.d_model
    win = min(cfg.local_window, s)
    zero_state = {
        "conv": torch.zeros((b, CONV_W - 1, w), dtype=h.dtype, device=h.device),
        "h": torch.zeros((b, w), dtype=h.dtype, device=h.device),
    }

    def ring_align(k):
        keep = k[:, -win:]
        shift = s % cfg.local_window if s >= cfg.local_window else 0
        return torch.roll(keep, shift, dims=1)

    st1, st2, ks, vs = [], [], [], []
    for gp in params.groups:
        h, st = rg_block(cfg, gp["rg1"], h, zero_state, ctx)
        st1.append(st)
        h, st = rg_block(cfg, gp["rg2"], h, zero_state, ctx)
        st2.append(st)
        h, (k, v) = attn_block(cfg, gp["attn"], h, pos, ctx)
        ks.append(ring_align(k))
        vs.append(ring_align(v))
    rest = []
    for lp in params.rest:
        h, st = rg_block(cfg, lp, h, zero_state, ctx)
        rest.append(st)
    cache = {"lengths": torch.full((b,), s, dtype=torch.int32,
                                   device=h.device)}
    if st1:
        cache["groups"] = {"rg1": stacked(st1),
                           "rg2": stacked(st2),
                           "attn_k": torch.stack(ks),
                           "attn_v": torch.stack(vs)}
    if rest:
        cache["rest"] = stacked(rest)
    h = rms_norm(h, params.final_norm, cfg.norm_eps)
    logits = lm_logits(h[:, -1:], params.out_head, cfg.vocab_size, ctx)[:, 0]
    return cache, logits


def _layer_state(states: Dict, i: int) -> Dict:
    return {"conv": states["conv"][i], "h": states["h"][i]}


def decode_step(cfg, params: Hybrid, cache, batch, ctx: ShardCtx = NULL_CTX):
    """One token for every sequence. batch: {"token": (B,) int32}.

    The RG-LRU blocks run as in the forward at S = 1 from their cached
    state (one ``rglru`` launch each on the card); the local-attention
    blocks write the new token's K/V into their ring caches in place
    (``attention.decode_attention_block``, the ring as long as the cache).
    Returns the new cache with the lengths advanced by one."""
    with ctx.scope():
        return _decode_step(cfg, params, cache, batch, ctx)


def _decode_step(cfg, params, cache, batch, ctx):
    token = batch["token"]
    h = embed_tokens(token[:, None], params.embed, ctx)
    lengths = cache["lengths"]
    new_cache = {"lengths": lengths + 1}

    st1, st2 = [], []
    if len(params.groups):
        gc = cache["groups"]
        for i, gp in enumerate(params.groups):
            h, st = rg_block(cfg, gp["rg1"], h, _layer_state(gc["rg1"], i),
                             ctx)
            st1.append(st)
            h, st = rg_block(cfg, gp["rg2"], h, _layer_state(gc["rg2"], i),
                             ctx)
            st2.append(st)
            lp = gp["attn"]
            a_in = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
            a_out, _, _ = attn.decode_attention_block(
                cfg, a_in, lp, gc["attn_k"][i], gc["attn_v"][i], lengths,
                ctx, window=gc["attn_k"].shape[2])
            h = h + a_out
            m_in = rms_norm(h, lp["mlp_norm"], cfg.norm_eps)
            h = h + swiglu_mlp(m_in, lp["w_gate"], lp["w_up"], lp["w_down"],
                               ctx)
        new_cache["groups"] = {"rg1": stacked(st1),
                               "rg2": stacked(st2),
                               "attn_k": gc["attn_k"], "attn_v": gc["attn_v"]}
    if len(params.rest):
        rest = []
        for i, lp in enumerate(params.rest):
            h, st = rg_block(cfg, lp, h, _layer_state(cache["rest"], i), ctx)
            rest.append(st)
        new_cache["rest"] = stacked(rest)
    h = rms_norm(h, params.final_norm, cfg.norm_eps)
    logits = lm_logits(h, params.out_head, cfg.vocab_size, ctx)[:, 0]
    return new_cache, logits
