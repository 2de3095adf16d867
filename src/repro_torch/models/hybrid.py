"""Hybrid family (recurrentgemma-9b): Griffin-style RG-LRU + local attention.

Port of ``repro.models.hybrid`` at world size 1. Block pattern = (rglru,
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
layer runs under ``cfg.remat``, as the reference's scanned bodies do. Not
here yet, as in transformer.py: ``input_specs``, ``roofline_units`` and
``param_logical``.
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
    dtype_of,
    embed_tokens,
    lm_logits,
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
        pad = F.pad(x, (0, 0, cw - 1, 0))
    else:
        pad = torch.cat([state.to(x.dtype), x], dim=1)
    s = x.shape[1]
    out = pad[:, 0:s] * w[:, 0].to(x.dtype)
    for j in range(1, cw):
        out = out + pad[:, j:j + s] * w[:, j].to(x.dtype)
    return out + b.to(x.dtype)


def rg_block(cfg, lp, h, state=None):
    """Griffin recurrent block (+MLP). state: None (train) or {"conv":
    (B, cw-1, W), "h": (B, W)}; returns (h, new state or None)."""
    x_in = rms_norm(h, lp["norm"], cfg.norm_eps)
    gate = F.gelu(torch.matmul(x_in, lp["w_g"].to(x_in.dtype)).to(
        torch.float32), approximate="tanh").to(x_in.dtype)
    xr_raw = torch.matmul(x_in, lp["w_x"].to(x_in.dtype))

    conv_state = None if state is None else state["conv"]
    xr = causal_conv1d(xr_raw, lp["conv_w"], lp["conv_b"], conv_state)
    r = _blockdiag(xr, lp["w_r"], lp["b_r"])
    i = _blockdiag(xr, lp["w_i"], lp["b_i"])
    h0 = None if state is None else state["h"]
    y, h_last = rglru_bsw(xr, r, i, lp["a_param"], h0, c=RG_C)
    out = torch.matmul(y * gate, lp["w_out"].to(y.dtype))
    h = h + out
    m_in = rms_norm(h, lp["mlp_norm"], cfg.norm_eps)
    h = h + swiglu_mlp(m_in, lp["w_gate"], lp["w_up"], lp["w_down"])

    if state is None:
        return h, None
    tail_src = torch.cat([state["conv"].to(xr_raw.dtype), xr_raw], dim=1)
    return h, {"conv": tail_src[:, -(CONV_W - 1):], "h": h_last}


def attn_block(cfg, lp, h, positions):
    a_in = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
    a_out, kv = attn.attention_train(cfg, a_in, lp, positions,
                                     window=cfg.local_window)
    h = h + a_out
    m_in = rms_norm(h, lp["mlp_norm"], cfg.norm_eps)
    h = h + swiglu_mlp(m_in, lp["w_gate"], lp["w_up"], lp["w_down"])
    return h, kv


# --------------------------------------------------------------------------- #
# forward                                                                      #
# --------------------------------------------------------------------------- #
def _group(cfg, gp, h, pos):
    h, _ = rg_block(cfg, gp["rg1"], h)
    h, _ = rg_block(cfg, gp["rg2"], h)
    return attn_block(cfg, gp["attn"], h, pos)[0]


def _rest(cfg, lp, h):
    return rg_block(cfg, lp, h)[0]


def _stack(cfg, params: Hybrid, h, pos):
    group = tf.remat_where_grad(cfg, functools.partial(_group, cfg), h,
                                params)
    rest = tf.remat_where_grad(cfg, functools.partial(_rest, cfg), h, params)
    for gp in params.groups:
        h = group(gp, h, pos)
    for lp in params.rest:
        h = rest(lp, h)
    return h


def forward(cfg, params: Hybrid, batch):
    tokens = batch["tokens"]
    h = embed_tokens(tokens, params.embed)
    h = _stack(cfg, params, h, position_ids(*tokens.shape, tokens.device))
    h = rms_norm(h, params.final_norm, cfg.norm_eps)
    return lm_logits(h, params.out_head, cfg.vocab_size)


def loss_fn(cfg, params: Hybrid, batch):
    logits = forward(cfg, params, batch)
    loss = softmax_xent(logits, batch["labels"], batch.get("loss_mask"))
    return loss, {"loss": loss}


def make_train_step(cfg, optimizer):
    return tf.make_train_step(cfg, optimizer, loss=loss_fn)


# --------------------------------------------------------------------------- #
# serving                                                                      #
# --------------------------------------------------------------------------- #
def _rg_state_shapes(cfg, L, batch):
    w = cfg.d_model
    dt = dtype_of(cfg)
    return {"conv": spec((L, batch, CONV_W - 1, w), dt),
            "h": spec((L, batch, w), dt)}


def cache_shapes(cfg, batch: int, seq_len: int) -> Dict:
    """The cache's tensors on the meta device (the JAX package also
    returns their logical sharding names, which belong to sharding, not
    ported yet)."""
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


def prefill(cfg, params: Hybrid, batch):
    """Run the full prompt; returns (cache, last-position logits). The
    local-attention caches keep the last min(window, S) keys and values in
    ring order (position p at slot p % window)."""
    tokens = batch["tokens"]
    h = embed_tokens(tokens, params.embed)
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
        h, st = rg_block(cfg, gp["rg1"], h, zero_state)
        st1.append(st)
        h, st = rg_block(cfg, gp["rg2"], h, zero_state)
        st2.append(st)
        h, (k, v) = attn_block(cfg, gp["attn"], h, pos)
        ks.append(ring_align(k))
        vs.append(ring_align(v))
    rest = []
    for lp in params.rest:
        h, st = rg_block(cfg, lp, h, zero_state)
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
    logits = lm_logits(h[:, -1:], params.out_head, cfg.vocab_size)[:, 0]
    return cache, logits


def _layer_state(states: Dict, i: int) -> Dict:
    return {"conv": states["conv"][i], "h": states["h"][i]}


def decode_step(cfg, params: Hybrid, cache, batch):
    """One token for every sequence. batch: {"token": (B,) int32}.

    The RG-LRU blocks run as in the forward at S = 1 from their cached
    state (one ``rglru`` launch each on the card); the local-attention
    blocks write the new token's K/V into their ring caches in place
    (``attention.decode_attention_block``, the ring as long as the cache).
    Returns the new cache with the lengths advanced by one."""
    token = batch["token"]
    h = embed_tokens(token[:, None], params.embed)
    lengths = cache["lengths"]
    new_cache = {"lengths": lengths + 1}

    st1, st2 = [], []
    if len(params.groups):
        gc = cache["groups"]
        for i, gp in enumerate(params.groups):
            h, st = rg_block(cfg, gp["rg1"], h, _layer_state(gc["rg1"], i))
            st1.append(st)
            h, st = rg_block(cfg, gp["rg2"], h, _layer_state(gc["rg2"], i))
            st2.append(st)
            lp = gp["attn"]
            a_in = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
            a_out, _, _ = attn.decode_attention_block(
                cfg, a_in, lp, gc["attn_k"][i], gc["attn_v"][i], lengths,
                window=gc["attn_k"].shape[2])
            h = h + a_out
            m_in = rms_norm(h, lp["mlp_norm"], cfg.norm_eps)
            h = h + swiglu_mlp(m_in, lp["w_gate"], lp["w_up"], lp["w_down"])
        new_cache["groups"] = {"rg1": stacked(st1),
                               "rg2": stacked(st2),
                               "attn_k": gc["attn_k"], "attn_v": gc["attn_v"]}
    if len(params.rest):
        rest = []
        for i, lp in enumerate(params.rest):
            h, st = rg_block(cfg, lp, h, _layer_state(cache["rest"], i))
            rest.append(st)
        new_cache["rest"] = stacked(rest)
    h = rms_norm(h, params.final_norm, cfg.norm_eps)
    logits = lm_logits(h, params.out_head, cfg.vocab_size)[:, 0]
    return new_cache, logits
