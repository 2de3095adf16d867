"""Encoder-decoder family (whisper-small).

Port of ``repro.models.encdec``. The conv/mel frontend is
a STUB: the caller supplies precomputed frame embeddings (B, num_frames,
d_model). Encoder = bidirectional attention blocks; decoder = causal
self-attention + cross-attention blocks. RoPE stands in for the original
learned positional embeddings, as in the JAX package. The parameters live
in an ``EncDec`` module (``models/params.py``): ``enc_layers`` and
``dec_layers``, one ``nn.ParameterDict`` a layer.

Every attention runs through the flash kernel's wrapper: the encoder's
non-causal over F frames, the decoder's causal self-attention, and the
cross-attention (``attention.cross_attention``, Sq tokens against F
frames). Prefill computes each decoder layer's cross K/V once and keeps
them in the cache; decode writes the self-attention K/V in place.

Training: ``loss_fn`` (``softmax_xent`` of ``forward``) and
``make_train_step`` (``transformer.make_train_step`` with that loss), as
the reference's; where a gradient is taken each encoder layer and each
decoder layer (its cross K/V included) runs under ``cfg.remat``, as the
reference's scanned bodies do.

Sharding: the reference's ``ShardCtx`` through every function (the cross
K/V constrained as "batch frames kv_heads ."), ``param_logical`` and
``cache_logical``. Not here yet, as in transformer.py: ``input_specs``
and ``roofline_units`` (the dry run).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict

import torch

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
    swiglu_mlp,
)
from repro_torch.models.params import Params, count, init, spec


# --------------------------------------------------------------------------- #
# parameters                                                                   #
# --------------------------------------------------------------------------- #
def _enc_layer_shapes(cfg, L):
    return tf.layer_param_shapes(dataclasses.replace(cfg, num_layers=L))


def _dec_layer_shapes(cfg, L):
    d, h, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    dt = dtype_of(cfg)
    shapes = tf.layer_param_shapes(dataclasses.replace(cfg, num_layers=L))
    shapes.update(
        {
            "xattn_norm": spec((L, d), dt),
            "xwq": spec((L, d, h, hd), dt),
            "xwk": spec((L, d, cfg.num_kv_heads, hd), dt),
            "xwv": spec((L, d, cfg.num_kv_heads, hd), dt),
            "xwo": spec((L, h, hd, d), dt),
        }
    )
    return shapes


def param_shapes(cfg) -> Dict:
    d, vp = cfg.d_model, cfg.vocab_padded
    dt = dtype_of(cfg)
    return {
        "embed": spec((vp, d), dt),
        "out_head": spec((d, vp), dt),
        "final_norm": spec((d,), dt),
        "enc_final_norm": spec((d,), dt),
        "enc_layers": _enc_layer_shapes(cfg, cfg.num_encoder_layers),
        "dec_layers": _dec_layer_shapes(cfg, cfg.num_layers),
    }


def _dec_layer_logical(cfg):
    logical = tf.layer_param_logical(cfg)
    div = cfg.num_heads % tf.PRODUCTION_MODEL_AXIS == 0
    adw = "d_model_w" if div else "attn_dw"
    logical.update(
        {
            "xattn_norm": "layers .",
            "xwq": f"layers {adw} heads .",
            "xwk": f"layers {adw} kv_heads .",
            "xwv": f"layers {adw} kv_heads .",
            "xwo": f"layers heads . {adw}",
        }
    )
    return logical


def param_logical(cfg) -> Dict:
    return {
        "embed": "vocab d_model_w",
        "out_head": "d_model_w vocab",
        "final_norm": ".",
        "enc_final_norm": ".",
        "enc_layers": tf.layer_param_logical(cfg),
        "dec_layers": _dec_layer_logical(cfg),
    }


def param_count(cfg) -> int:
    return count(param_shapes(cfg))


def active_param_count(cfg) -> int:
    return param_count(cfg)


class EncDec(Params):
    """The encoder-decoder's parameters: ``embed``, ``out_head``,
    ``final_norm``, ``enc_final_norm``, ``enc_layers`` and ``dec_layers``.
    Made empty; ``init_params`` and ``convert.model_params`` fill it."""

    def __init__(self, cfg, *, device="cuda"):
        super().__init__(cfg, param_shapes(cfg), device=device)

    def forward(self, batch):
        return forward(self.cfg, self, batch)


Model = EncDec  # the family's parameter module (convert.model_params)


def init_params(cfg, generator: torch.Generator, *, device="cuda") -> EncDec:
    """An ``EncDec`` drawn as the JAX package draws its parameters
    (``params.init``: the 1-d leaves zero)."""
    return init(EncDec(cfg, device=device), param_shapes(cfg), generator,
                fill=0.0, device=device)


# --------------------------------------------------------------------------- #
# forward                                                                      #
# --------------------------------------------------------------------------- #
def _enc_block(cfg, lp, h, pos, ctx: ShardCtx = NULL_CTX):
    a_in = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
    a_out, _ = attn.attention_train(cfg, a_in, lp, pos, ctx, causal=False)
    h = h + a_out
    m_in = rms_norm(h, lp["mlp_norm"], cfg.norm_eps)
    return h + swiglu_mlp(m_in, lp["w_gate"], lp["w_up"], lp["w_down"], ctx)


def encode(cfg, params: EncDec, frames, ctx: ShardCtx = NULL_CTX):
    """frames: (B, F, D) stub embeddings -> encoder output (B, F, D)."""
    h = frames
    pos = position_ids(h.shape[0], h.shape[1], h.device)
    block = tf.remat_where_grad(cfg, functools.partial(_enc_block, cfg), h,
                                params)
    for lp in params.enc_layers:
        h = block(lp, h, pos, ctx)
    return rms_norm(h, params.enc_final_norm, cfg.norm_eps)


def _dec_block(cfg, lp, h, pos, enc_kv, ctx: ShardCtx = NULL_CTX):
    ek, ev = enc_kv
    a_in = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
    a_out, kv = attn.attention_train(cfg, a_in, lp, pos, ctx)
    h = h + a_out
    x_in = rms_norm(h, lp["xattn_norm"], cfg.norm_eps)
    h = h + attn.cross_attention(cfg, x_in, lp, ek, ev, ctx)
    m_in = rms_norm(h, lp["mlp_norm"], cfg.norm_eps)
    h = h + swiglu_mlp(m_in, lp["w_gate"], lp["w_up"], lp["w_down"], ctx)
    return h, kv


def _cross_kv(lp, enc_out, ctx: ShardCtx = NULL_CTX):
    dt = enc_out.dtype

    def proj(w):  # "bfd,dhk->bfhk"
        w = w.to(dt)
        out = torch.matmul(enc_out, w.flatten(1)).unflatten(-1, w.shape[1:])
        return ctx.constrain(out, "batch frames kv_heads .")

    return proj(lp["xwk"]), proj(lp["xwv"])


def _decoder_input(cfg, params: EncDec, batch, ctx: ShardCtx = NULL_CTX):
    """(encoder output, token embeddings, positions)."""
    enc_out = encode(cfg, params, batch["frames"].to(dtype_of(cfg)), ctx)
    tokens = batch["tokens"]
    h = embed_tokens(tokens, params.embed, ctx)
    return enc_out, h, position_ids(*tokens.shape, tokens.device)


def _dec_layer(cfg, lp, h, pos, enc_out, ctx: ShardCtx = NULL_CTX):
    return _dec_block(cfg, lp, h, pos, _cross_kv(lp, enc_out, ctx), ctx)[0]


def forward(cfg, params: EncDec, batch, ctx: ShardCtx = NULL_CTX):
    with ctx.scope():
        enc_out, h, pos = _decoder_input(cfg, params, batch, ctx)
        layer = tf.remat_where_grad(cfg, functools.partial(_dec_layer, cfg),
                                    h, params)
        for lp in params.dec_layers:
            h = layer(lp, h, pos, enc_out, ctx)
        h = rms_norm(h, params.final_norm, cfg.norm_eps)
        return lm_logits(h, params.out_head, cfg.vocab_size, ctx)


def loss_fn(cfg, params: EncDec, batch, ctx: ShardCtx = NULL_CTX):
    logits = forward(cfg, params, batch, ctx)
    with ctx.scope():
        loss = softmax_xent(logits, batch["labels"], batch.get("loss_mask"))
    return loss, {"loss": loss}


def make_train_step(cfg, optimizer, ctx: ShardCtx = NULL_CTX):
    return tf.make_train_step(cfg, optimizer, ctx, loss=loss_fn)


# --------------------------------------------------------------------------- #
# serving                                                                      #
# --------------------------------------------------------------------------- #
def cache_shapes(cfg, batch: int, seq_len: int) -> Dict:
    """The cache's tensors on the meta device (the reference's first half;
    ``cache_logical`` is its second)."""
    L, kv, hd, f = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, cfg.num_frames
    dt = dtype_of(cfg)
    return {
        "k": spec((L, batch, seq_len, kv, hd), dt),
        "v": spec((L, batch, seq_len, kv, hd), dt),
        "cross_k": spec((L, batch, f, kv, hd), dt),
        "cross_v": spec((L, batch, f, kv, hd), dt),
        "lengths": spec((batch,), torch.int32),
    }


def cache_logical(cfg) -> Dict[str, str]:
    """The logical dims of ``cache_shapes``' tensors."""
    return {
        "k": "layers batch cache_seq kv_heads .",
        "v": "layers batch cache_seq kv_heads .",
        "cross_k": "layers batch frames kv_heads .",
        "cross_v": "layers batch frames kv_heads .",
        "lengths": "batch",
    }


def prefill(cfg, params: EncDec, batch, ctx: ShardCtx = NULL_CTX,
            pad_cache_to: int | None = None):
    """Encode the frames and run the prompt; returns (cache, last-position
    logits). ``pad_cache_to`` reserves decode headroom in the
    self-attention cache's seq dim."""
    with ctx.scope():
        return _prefill(cfg, params, batch, ctx, pad_cache_to)


def _prefill(cfg, params, batch, ctx, pad_cache_to):
    enc_out, h, pos = _decoder_input(cfg, params, batch, ctx)
    ks, vs, eks, evs = [], [], [], []
    for lp in params.dec_layers:
        enc_kv = _cross_kv(lp, enc_out, ctx)
        h, (k, v) = _dec_block(cfg, lp, h, pos, enc_kv, ctx)
        ks.append(k)
        vs.append(v)
        eks.append(enc_kv[0])
        evs.append(enc_kv[1])
    h = rms_norm(h, params.final_norm, cfg.norm_eps)
    logits = lm_logits(h[:, -1:], params.out_head, cfg.vocab_size,
                       ctx)[:, 0]
    ks, vs = torch.stack(ks), torch.stack(vs)
    if pad_cache_to is not None and pad_cache_to > ks.shape[2]:
        pad = pad_cache_to - ks.shape[2]
        ks = pad_dim(ks, 2, after=pad)
        vs = pad_dim(vs, 2, after=pad)
    b, s = batch["tokens"].shape
    cache = {
        "k": ks, "v": vs, "cross_k": torch.stack(eks),
        "cross_v": torch.stack(evs),
        "lengths": torch.full((b,), s, dtype=torch.int32, device=h.device),
    }
    return cache, logits


def decode_step(cfg, params: EncDec, cache, batch, ctx: ShardCtx = NULL_CTX):
    """One token for every sequence. batch: {"token": (B,) int32}.

    Writes the new token's K/V into ``cache["k"]`` and ``cache["v"]`` in
    place (as the dense decoder does) and returns the cache with the
    lengths advanced by one; the cross K/V are read as they are."""
    with ctx.scope():
        h = embed_tokens(batch["token"][:, None], params.embed, ctx)
        lengths = cache["lengths"]
        for lp, ck, cv, ek, ev in zip(params.dec_layers, cache["k"],
                                      cache["v"], cache["cross_k"],
                                      cache["cross_v"]):
            a_in = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
            a_out, _, _ = attn.decode_attention_block(cfg, a_in, lp, ck, cv,
                                                      lengths, ctx)
            h = h + a_out
            x_in = rms_norm(h, lp["xattn_norm"], cfg.norm_eps)
            h = h + attn.cross_attention(cfg, x_in, lp, ek, ev, ctx)
            m_in = rms_norm(h, lp["mlp_norm"], cfg.norm_eps)
            h = h + swiglu_mlp(m_in, lp["w_gate"], lp["w_up"], lp["w_down"],
                               ctx)
        h = rms_norm(h, params.final_norm, cfg.norm_eps)
        logits = lm_logits(h, params.out_head, cfg.vocab_size, ctx)[:, 0]
    return dict(cache, lengths=lengths + 1), logits
