"""SSM family (mamba2-370m): attention-free SSD (state-space duality).

Port of ``repro.models.ssm``. Block: in-proj -> depthwise
causal conv over [x;B;C] -> SSD -> gated RMSNorm -> out-proj. The
parameters live in an ``SSM`` module (``models/params.py``), one
``nn.ParameterDict`` a layer. Serving state is O(1) in context length:
conv tail + (H, P, N) float32 SSM state.

The scan calls the SSD kernel's wrapper (``kernels.ssd.ssd_bshp``)
directly on the (B, S, H, P) views, with ``chunk=min(64, S)``, as the
dense decoder calls the flash kernel's: on the card it launches the
hand-written kernel (one launch a layer, counted by ``ssd.launches``, not
timed), on the CPU its plain version. The kernel takes float32: a
bfloat16 model's x, B and C are converted first (three copies a layer;
dt is float32 already). The decode step is the O(1) recurrent form in
plain torch (``ops.ssd_decode_step``), as in the JAX package.

Training: ``loss_fn`` and ``make_train_step`` as the reference's; the
layer loop runs each block under ``tf.remat_where_grad`` (the
reference's ``jax.lax.scan`` of ``tf._remat``), and the scan's gradient
is the hand-written kernel's (``kernels.ssd.Ssd``: one gradient call a
layer, counted by ``ssd.backward_launches``).

Sharding: the reference's ``ShardCtx`` through every function (its
three constraints), ``param_logical`` and ``cache_logical``; on a mesh
the scan gets each rank's blocks (``ShardCtx.local``: batch over the
batch axes, heads over "model" where the B/C groups allow it). Not here
yet, as in transformer.py: ``input_specs`` and ``roofline_units`` (the
dry run).
"""
from __future__ import annotations

import functools
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, ref
from repro_torch.kernels.ssd import ssd_bshp
from repro_torch.models import transformer as tf
from repro_torch.models.hybrid import causal_conv1d
from repro_torch.models.layers import (
    NULL_CTX,
    ShardCtx,
    dtype_of,
    embed_tokens,
    lm_logits,
    pad_dim,
    rms_norm,
    softmax_xent,
    stacked,
)
from repro_torch.models.params import Params, count, init, spec


def _dims(cfg):
    di = cfg.d_inner                  # 2 * d_model
    h = cfg.ssm_heads                 # di / head_dim
    p = cfg.ssm_head_dim
    n = cfg.ssm_state
    g = cfg.ssm_groups
    conv_ch = di + 2 * g * n
    return di, h, p, n, g, conv_ch


# --------------------------------------------------------------------------- #
# parameters                                                                   #
# --------------------------------------------------------------------------- #
def layer_param_shapes(cfg) -> Dict[str, torch.Tensor]:
    d, L = cfg.d_model, cfg.num_layers
    di, h, p, n, g, conv_ch = _dims(cfg)
    cw = cfg.ssm_conv_width
    dt = dtype_of(cfg)
    return {
        "norm": spec((L, d), dt),
        "w_z": spec((L, d, di), dt),
        "w_x": spec((L, d, di), dt),
        "w_B": spec((L, d, g * n), dt),
        "w_C": spec((L, d, g * n), dt),
        "w_dt": spec((L, d, h), dt),
        "dt_bias": spec((L, h), dt),
        "A_log": spec((L, h), dt),
        "D_skip": spec((L, h), dt),
        "conv_w": spec((L, conv_ch, cw), dt),
        "conv_b": spec((L, conv_ch), dt),
        "gated_norm": spec((L, di), dt),
        "w_out": spec((L, di, d), dt),
    }


def param_shapes(cfg) -> Dict:
    d, vp = cfg.d_model, cfg.vocab_padded
    dt = dtype_of(cfg)
    return {
        "embed": spec((vp, d), dt),
        "out_head": spec((d, vp), dt),
        "final_norm": spec((d,), dt),
        "layers": layer_param_shapes(cfg),
    }


LAYER_LOGICAL = {
    "norm": "layers .",
    "w_z": "layers d_model_w ssm_inner",
    "w_x": "layers d_model_w ssm_inner",
    "w_B": "layers d_model_w .",
    "w_C": "layers d_model_w .",
    "w_dt": "layers d_model_w ssm_heads",
    "dt_bias": "layers ssm_heads",
    "A_log": "layers ssm_heads",
    "D_skip": "layers ssm_heads",
    "conv_w": "layers . conv",
    "conv_b": "layers .",
    "gated_norm": "layers ssm_inner",
    "w_out": "layers ssm_inner d_model_w",
}


def param_logical(cfg) -> Dict:
    return {
        "embed": "vocab d_model_w",
        "out_head": "d_model_w vocab",
        "final_norm": ".",
        "layers": dict(LAYER_LOGICAL),
    }


def param_count(cfg) -> int:
    return count(param_shapes(cfg))


def active_param_count(cfg) -> int:
    return param_count(cfg)


class SSM(Params):
    """The SSM model's parameters: ``embed``, ``out_head``, ``final_norm``
    and ``layers``, one ``nn.ParameterDict`` a layer. Made empty;
    ``init_params`` and ``convert.model_params`` fill it."""

    def __init__(self, cfg, *, device="cuda"):
        super().__init__(cfg, param_shapes(cfg), device=device)

    def forward(self, batch):
        return forward(self.cfg, self, batch)


Model = SSM  # the family's parameter module (convert.model_params)


def init_params(cfg, generator: torch.Generator, *, device="cuda") -> SSM:
    """An ``SSM`` drawn as the JAX package draws its parameters
    (``params.init``): the 1-d leaves 0.1; A_log, dt_bias and D_skip are
    stacked (L, H), so drawn like the weights, as there."""
    return init(SSM(cfg, device=device), param_shapes(cfg), generator,
                fill=0.1, device=device)


# --------------------------------------------------------------------------- #
# block                                                                        #
# --------------------------------------------------------------------------- #
def _proj_in(lp, x_in, ctx: ShardCtx = NULL_CTX):
    dt = x_in.dtype
    z, xi, Bm, Cm, dtv = (torch.matmul(x_in, lp[name].to(dt))
                          for name in ("w_z", "w_x", "w_B", "w_C", "w_dt"))
    z = ctx.constrain(z, "batch seq ssm_inner")
    xi = ctx.constrain(xi, "batch seq ssm_inner")
    return z, xi, Bm, Cm, dtv


def _scan(ctx, xh, dt, A, Bh, Ch, h0, *, chunk):
    """``ssd_bshp`` on each rank's blocks: batch over the batch axes and
    heads over "model" when B and C are one group (every head reads it)
    or their groups split as the heads do; else every head."""
    heads = ctx.mesh is not None and (
        Bh.shape[2] == 1 or ctx.places(Bh.shape, "batch seq ssm_heads .")
        != ctx.places(Bh.shape, "batch seq . ."))
    hd = "ssm_heads" if heads else "."
    grp = "ssm_heads" if heads and Bh.shape[2] > 1 else "."
    state = f"batch {hd} . ."
    outs = (0, None)
    if ctx.mesh is not None:
        b, _, h, p = xh.shape
        outs = (0, ctx.places((b, h, p, Bh.shape[3]), state))
    return ctx.local(
        functools.partial(ssd_bshp, chunk=chunk), (xh, dt, A, Bh, Ch, h0),
        (f"batch seq {hd} .", f"batch seq {hd}", hd, f"batch seq {grp} .",
         f"batch seq {grp} .", state), outs)


def _conv_xbc(cfg, lp, xi, Bm, Cm, state=None):
    """Depthwise causal conv over concat([x, B, C]); returns pieces + tail."""
    di, h, p, n, g, conv_ch = _dims(cfg)
    xbc = torch.cat([xi, Bm, Cm], dim=-1)   # (B, S, conv_ch)
    out = causal_conv1d(xbc, lp["conv_w"], lp["conv_b"], state)
    out = F.silu(out.to(torch.float32)).to(xbc.dtype)
    cw = cfg.ssm_conv_width
    tail_src = xbc if state is None else torch.cat(
        [state.to(xbc.dtype), xbc], dim=1)
    pad = cw - 1 - tail_src.shape[1]
    if pad > 0:
        tail_src = pad_dim(tail_src, 1, pad)
    tail = tail_src[:, -(cw - 1):]
    return (out[..., :di], out[..., di:di + g * n], out[..., di + g * n:],
            tail)


def _dt_A(lp, dtv):
    """(softplus(dtv + dt_bias) float32, A = -exp(A_log) float32)."""
    dt = ref.softplus(dtv.to(torch.float32) + lp["dt_bias"].to(torch.float32))
    return dt, -torch.exp(lp["A_log"].to(torch.float32))


def _gate_out(cfg, lp, y, z):
    """Gated RMSNorm (mamba2): norm(y * silu(z)), then the out-proj."""
    y = y * F.silu(z.to(torch.float32)).to(y.dtype)
    y = rms_norm(y, lp["gated_norm"], cfg.norm_eps)
    return torch.matmul(y, lp["w_out"].to(y.dtype))


def ssm_block(cfg, lp, hin, state=None, ctx: ShardCtx = NULL_CTX):
    """state: None (train) or {"conv": (B,cw-1,conv_ch), "ssm": (B,H,P,N)}."""
    di, h, p, n, g, conv_ch = _dims(cfg)
    b, s, _ = hin.shape
    x_in = rms_norm(hin, lp["norm"], cfg.norm_eps)
    z, xi, Bm, Cm, dtv = _proj_in(lp, x_in, ctx)
    conv_state = None if state is None else state["conv"]
    xi, Bm, Cm, tail = _conv_xbc(cfg, lp, xi, Bm, Cm, conv_state)

    dt, A = _dt_A(lp, dtv)                           # (B, S, H), (H,)
    xh = xi.reshape(b, s, h, p)
    Bh = Bm.reshape(b, s, g, n)
    Ch = Cm.reshape(b, s, g, n)

    h0 = None if state is None else state["ssm"]
    y, h_last = _scan(ctx, xh, dt, A, Bh, Ch, h0, chunk=min(64, s))
    y = y + xh * lp["D_skip"].to(y.dtype)[None, None, :, None]
    out = ctx.constrain(_gate_out(cfg, lp, y.reshape(b, s, di), z),
                        "batch seq d_model")
    hout = hin + out
    if state is None:
        return hout, None
    return hout, {"conv": tail, "ssm": h_last}


def _ssm_decode_block(cfg, lp, hin, state, ctx: ShardCtx = NULL_CTX):
    """Single-token step using the O(1) recurrent form."""
    di, h, p, n, g, conv_ch = _dims(cfg)
    b = hin.shape[0]
    x_in = rms_norm(hin, lp["norm"], cfg.norm_eps)
    z, xi, Bm, Cm, dtv = _proj_in(lp, x_in, ctx)
    xi1, Bm1, Cm1, tail = _conv_xbc(cfg, lp, xi, Bm, Cm, state["conv"])

    dt, A = _dt_A(lp, dtv[:, 0])                     # (B, H), (H,)
    xh = xi1[:, 0].reshape(b, h, p)
    Bh = Bm1[:, 0].reshape(b, g, n)
    Ch = Cm1[:, 0].reshape(b, g, n)
    y, h_new = ops.ssd_decode_step(xh, dt, A, Bh, Ch, state["ssm"])
    y = y + xh * lp["D_skip"].to(y.dtype)[None, :, None]
    out = _gate_out(cfg, lp, y.reshape(b, 1, di), z)
    return hin + out, {"conv": tail, "ssm": h_new}


# --------------------------------------------------------------------------- #
# forward / loss / serving                                                     #
# --------------------------------------------------------------------------- #
def _block(cfg, lp, h, ctx: ShardCtx = NULL_CTX):
    return ssm_block(cfg, lp, h, None, ctx)[0]


def forward(cfg, params: SSM, batch, ctx: ShardCtx = NULL_CTX):
    with ctx.scope():
        h = embed_tokens(batch["tokens"], params.embed, ctx)
        block = tf.remat_where_grad(cfg, functools.partial(_block, cfg), h,
                                    params)
        for lp in params.layers:
            h = block(lp, h, ctx)
        h = rms_norm(h, params.final_norm, cfg.norm_eps)
        return lm_logits(h, params.out_head, cfg.vocab_size, ctx)


def loss_fn(cfg, params: SSM, batch, ctx: ShardCtx = NULL_CTX):
    logits = forward(cfg, params, batch, ctx)
    with ctx.scope():
        loss = softmax_xent(logits, batch["labels"], batch.get("loss_mask"))
    return loss, {"loss": loss}


def make_train_step(cfg, optimizer, ctx: ShardCtx = NULL_CTX):
    return tf.make_train_step(cfg, optimizer, ctx, loss=loss_fn)


def cache_shapes(cfg, batch: int, seq_len: int) -> Dict:
    """The cache's tensors on the meta device (the reference's first half;
    ``cache_logical`` is its second)."""
    di, h, p, n, g, conv_ch = _dims(cfg)
    L, cw = cfg.num_layers, cfg.ssm_conv_width
    return {
        "conv": spec((L, batch, cw - 1, conv_ch), dtype_of(cfg)),
        "ssm": spec((L, batch, h, p, n), torch.float32),
        "lengths": spec((batch,), torch.int32),
    }


def cache_logical(cfg) -> Dict[str, str]:
    """The logical dims of ``cache_shapes``' tensors."""
    return {
        "conv": "layers batch . .",
        "ssm": "layers batch ssm_heads . .",
        "lengths": "batch",
    }


def prefill(cfg, params: SSM, batch, ctx: ShardCtx = NULL_CTX):
    """Run the full prompt from a zero state; returns (cache, last-position
    logits)."""
    with ctx.scope():
        return _prefill(cfg, params, batch, ctx)


def _prefill(cfg, params, batch, ctx):
    tokens = batch["tokens"]
    h = embed_tokens(tokens, params.embed, ctx)
    b, s = tokens.shape
    di, hh, p, n, g, conv_ch = _dims(cfg)
    zero = {
        "conv": torch.zeros((b, cfg.ssm_conv_width - 1, conv_ch),
                            dtype=h.dtype, device=h.device),
        "ssm": torch.zeros((b, hh, p, n), dtype=torch.float32,
                           device=h.device),
    }
    states = []
    for lp in params.layers:
        h, st = ssm_block(cfg, lp, h, zero, ctx)
        states.append(st)
    h = rms_norm(h, params.final_norm, cfg.norm_eps)
    logits = lm_logits(h[:, -1:], params.out_head, cfg.vocab_size, ctx)[:, 0]
    cache = dict(stacked(states),
                 lengths=torch.full((b,), s, dtype=torch.int32,
                                    device=h.device))
    return cache, logits


def decode_step(cfg, params: SSM, cache, batch, ctx: ShardCtx = NULL_CTX):
    """One token for every sequence. batch: {"token": (B,) int32}. Returns
    the new cache (new conv tails and states) with the lengths advanced by
    one."""
    with ctx.scope():
        h = embed_tokens(batch["token"][:, None], params.embed, ctx)
        states = []
        for lp, conv, ssm_st in zip(params.layers, cache["conv"],
                                    cache["ssm"]):
            h, st = _ssm_decode_block(cfg, lp, h,
                                      {"conv": conv, "ssm": ssm_st}, ctx)
            states.append(st)
        h = rms_norm(h, params.final_norm, cfg.norm_eps)
        logits = lm_logits(h, params.out_head, cfg.vocab_size, ctx)[:, 0]
        return dict(stacked(states), lengths=cache["lengths"] + 1), logits
