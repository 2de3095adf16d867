"""SSM family (mamba2-370m): attention-free SSD (state-space duality).

Port of ``repro.models.ssm`` at world size 1. Block: in-proj -> depthwise
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

Not here yet, as in transformer.py: ``loss_fn``, ``make_train_step``,
``input_specs``, ``roofline_units`` and ``param_logical``.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, ref
from repro_torch.kernels.ssd import ssd_bshp
from repro_torch.models.hybrid import causal_conv1d
from repro_torch.models.layers import (
    dtype_of,
    embed_tokens,
    lm_logits,
    rms_norm,
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
def _proj_in(lp, x_in):
    dt = x_in.dtype
    return tuple(torch.matmul(x_in, lp[name].to(dt))
                 for name in ("w_z", "w_x", "w_B", "w_C", "w_dt"))


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
        tail_src = F.pad(tail_src, (0, 0, pad, 0))
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


def ssm_block(cfg, lp, hin, state=None):
    """state: None (train) or {"conv": (B,cw-1,conv_ch), "ssm": (B,H,P,N)}."""
    di, h, p, n, g, conv_ch = _dims(cfg)
    b, s, _ = hin.shape
    x_in = rms_norm(hin, lp["norm"], cfg.norm_eps)
    z, xi, Bm, Cm, dtv = _proj_in(lp, x_in)
    conv_state = None if state is None else state["conv"]
    xi, Bm, Cm, tail = _conv_xbc(cfg, lp, xi, Bm, Cm, conv_state)

    dt, A = _dt_A(lp, dtv)                           # (B, S, H), (H,)
    xh = xi.reshape(b, s, h, p)
    Bh = Bm.reshape(b, s, g, n)
    Ch = Cm.reshape(b, s, g, n)

    h0 = None if state is None else state["ssm"]
    y, h_last = ssd_bshp(xh, dt, A, Bh, Ch, h0, chunk=min(64, s))
    y = y + xh * lp["D_skip"].to(y.dtype)[None, None, :, None]
    hout = hin + _gate_out(cfg, lp, y.reshape(b, s, di), z)
    if state is None:
        return hout, None
    return hout, {"conv": tail, "ssm": h_last}


def _ssm_decode_block(cfg, lp, hin, state):
    """Single-token step using the O(1) recurrent form."""
    di, h, p, n, g, conv_ch = _dims(cfg)
    b = hin.shape[0]
    x_in = rms_norm(hin, lp["norm"], cfg.norm_eps)
    z, xi, Bm, Cm, dtv = _proj_in(lp, x_in)
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
# forward / serving                                                            #
# --------------------------------------------------------------------------- #
def forward(cfg, params: SSM, batch):
    h = embed_tokens(batch["tokens"], params.embed)
    for lp in params.layers:
        h, _ = ssm_block(cfg, lp, h)
    h = rms_norm(h, params.final_norm, cfg.norm_eps)
    return lm_logits(h, params.out_head, cfg.vocab_size)


def cache_shapes(cfg, batch: int, seq_len: int) -> Dict:
    """The cache's tensors on the meta device (the JAX package also
    returns their logical sharding names, which belong to sharding, not
    ported yet)."""
    di, h, p, n, g, conv_ch = _dims(cfg)
    L, cw = cfg.num_layers, cfg.ssm_conv_width
    return {
        "conv": spec((L, batch, cw - 1, conv_ch), dtype_of(cfg)),
        "ssm": spec((L, batch, h, p, n), torch.float32),
        "lengths": spec((batch,), torch.int32),
    }


def prefill(cfg, params: SSM, batch):
    """Run the full prompt from a zero state; returns (cache, last-position
    logits)."""
    tokens = batch["tokens"]
    h = embed_tokens(tokens, params.embed)
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
        h, st = ssm_block(cfg, lp, h, zero)
        states.append(st)
    h = rms_norm(h, params.final_norm, cfg.norm_eps)
    logits = lm_logits(h[:, -1:], params.out_head, cfg.vocab_size)[:, 0]
    cache = dict(stacked(states),
                 lengths=torch.full((b,), s, dtype=torch.int32,
                                    device=h.device))
    return cache, logits


def decode_step(cfg, params: SSM, cache, batch):
    """One token for every sequence. batch: {"token": (B,) int32}. Returns
    the new cache (new conv tails and states) with the lengths advanced by
    one."""
    h = embed_tokens(batch["token"][:, None], params.embed)
    states = []
    for lp, conv, ssm_st in zip(params.layers, cache["conv"], cache["ssm"]):
        h, st = _ssm_decode_block(cfg, lp, h, {"conv": conv, "ssm": ssm_st})
        states.append(st)
    h = rms_norm(h, params.final_norm, cfg.norm_eps)
    logits = lm_logits(h, params.out_head, cfg.vocab_size)[:, 0]
    return dict(stacked(states), lengths=cache["lengths"] + 1), logits
