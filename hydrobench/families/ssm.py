"""Mamba2 (attention-free, state-space duality): the weights the benchmark
makes, and the plain float32 reference forward with a plain chunked SSD.

Weights are named and shaped as the program takes them (separate in
projections to z, x, B, C and dt, the depthwise conv over [x; B; C] as
(channels, width), a head of ``embedding_rows`` columns tied to the
embedding, as the published model's: the embedding's transpose) and
drawn on the card from the seed in two calls of the generator: the
matrices from a normal (std 0.02; the conv taps 0.3), and A and dt as
Mamba2 initialises them (A = -U[1, 16], dt log-uniform in [1e-3, 1e-1]
through dt_bias = softplus^-1(dt)); D one; norm scales zero (stored as
offsets from one).

The reference follows the Mamba2 block (arXiv:2405.21060, section 7):
in-projections of RMSNorm(x); a causal depthwise conv of width 4 over
[x; B; C] and SiLU; dt = softplus(dt_in + dt_bias), A = -exp(A_log); the
SSD scan y_t = C_t . sum_{s<=t} exp(A sum_{s<r<=t} dt_r) dt_s B_s x_s
plus D x_t, computed chunk by chunk (``ssd``: quadratic inside a chunk of
64, a recurrence of the states between chunks, as the paper's minimal
listing); a gated RMSNorm, RMSNorm(y * SiLU(z)); the out-projection and
the residual; final RMSNorm and the head.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

import hb_counts
from hb_reference import linear, rms_norm

CHUNK = 64
pad_to = CHUNK   # the scan takes whole chunks


def _dims(cfg):
    d = cfg["d_model"]
    di = cfg["expand"] * d
    p, n, g = cfg["headdim"], cfg["d_state"], cfg["ngroups"]
    return d, di, di // p, p, n, g


def row_flops(cfg: dict, n: int) -> float:
    """Model FLOPs of a forward over one row of ``n`` live tokens."""
    return hb_counts.ssm_row_flops(cfg, n)


def weight_shapes(cfg: dict) -> dict:
    d, di, h, p, n, g = _dims(cfg)
    L, cw = cfg["n_layer"], cfg["d_conv"]
    conv = di + 2 * g * n
    return {
        "embed": (cfg["embedding_rows"], d),
        "out_head": (d, cfg["embedding_rows"]),
        "final_norm": (d,),
        "layers.norm": (L, d),
        "layers.w_z": (L, d, di),
        "layers.w_x": (L, d, di),
        "layers.w_B": (L, d, g * n),
        "layers.w_C": (L, d, g * n),
        "layers.w_dt": (L, d, h),
        "layers.dt_bias": (L, h),
        "layers.A_log": (L, h),
        "layers.D_skip": (L, h),
        "layers.conv_w": (L, conv, cw),
        "layers.conv_b": (L, conv),
        "layers.gated_norm": (L, di),
        "layers.w_out": (L, di, d),
    }


_NORMAL = {"embed": 0.02, "layers.w_z": 0.02,
           "layers.w_x": 0.02, "layers.w_B": 0.02, "layers.w_C": 0.02,
           "layers.w_dt": 0.02, "layers.w_out": 0.02, "layers.conv_w": 0.3,
           "layers.conv_b": 0.02}


def make_weights(cfg: dict, generator: torch.Generator, device,
                 dtype) -> dict:
    """Every leaf of ``weight_shapes`` in ``dtype`` on ``device``."""
    shapes = weight_shapes(cfg)
    total = sum(math.prod(shapes[k]) for k in _NORMAL)
    flat = torch.randn(total, generator=generator, device=device,
                       dtype=dtype)
    out, at = {}, 0
    for k, std in _NORMAL.items():
        n = math.prod(shapes[k])
        out[k] = flat[at:at + n].view(shapes[k]).mul_(std)
        at += n
    out["out_head"] = out["embed"].t().contiguous()
    L, h = shapes["layers.A_log"]
    u = torch.rand((2, L, h), generator=generator, device=device,
                   dtype=torch.float32)
    out["layers.A_log"] = torch.log(1.0 + 15.0 * u[0]).to(dtype)
    dt = torch.exp(math.log(1e-3) + u[1] * (math.log(1e-1) - math.log(1e-3)))
    out["layers.dt_bias"] = (dt + torch.log(-torch.expm1(-dt))).to(dtype)
    out["layers.D_skip"] = torch.ones((L, h), device=device, dtype=dtype)
    for k in ("final_norm", "layers.norm", "layers.gated_norm"):
        out[k] = torch.zeros(shapes[k], device=device, dtype=dtype)
    return out


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., T) -> (..., T, T): sum of x over (j, i] at [i, j], -inf above
    the diagonal."""
    t = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    keep = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    return out.masked_fill(~keep, float("-inf"))


def ssd(x, dt, A, B, C):
    """Chunked SSD. x (R, S, H, P), dt (R, S, H), A (H,), B, C (R, S, G,
    N); S a multiple of CHUNK. Returns y (R, S, H, P)."""
    r, s, h, p = x.shape
    g = B.shape[2]
    B = B.repeat_interleave(h // g, dim=2)
    C = C.repeat_interleave(h // g, dim=2)
    c = s // CHUNK
    xc = x.reshape(r, c, CHUNK, h, p)
    dtc = dt.reshape(r, c, CHUNK, h)
    Bc = B.reshape(r, c, CHUNK, h, -1)
    Cc = C.reshape(r, c, CHUNK, h, -1)
    a = (dtc * A).permute(0, 3, 1, 2)                  # (R, H, c, L)
    a_cum = torch.cumsum(a, dim=-1)
    xdt = xc * dtc[..., None]
    # inside each chunk
    decay = torch.exp(_segsum(a))                      # (R, H, c, L, L)
    y_diag = torch.einsum("rclhn,rcshn,rhcls,rcshp->rclhp", Cc, Bc, decay,
                          xdt)
    # each chunk's state, then the states entering each chunk
    to_end = torch.exp(a_cum[..., -1:] - a_cum)        # (R, H, c, L)
    states = torch.einsum("rclhn,rhcl,rclhp->rchpn", Bc, to_end, xdt)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    chunk_decay = torch.exp(_segsum(F.pad(a_cum[..., -1], (1, 0))))
    states = torch.einsum("rhzc,rchpn->rzhpn", chunk_decay, states)[:, :-1]
    # the states' share of each position's output
    y_off = torch.einsum("rclhn,rchpn,rhcl->rclhp", Cc, states,
                         torch.exp(a_cum))
    return (y_diag + y_off).reshape(r, s, h, p)


def forward(cfg: dict, w: dict, tokens: torch.Tensor, quant=None):
    """(R, n) token ids, n a multiple of CHUNK -> (R, n, vocab) float32
    logits."""
    d, di, h, p, n, g = _dims(cfg)
    eps, cw = cfg["rms_norm_eps"], cfg["d_conv"]
    f32 = torch.float32
    x = w["embed"].to(f32)[tokens]
    r, s, _ = x.shape
    for i in range(cfg["n_layer"]):
        lw = {k.split(".", 1)[1]: t[i].to(f32) for k, t in w.items()
              if k.startswith("layers.")}
        u = rms_norm(x, lw["norm"], eps)
        z = linear(u, lw["w_z"], quant)
        xbc = torch.cat([linear(u, lw["w_x"], quant),
                         linear(u, lw["w_B"], quant),
                         linear(u, lw["w_C"], quant)], dim=-1)
        dtv = linear(u, lw["w_dt"], quant)
        padded = F.pad(xbc, (0, 0, cw - 1, 0))
        conv = sum(padded[:, j:j + s] * lw["conv_w"][:, j]
                   for j in range(cw)) + lw["conv_b"]
        conv = F.silu(conv)
        xi, Bm, Cm = conv.split([di, g * n, g * n], dim=-1)
        dt = F.softplus(dtv + lw["dt_bias"])
        A = -torch.exp(lw["A_log"])
        xh = xi.reshape(r, s, h, p)
        y = ssd(xh, dt, A, Bm.reshape(r, s, g, n), Cm.reshape(r, s, g, n))
        y = y + xh * lw["D_skip"][None, None, :, None]
        y = rms_norm(y.reshape(r, s, di) * F.silu(z), lw["gated_norm"], eps)
        x = x + linear(y, lw["w_out"], quant)
    x = rms_norm(x, w["final_norm"].to(f32), eps)
    return linear(x, w["out_head"][:, :cfg["vocab_size"]], quant)
