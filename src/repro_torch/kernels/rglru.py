"""RG-LRU linear recurrence (recurrentgemma / Griffin), for Hopper.

Port of ``repro.kernels.rglru``. For a CUDA tensor ``rglru_bsw`` launches
the hand-written kernel in ``csrc/rglru.cu`` (a CTA per row and tile of
channels: the terms formed in parallel into shared memory, then the
chain walked in order, see the source's note) or raises, and
``rglru_tokens`` launches its token-fed entry (the same kernel gathering
x, r and i from embedding tables by token id); for a CPU tensor each runs
its plain version in ``ref.py``. ``launches`` counts kernel launches of
both entries, so a run can show that it went through the kernel.

``rglru_bsw`` is differentiable. When grad mode is on and an input
requires a gradient, it goes through ``Rglru``, a
``torch.autograd.Function``: its forward keeps the float32 h sequence the
kernel writes, and its backward is ``rglru_bwd``, the hand-written
gradient kernel in ``csrc/rglru_bwd.cu`` on the card
(``backward_launches`` counts its calls) and ``ref.rglru_bwd`` on the
CPU. The JAX package differentiates its plain scan instead: its Pallas
kernel has no backward. ``rglru_tokens`` refuses a gradient: only the
predicates call it.
"""
from __future__ import annotations

import struct
import threading

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.launch import refuse_grad

launches = 0           # forward launches of both entries
backward_launches = 0  # gradient kernel calls (two launches each)
_COUNT_LOCK = threading.Lock()

# the C entry points' packed arguments: RglruArgs (x, r, i, a_param, h0 or
# 0, out, h_last; B, S, W and c) and RglruTokensArgs (toks, emb_x, emb_r,
# emb_i, a_param, h0 or 0, out, h_last; B, S, W, V, c and a pad) in the
# source
ARGS = struct.Struct("<7Q3if")
TOKENS_ARGS = struct.Struct("<8Q4ifi")
# the gradient entry point's (RglruBwdArgs): x, r, i, a_param, h0 or 0, hs,
# dout, dh_last or 0, dx, dr, di, dh0 or 0, the dL scratch, dL; B, S, W
# and c; whether x, r, i, dout, dx, dr and di are bfloat16; a pad
BWD_ARGS = struct.Struct("<14Q3if2i")
_entries: dict = {}  # the library's C functions, looked up once


def _check_state(a_param: torch.Tensor, h0, b: int, w: int) -> None:
    if tuple(a_param.shape) != (w,) or (
            h0 is not None and tuple(h0.shape) != (b, w)):
        raise ValueError(f"a_param must be ({w},) and h0 ({b}, {w}) or None, "
                         f"got {tuple(a_param.shape)} and "
                         f"{None if h0 is None else tuple(h0.shape)}")


FLOPS = 12      # the forward's operations an element (``udfs/rooflines.rglru``)
# the gradient's (csrc/rglru_bwd.cu: two sigmoids, a's exp, the terms of
# dx, di, da, dr and dL, the walk)
BWD_FLOPS = 35


def _launch(fn: str, pack, ins: list, h0, out_shape: tuple, dev: int,
            device: torch.device):
    """Launch entry ``fn`` on float32 contiguous copies of ``ins`` and h0
    (None: a null pointer, the kernel's zero state); ``pack(pointers, out,
    h_last)`` packs the arguments. Returns (out, h_last) float32."""
    global launches
    if h0 is not None:
        ins.append(_build.f32_contiguous(h0))
    if any(t.get_device() != dev for t in ins):
        raise ValueError(f"all inputs must lie on {device}")
    out = torch.empty(out_shape, dtype=torch.float32, device=device)
    h_last = torch.empty((out_shape[0], out_shape[2]), dtype=torch.float32,
                         device=device)
    if fn != "rglru_bsw":   # the token entry is the predicates', not the models'
        _build.refuse_fake("rglru", *ins, out, h_last)
    elif _build.traced("rglru", FLOPS * out.numel(), ins, (out, h_last)):
        return out, h_last
    ptrs = [t.data_ptr() for t in ins] + ([] if h0 is not None else [0])
    entry = _entries.get(fn)
    if entry is None:
        entry = _entries[fn] = getattr(_build.load("rglru").lib, fn)
    err = entry(pack(ptrs, out.data_ptr(), h_last.data_ptr()),
                _build.raw_stream(dev))
    if err != 0:
        raise RuntimeError(f"rglru kernel launch failed: CUDA error {err}")
    with _COUNT_LOCK:
        launches += 1
    return out, h_last


def _forward_f32(x, r, i, a_param, h0, c: float):
    """(out, h_last) in float32: the kernel's on the card, the plain
    version's on float32 copies on the CPU."""
    b, s, w = x.shape
    if not _build.on_card(x):
        if x.device.type != "cpu":
            raise ValueError(f"rglru_bsw runs on cpu or cuda, not {x.device}")
        f32 = torch.float32
        return ref.rglru(x.to(f32), r.to(f32), i.to(f32), a_param, h0, c=c)
    return _launch(
        "rglru_bsw",
        lambda p, o, hl: ARGS.pack(*p, o, hl, b, s, w, float(c)),
        [_build.f32_contiguous(t) for t in (x, r, i, a_param)], h0,
        (b, s, w), x.get_device(), x.device)


def rglru_bwd(x, r, i, a_param, h0, hs, dout, dh_last, *, c: float = 8.0):
    """(dx, dr, di, da_param, dh0), the gradient of ``rglru_bsw``
    (formulas in ``ref.rglru_bwd``) for the cotangents ``dout`` (B, S, W)
    and ``dh_last`` (B, W) or None, given the forward's float32 h sequence
    ``hs``; dh0 is None when h0 is. dx, dr and di are bfloat16 when x, r,
    i and dout all are (float32 rounded once, to nearest even), float32
    otherwise; da_param and dh0 float32. On the card one call of the
    gradient kernel (two launches: the walk, then dL summed over the rows
    in order), whose bf16 instance reads and writes the bf16 tensors as
    they are; on the CPU the plain version."""
    global backward_launches
    bf16 = all(t.dtype == torch.bfloat16 for t in (x, r, i, dout))
    if not _build.on_card(x):
        if x.device.type != "cpu":
            raise ValueError(f"rglru_bwd runs on cpu or cuda, not {x.device}")
        grads = ref.rglru_bwd(x, r, i, a_param, h0, hs, dout, dh_last, c=c)
        if bf16:
            grads = (*(g.to(torch.bfloat16) for g in grads[:3]), *grads[3:])
        return grads
    b, s, w = x.shape
    dev = x.get_device()
    if bf16:
        big = [t.contiguous() for t in (x, r, i, dout)]
    else:
        big = [_build.f32_contiguous(t) for t in (x, r, i, dout)]
    lam = _build.f32_contiguous(a_param)
    h0f = None if h0 is None else _build.f32_contiguous(h0)
    hs = _build.f32_contiguous(hs)
    dhl = None if dh_last is None else _build.f32_contiguous(dh_last)
    if any(t is not None and t.get_device() != dev
           for t in (*big, lam, h0f, hs, dhl)):
        raise ValueError(f"all inputs must lie on {x.device}")
    dx, dr, di = (torch.empty_like(big[0]) for _ in range(3))
    dh0 = None if h0 is None else torch.empty_like(h0f)
    part = torch.empty((b, w), dtype=torch.float32, device=x.device)
    da = torch.empty((w,), dtype=torch.float32, device=x.device)

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    if _build.traced("rglru_bwd", BWD_FLOPS * b * s * w,
                     (*big, lam, h0f, hs, dhl), (dx, dr, di, dh0, part, da)):
        return dx, dr, di, da, dh0
    entry = _entries.get("rglru_bwd")
    if entry is None:
        entry = _entries["rglru_bwd"] = _build.load("rglru_bwd").lib.rglru_bwd
    xb, rb, ib, dob = big
    err = entry(BWD_ARGS.pack(*(ptr(t) for t in (
        xb, rb, ib, lam, h0f, hs, dob, dhl, dx, dr, di, dh0, part, da)),
        b, s, w, float(c), bf16, 0), _build.raw_stream(dev))
    if err != 0:
        raise RuntimeError(f"rglru_bwd kernel launch failed: CUDA error {err}")
    with _COUNT_LOCK:
        backward_launches += 1
    return dx, dr, di, da, dh0


class Rglru(torch.autograd.Function):
    """``rglru_bsw`` with its gradient: ``apply(x, r, i, a_param, h0, c)``
    -> (out, h_last) in x's dtype. The forward keeps the float32 h
    sequence for the backward, ``rglru_bwd``; the gradients come back in
    the inputs' dtypes (a bf16 model's dx, dr and di straight from the
    kernel's bf16 instance, with no cast), and a cotangent autograd leaves
    out (None) is zero. Under remat the forward runs again in the backward
    pass (and counts again in ``launches``)."""

    @staticmethod
    def forward(ctx, x, r, i, a_param, h0, c):
        ctx.set_materialize_grads(False)
        out, h_last = _forward_f32(x, r, i, a_param, h0, c)
        ctx.save_for_backward(x, r, i, a_param, h0, out)
        ctx.c = c
        return out.to(x.dtype), h_last.to(x.dtype)

    @staticmethod
    def backward(ctx, dout, dh_last):
        x, r, i, a_param, h0, hs = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros_like(x)
        grads = rglru_bwd(x, r, i, a_param, h0, hs, dout, dh_last, c=ctx.c)
        return (*(None if g is None else g.to(t.dtype)
                  for g, t in zip(grads, (x, r, i, a_param, h0))), None)


def rglru_bsw(
    x: torch.Tensor,        # (B, S, W)
    r: torch.Tensor,        # (B, S, W)
    i: torch.Tensor,        # (B, S, W)
    a_param: torch.Tensor,  # (W,)
    h0: torch.Tensor | None,  # (B, W); None: a zero state
    *,
    c: float = 8.0,
):
    """(out (B, S, W), h_last (B, W)), both in x's dtype. S and W are
    free. Differentiable (``Rglru``)."""
    if x.dim() != 3:
        raise ValueError(f"x must be (B, S, W), got {tuple(x.shape)}")
    b, s, w = x.shape
    if r.shape != x.shape or i.shape != x.shape:
        raise ValueError(f"r and i must match x {tuple(x.shape)}, got "
                         f"{tuple(r.shape)} and {tuple(i.shape)}")
    _check_state(a_param, h0, b, w)
    if b == 0 or w == 0:
        return torch.zeros_like(x), torch.zeros((b, w), dtype=x.dtype,
                                                device=x.device)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, r, i, a_param, h0)):
        return Rglru.apply(x, r, i, a_param, h0, c)
    if not _build.on_card(x):
        if x.device.type != "cpu":
            raise ValueError(f"rglru_bsw runs on cpu or cuda, not {x.device}")
        return ref.rglru(x, r, i, a_param, h0, c=c)
    out, h_last = _forward_f32(x, r, i, a_param, h0, c)
    if x.dtype != torch.float32:
        out, h_last = out.to(x.dtype), h_last.to(x.dtype)
    return out, h_last


def rglru_tokens(
    toks: torch.Tensor,     # (B, S) int32 token ids
    emb_x: torch.Tensor,    # (V, W)
    emb_r: torch.Tensor,    # (V, W)
    emb_i: torch.Tensor,    # (V, W)
    a_param: torch.Tensor,  # (W,)
    h0: torch.Tensor | None = None,  # (B, W); None: a zero state
    *,
    c: float = 8.0,
):
    """(out (B, S, W), h_last (B, W)) float32: ``rglru_bsw(emb_x[toks],
    emb_r[toks], emb_i[toks], a_param, h0)`` bit for bit, in one launch on
    the card, whose loads gather each staged row from the tables by token
    id. The caller keeps the ids in [0, V): on the card an id outside is
    taken as the JAX package's gather takes it (the predicate refuses such
    ids on the host); the plain version's indexing raises or wraps."""
    refuse_grad("rglru", emb_x, emb_r, emb_i, a_param, h0)
    if toks.dim() != 2 or emb_x.dim() != 2:
        raise ValueError(f"need toks (B, S) and tables (V, W), got "
                         f"{tuple(toks.shape)} and {tuple(emb_x.shape)}")
    b, s = toks.shape
    v, w = emb_x.shape
    if emb_r.shape != emb_x.shape or emb_i.shape != emb_x.shape:
        raise ValueError(f"the tables must match emb_x {tuple(emb_x.shape)}, "
                         f"got {tuple(emb_r.shape)} and {tuple(emb_i.shape)}")
    _check_state(a_param, h0, b, w)
    if b == 0 or w == 0:
        return (torch.zeros((b, s, w), dtype=torch.float32, device=toks.device),
                torch.zeros((b, w), dtype=torch.float32, device=toks.device))
    if v == 0:
        raise ValueError("the tables are empty")
    if not toks.is_cuda:
        if toks.device.type != "cpu":
            raise ValueError(f"rglru_tokens runs on cpu or cuda, not "
                             f"{toks.device}")
        return ref.rglru_tokens(toks, emb_x, emb_r, emb_i, a_param, h0, c=c)
    ids = toks if toks.dtype == torch.int32 and toks.is_contiguous() else \
        toks.to(torch.int32).contiguous()
    return _launch(
        "rglru_tokens",
        lambda p, o, hl: TOKENS_ARGS.pack(*p, o, hl, b, s, w, v, float(c), 0),
        [ids] + [_build.f32_contiguous(t)
                 for t in (emb_x, emb_r, emb_i, a_param)],
        h0, (b, s, w), toks.get_device(), toks.device)
