"""RG-LRU linear recurrence (recurrentgemma / Griffin), for Hopper.

Port of ``repro.kernels.rglru``. For a CUDA tensor ``rglru_bsw`` launches
the hand-written kernel in ``csrc/rglru.cu`` or raises, and
``rglru_tokens`` launches its token-fed entry (the same staged kernel
gathering x, r and i from embedding tables by token id); for a CPU tensor
each runs its plain version in ``ref.py``. ``launches`` counts kernel
launches of both entries, so a run can show that it went through the
kernel.

``route(b, s, w)`` names the kernel's design a call takes, by shape
alone (see the source's note): the staged design (a CTA per row
and tile of channels: the terms formed in parallel into shared memory,
then the chain walked in order) for a single step (a decode step) and at
the predicates' width; the pipelined one (term warps and a walker warp
handing chunks on through mbarriers) everywhere else, with 16 term warps
while one CTA an SM fills the card and 8, two CTAs an SM, beyond. The kernel has a float32 and a bfloat16 instance:
bf16 x, r and i are read and out and h_last written as they are, with no
float32 copies and no casts (a_param and h0 may be either dtype).

``rglru_bsw`` is differentiable. When grad mode is on and an input
requires a gradient, it goes through ``Rglru``, a
``torch.autograd.Function``: its forward keeps the float32 h sequence,
which the same launch writes beside a bf16 output, and its backward is
``rglru_bwd``, the hand-written gradient kernel in ``csrc/rglru_bwd.cu``
on the card (``backward_launches`` counts its calls) and ``ref.rglru_bwd``
on the CPU. The JAX package differentiates its plain scan instead: its
Pallas kernel has no backward. ``rglru_tokens`` refuses a gradient: only
the predicates call it.
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
# 0, out, h_last, hs or 0; B, S, W and c; whether x, r, i, out and h_last,
# a_param and h0 are bfloat16; the design) and RglruTokensArgs (toks,
# emb_x, emb_r, emb_i, a_param, h0 or 0, out, h_last; B, S, W, V, c and a
# pad) in the source
ARGS = struct.Struct("<8Q3if4i")
TOKENS_ARGS = struct.Struct("<8Q4ifi")
# the gradient entry point's (RglruBwdArgs): x, r, i, a_param, h0 or 0, hs,
# dout, dh_last or 0, dx, dr, di, dh0 or 0, the dL scratch, dL; B, S, W
# and c; whether x, r, i, dout, dx, dr and di are bfloat16; a pad
BWD_ARGS = struct.Struct("<14Q3if2i")
_entries: dict = {}  # the library's C functions, looked up once

# the designs of csrc/rglru.cu (RglruArgs.design)
STAGED, PIPELINED, PIPELINED_PAIRS = 0, 1, 2
DESIGNS = ("staged", "pipelined, 16 term warps",
           "pipelined, 8 term warps, two CTAs an SM")
TILE = 32          # channels a CTA walks, in both designs
STAGED_MAX_W = 16  # the predicates' width: half a tile or less stays staged
SMS = 132          # an H100's SMs: the CTAs one wave of design 1 takes


def route(b: int, s: int, w: int) -> int:
    """The design ``rglru_bsw`` takes on (B, S, W) inputs of either dtype:
    ``STAGED`` for a single step (a decode step) or at most
    ``STAGED_MAX_W`` channels (the predicates' width), else ``PIPELINED``
    while the B * ceil(W / TILE) CTAs fit one to an SM and
    ``PIPELINED_PAIRS`` beyond (chip_smoke.py's phase 3 times each design
    at these boundaries)."""
    if s < 2 or w <= STAGED_MAX_W:
        return STAGED
    return PIPELINED if b * -(-w // TILE) <= SMS else PIPELINED_PAIRS


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
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _launch(fn: str, args: bytes, dev: int) -> None:
    """Call entry ``fn`` of the library with packed ``args`` on the
    current stream of card ``dev``; count the launch."""
    global launches
    entry = _entries.get(fn)
    if entry is None:
        entry = _entries[fn] = getattr(_build.load("rglru").lib, fn)
    err = entry(args, _build.raw_stream(dev))
    if err != 0:
        raise RuntimeError(f"rglru kernel launch failed: CUDA error {err}")
    with _COUNT_LOCK:
        launches += 1


def pack_args(x, r, i, a_param, h0, out, h_last, hs=None, *,
              c: float = 8.0, design: int | None = None) -> bytes:
    """``rglru_bsw``'s packed arguments (RglruArgs) for contiguous tensors
    on the card: x, r, i, out and h_last all float32 or all bfloat16,
    a_param and h0 (or None) each either, hs (float32) or None; the design
    ``route``'s unless given."""
    b, s, w = x.shape
    bf16 = torch.bfloat16
    return ARGS.pack(
        *[0 if t is None else t.data_ptr()
          for t in (x, r, i, a_param, h0, out, h_last, hs)],
        b, s, w, float(c), x.dtype == bf16, a_param.dtype == bf16,
        h0 is not None and h0.dtype == bf16,
        route(b, s, w) if design is None else design)


def _as(t: torch.Tensor, dtype) -> torch.Tensor:
    """``t`` contiguous in ``dtype``: itself when it already is."""
    if t.dtype == dtype and t.is_contiguous():
        return t
    return t.to(dtype).contiguous()


def _either(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous in its dtype where the kernel reads that dtype
    (float32, bfloat16), else in float32."""
    return _as(t, t.dtype if t.dtype in _KERNEL_DTYPES else torch.float32)


def _forward(x, r, i, a_param, h0, c: float, keep_hs: bool):
    """(out, h_last, hs): out and h_last in x's dtype; hs, the float32 h
    sequence (out itself in float32), only with ``keep_hs``, else None.
    On the card one launch of ``rglru_bsw``: its bf16 instance where x, r
    and i are all bfloat16 (a_param and h0 read as they are when float32
    or bfloat16), else its float32 one on float32 copies; on the CPU the
    plain version on float32 copies."""
    b, s, w = x.shape
    f32 = torch.float32
    if not _build.on_card(x):
        if x.device.type != "cpu":
            raise ValueError(f"rglru_bsw runs on cpu or cuda, not {x.device}")
        out, h_last = ref.rglru(x.to(f32), r.to(f32), i.to(f32), a_param, h0,
                                c=c)
        return out.to(x.dtype), h_last.to(x.dtype), out if keep_hs else None
    bf16 = x.dtype == r.dtype == i.dtype == torch.bfloat16
    kd = torch.bfloat16 if bf16 else f32
    big = [_as(t, kd) for t in (x, r, i)]
    lam = _either(a_param)
    st = None if h0 is None else _either(h0)
    dev = x.get_device()
    if any(t.get_device() != dev for t in (*big, lam, st) if t is not None):
        raise ValueError(f"all inputs must lie on {x.device}")
    out = torch.empty((b, s, w), dtype=kd, device=x.device)
    h_last = torch.empty((b, w), dtype=kd, device=x.device)
    hs = torch.empty((b, s, w), dtype=f32, device=x.device) \
        if keep_hs and bf16 else None
    if not _build.traced("rglru", FLOPS * out.numel(), (*big, lam, st),
                         (out, h_last, hs)):
        _launch("rglru_bsw", pack_args(*big, lam, st, out, h_last, hs, c=c),
                dev)
    if keep_hs and not bf16:
        hs = out
    if kd != x.dtype:
        out, h_last = out.to(x.dtype), h_last.to(x.dtype)
    return out, h_last, hs


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
    sequence for the backward, ``rglru_bwd`` (in a bf16 model written by
    the same launch beside the bf16 output); the gradients come back in
    the inputs' dtypes (a bf16 model's dx, dr and di straight from the
    kernel's bf16 instance, with no cast), and a cotangent autograd leaves
    out (None) is zero. Under remat the forward runs again in the backward
    pass (and counts again in ``launches``)."""

    @staticmethod
    def forward(ctx, x, r, i, a_param, h0, c):
        ctx.set_materialize_grads(False)
        out, h_last, hs = _forward(x, r, i, a_param, h0, c, keep_hs=True)
        ctx.save_for_backward(x, r, i, a_param, h0, hs)
        ctx.c = c
        return out, h_last

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
    free; the design by ``route``. Differentiable (``Rglru``)."""
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
    return _forward(x, r, i, a_param, h0, c, keep_hs=False)[:2]


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
    tabs = [_build.f32_contiguous(t) for t in (emb_x, emb_r, emb_i, a_param)]
    st = None if h0 is None else _build.f32_contiguous(h0)
    dev = toks.get_device()
    if any(t.get_device() != dev for t in (*tabs, st) if t is not None):
        raise ValueError(f"all inputs must lie on {toks.device}")
    out = torch.empty((b, s, w), dtype=torch.float32, device=toks.device)
    h_last = torch.empty((b, w), dtype=torch.float32, device=toks.device)
    _build.refuse_fake("rglru", ids, *tabs, st, out, h_last)
    _launch("rglru_tokens", TOKENS_ARGS.pack(
        ids.data_ptr(), *(t.data_ptr() for t in tabs),
        0 if st is None else st.data_ptr(), out.data_ptr(), h_last.data_ptr(),
        b, s, w, v, float(c), 0), dev)
    return out, h_last
