"""Blocked causal / sliding-window flash attention with GQA, for Hopper.

Port of ``repro.kernels.flash_attention``. For a CUDA tensor the wrappers
launch the hand-written kernel in ``csrc/flash_attention.cu`` or raise; for
a CPU tensor they run the plain version in ``ref.py``. The kernel has
three designs (see the source's note): bf16 runs wgmma tiles of 64 query
rows fed by a TMA ring (by the producer warp's own loads for views that
are not 16-byte aligned), in persistent CTAs whose two or three consumer
warpgroups share each K/V stage (at D <= 64 on key tiles of 128), or, where
the kv group is 1 and Sq fits one tile and at D <= 64 where three
warpgroups do not divide the kv group, a CTA a query tile; float32 runs
3xTF32 mma.sync tiles fed by cp.async; ``route`` tells which a call takes. The kernel reads
every operand through its strides, so ``flash_attention_bshd`` takes the
model's (B, S, H, D) views as they are and writes (B, S, H, D).
``launches`` counts kernel launches (one a call), so a run can show that
it went through the kernel.

Both wrappers are differentiable. When grad mode is on and q, k or v
requires a gradient, they go through ``FlashAttention``, a
``torch.autograd.Function``: its forward launches the same kernel with an
extra float32 output, each row's log-sum-exp, and its backward launches
the hand-written gradient kernel in ``csrc/flash_attention_bwd.cu`` on the
card (``backward_launches`` counts those calls) and runs
``ref.flash_attention_bwd`` on the CPU. Serving (inference mode,
parameters without gradients) calls the kernel directly, with no LSE.
The JAX package differentiates its plain XLA attention instead: no Pallas
kernel there has a backward.

A layout is the triple of element strides (between sequences, between
heads, between rows) through which the attention kernels walk an operand
whose last dimension is contiguous; rows are positions, or query heads for
decode's query and output. The kernels only multiply these.
"""
from __future__ import annotations

import struct
import threading

import numpy as np
import torch

from repro_torch.kernels import _build, ref

MAX_HEAD_DIM = 256  # the kernel's widest tile
DTYPES = (torch.float32, torch.bfloat16)

# the gradient kernel's widest head: the forward's, so that every head the
# card runs forward it can also train (at D = 256 its CTAs split the
# output columns, see the source's note)
MAX_BWD_HEAD_DIM = MAX_HEAD_DIM

launches = 0          # forward kernel launches
backward_launches = 0  # gradient kernel calls (three launches each)
_COUNT_LOCK = threading.Lock()


def bshd_layout(t: torch.Tensor) -> tuple:
    """The layout of a (B, S, H, D) view."""
    s = t.stride()
    return s[0], s[2], s[1]


def bhsd_layout(t: torch.Tensor, heads: int) -> tuple:
    """The layout of a (B * heads, S, D) tensor taken as B sequences of
    ``heads`` heads each."""
    s = t.stride()
    return heads * s[0], s[0], s[1]


def program_offsets(layout: tuple, programs: int, heads: int,
                    group: int = 1) -> list:
    """Element offset of row 0 of each program's operand, as the kernels
    compute it: program p = b * heads + h reads head h // group of
    sequence b (group 1 for q and o, H // Hkv for k and v)."""
    return [(p // heads) * layout[0] + (p % heads) // group * layout[1]
            for p in range(programs)]


# the C entry point's packed arguments (FlashArgs in the source): q, k, v,
# o and lse (0: none); their layouts (lse has none: contiguous (batch *
# heads, Sq)); batch, heads, group, Sq, Sk, D, causal, window, bf16; scale
ARGS = struct.Struct("<5Q12q9if")
# the gradient entry point's (FlashBwdArgs): q, k, v, o, dO, lse, delta
# (scratch), dQ, dK, dV; the layouts of all but lse and delta; then as ARGS
BWD_ARGS = struct.Struct("<10Q24q9if")


def pack_args(q, k, v, out, layouts, batch: int, heads: int, group: int,
              sq: int, sk: int, causal: bool, window: int,
              scale: float, lse: torch.Tensor | None = None) -> bytes:
    """The kernel's arguments in one buffer: program b * heads + h of
    ``batch`` sequences reads kv head h // group; each operand is read or
    written through its own layout; ``lse``, if given, a contiguous
    float32 (batch * heads, Sq) that gets each row's log-sum-exp."""
    lq, lk, lv, lo = layouts
    return ARGS.pack(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     0 if lse is None else lse.data_ptr(),
                     *lq, *lk, *lv, *lo, batch, heads, group, sq, sk,
                     q.shape[-1], causal, window, q.dtype == torch.bfloat16,
                     scale)


def pack_bwd_args(q, k, v, out, dout, lse, delta, dq, dk, dv, layouts,
                  batch: int, heads: int, group: int, sq: int, sk: int,
                  causal: bool, window: int, scale: float) -> bytes:
    """The gradient kernel's arguments in one buffer, as ``pack_args``:
    ``layouts`` holds those of q, k, v, o, dO, dQ, dK and dV; ``lse`` (from
    the forward) and ``delta`` (scratch) are contiguous float32 (batch *
    heads, Sq)."""
    ptrs = (q, k, v, out, dout, lse, delta, dq, dk, dv)
    return BWD_ARGS.pack(*(t.data_ptr() for t in ptrs),
                         *(x for lay in layouts for x in lay), batch, heads,
                         group, sq, sk, q.shape[-1], causal, window,
                         q.dtype == torch.bfloat16, scale)


def _check(q, k, v) -> None:
    """Raise on dtypes the kernel and the plain version do not take."""
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k and v must share a dtype in {DTYPES}, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")


def visible_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask leaves between Sq queries and Sk keys,
    both from position 0."""
    i = np.arange(sq)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros_like(i)
    hi = np.minimum(i + 1, sk) if causal else np.full_like(i, sk)
    return int(np.maximum(hi - lo, 0).sum())


def flops(programs: int, d: int, sq: int, sk: int, causal: bool,
          window: int, backward: bool = False) -> int:
    """Operations of a call: 4 a visible (query, key) pair and dim forward
    (two products), 10 for the gradient (five)."""
    return ((10 if backward else 4) * programs * d
            * visible_pairs(sq, sk, causal, window))


# flash_attention_route's answers: the design a call takes (bf16: a CTA a
# query tile where the kv group is 1 and Sq fits one tile, and at D <= 64
# where three warpgroups do not divide the kv group; else the shared
# design; each fed by TMA, or by the producer warp's own loads for views
# that are not 16-byte aligned)
ROUTES = {4: "bf16 wgmma shared stages, TMA ring",
          3: "bf16 wgmma shared stages, producer loads",
          2: "bf16 wgmma, TMA ring", 1: "bf16 wgmma, producer loads",
          0: "float32 mma.sync", -1: "refused"}
# the routes that load by TMA
TMA_ROUTES = (ROUTES[4], ROUTES[2])
# flash_attention_variant's bf16 designs, by number (0: the routed one),
# for timing the two against one another at any shape
VARIANTS = {1: "a CTA a query tile", 2: "shared stages"}


def route(q, k, v, *, causal: bool = True, window: int = 0,
          scale: float | None = None) -> str:
    """The design ``flash_attention_bshd`` takes on the card for these
    (B, S, H, D) views (``ROUTES``), from the library's
    ``flash_attention_route``, which launches nothing."""
    b, sq, h, d = q.shape
    scale = d ** -0.5 if scale is None else scale
    lays = tuple(map(bshd_layout, (q, k, v, q)))
    fn = _build.load("flash_attention").lib.flash_attention_route
    return ROUTES[fn(pack_args(q, k, v, q, lays, b, h, h // k.shape[2], sq,
                               k.shape[1], causal, window, scale))]


_entry = None      # the library's C function, looked up once
_bwd_entry = None  # the gradient library's


def _launch(q, k, v, out, layouts, batch: int, heads: int, group: int,
            sq: int, sk: int, causal: bool, window: int,
            scale: float, lse: torch.Tensor | None = None) -> torch.Tensor:
    """Check what the kernel needs, launch it on the current stream of q's
    card and count the launch."""
    global _entry, launches
    dev = q.get_device()
    if k.get_device() != dev or v.get_device() != dev:
        raise ValueError(f"all inputs must lie on {q.device}")
    if q.shape[-1] > MAX_HEAD_DIM:
        raise ValueError(f"head_dim must be at most {MAX_HEAD_DIM}, got "
                         f"{q.shape[-1]}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("the last dimension of q, k and v must be "
                         "contiguous")
    if _build.traced("flash_attention", flops(
            batch * heads, q.shape[-1], sq, sk, causal, window),
            (q, k, v), (out, lse)):
        return out
    if _entry is None:
        _entry = _build.load("flash_attention").lib.flash_attention_bshd
    err = _entry(pack_args(q, k, v, out, layouts, batch, heads, group, sq,
                           sk, causal, window, scale, lse),
                 _build.raw_stream(dev))
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    with _COUNT_LOCK:
        launches += 1
    return out


def _launch_bwd(q, k, v, out, dout, lse, layout, batch: int, heads: int,
                group: int, sq: int, sk: int, causal: bool, window: int,
                scale: float):
    """(dQ, dK, dV) from the gradient kernel, launched on the current
    stream of q's card; ``layout(t, kv)`` gives the layout of a q-like
    (kv False) or k-like operand. Counts the call."""
    global _bwd_entry, backward_launches
    if q.shape[-1] > MAX_BWD_HEAD_DIM:
        raise ValueError(f"the flash gradient takes head_dim at most "
                         f"{MAX_BWD_HEAD_DIM}, got {q.shape[-1]}")
    if dout.stride(-1) != 1:   # e.g. the expanded ones of out.sum()
        dout = dout.contiguous()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty_like(lse)
    if _build.traced("flash_attention_bwd", flops(
            batch * heads, q.shape[-1], sq, sk, causal, window, True),
            (q, k, v, out, dout, lse), (dq, dk, dv)):
        return dq, dk, dv
    if _bwd_entry is None:
        _bwd_entry = _build.load("flash_attention_bwd").lib.flash_attention_bwd
    lays = [layout(t, kv) for t, kv in ((q, False), (k, True), (v, True),
                                         (out, False), (dout, False),
                                         (dq, False), (dk, True), (dv, True))]
    err = _bwd_entry(pack_bwd_args(q, k, v, out, dout, lse, delta, dq, dk,
                                   dv, lays, batch, heads, group, sq, sk,
                                   causal, window, scale),
                     _build.raw_stream(q.get_device()))
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA "
                           f"error {err}")
    with _COUNT_LOCK:
        backward_launches += 1
    return dq, dk, dv


def _not_cuda(q) -> ValueError:
    return ValueError(f"flash attention runs on cpu or cuda, not {q.device}")


def _geometry(kind: str, q, k, group: int):
    """(batch, heads, group, layout) of the kernels' programs for a
    "bshd" or "bhsd" call; ``layout(t, kv)`` gives the layout of a q-like
    operand (kv False: q, o, dO, dQ) or a k-like one (k, v, dK, dV)."""
    if kind == "bshd":
        h = q.shape[2]
        return q.shape[0], h, h // k.shape[2], lambda t, kv: bshd_layout(t)
    # BH / group sequences, each of `group` query heads and one kv head
    return (q.shape[0] // group, group, group,
            lambda t, kv: bhsd_layout(t, 1 if kv else group))


def _forward(q, k, v, kind: str, group: int, causal: bool, window: int,
             scale: float, with_lse: bool):
    """(out, lse): the kernel's result on the card, with each row's
    log-sum-exp when ``with_lse`` (else None); the plain version's on the
    CPU (lse None: the plain gradient recomputes it)."""
    if not _build.on_card(q):
        if q.device.type != "cpu":
            raise _not_cuda(q)
        if kind == "bshd":
            return ref.flash_attention_bshd(q, k, v, causal=causal,
                                            window=window, scale=scale), None
        return ref.flash_attention_bhsd(q, k, v, group=group, causal=causal,
                                        window=window, scale=scale), None
    batch, heads, group, layout = _geometry(kind, q, k, group)
    if kind == "bshd":
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    else:
        out = torch.empty_like(q)  # any dense layout: written through its strides
    lse = (torch.empty((batch * heads, q.shape[1]), dtype=torch.float32,
                       device=q.device) if with_lse else None)
    _launch(q, k, v, out, tuple(layout(t, kv) for t, kv in (
        (q, False), (k, True), (v, True), (out, False))),
        batch, heads, group, q.shape[1], k.shape[1], causal, window, scale,
        lse)
    return out, lse


class FlashAttention(torch.autograd.Function):
    """Flash attention with its gradient: ``apply(q, k, v, kind, group,
    causal, window, scale)`` with ``kind`` "bshd" (the model's (B, S, H, D)
    views; ``group`` is then taken from the shapes) or "bhsd". The forward
    keeps each row's log-sum-exp for the backward, which launches the
    gradient kernel on the card and runs ``ref.flash_attention_bwd`` on
    the CPU. Under remat the forward runs again in the backward pass (and
    counts again in ``launches``)."""

    @staticmethod
    def forward(ctx, q, k, v, kind, group, causal, window, scale):
        out, lse = _forward(q, k, v, kind, group, causal, window, scale,
                            with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (kind, group, causal, window, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        kind, group, causal, window, scale = ctx.args
        if not _build.on_card(q):
            plain = (ref.flash_attention_bwd_bshd if kind == "bshd"
                     else ref.flash_attention_bwd)
            kw = {} if kind == "bshd" else {"group": group}
            grads = plain(q, k, v, out, dout, causal=causal, window=window,
                          scale=scale, **kw)
        else:
            batch, heads, group, layout = _geometry(kind, q, k, group)
            grads = _launch_bwd(q, k, v, out, dout, lse, layout, batch,
                                heads, group, q.shape[1], k.shape[1], causal,
                                window, scale)
        return (*grads, None, None, None, None, None)


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _attend(q, k, v, kind: str, group: int, causal: bool, window: int,
            scale: float) -> torch.Tensor:
    """Through ``FlashAttention`` when a gradient is wanted, else the
    kernel (or the plain version) alone."""
    if _needs_grad(q, k, v):
        return FlashAttention.apply(q, k, v, kind, group, causal, window,
                                    scale)
    return _forward(q, k, v, kind, group, causal, window, scale,
                    with_lse=False)[0]


def flash_attention_bhsd(
    q: torch.Tensor,   # (BH, Sq, D)
    k: torch.Tensor,   # (BH / group, Sk, D)
    v: torch.Tensor,   # (BH / group, Sk, D)
    *,
    group: int,        # H // Hkv
    causal: bool = True,
    window: int = 0,
    scale: float | None = None,
) -> torch.Tensor:
    """(BH, Sq, D) in q's dtype (float32 or bfloat16; math in float32).

    Program b attends kv head b // group; a key at position j is visible
    to the query at position i when (not causal or j <= i) and (window <=
    0 or j > i - window). A query with no visible key gets 0. ``scale``
    defaults to D ** -0.5. Inputs may be strided views. Differentiable
    (``FlashAttention``)."""
    if q.dim() != 3 or k.dim() != 3:
        raise ValueError(f"q and k must be 3-d, got {tuple(q.shape)} and "
                         f"{tuple(k.shape)}")
    bh, sq, d = q.shape
    if group < 1 or k.shape[0] * group != bh or k.shape[2] != d \
            or v.shape != k.shape:
        raise ValueError(f"need k, v (BH / group, Sk, D) = ({bh} / {group}, "
                         f"Sk, {d}), got {tuple(k.shape)} and {tuple(v.shape)}")
    _check(q, k, v)
    scale = d ** -0.5 if scale is None else scale
    if bh == 0 or sq == 0 or d == 0:
        return torch.zeros_like(q)
    return _attend(q, k, v, "bhsd", group, causal, window, scale)


def flash_attention_bshd(
    q: torch.Tensor,   # (B, Sq, H, D)
    k: torch.Tensor,   # (B, Sk, Hkv, D)
    v: torch.Tensor,   # (B, Sk, Hkv, D)
    *,
    causal: bool = True,
    window: int = 0,
    scale: float | None = None,
) -> torch.Tensor:
    """(B, Sq, H, D) attention in the model's layout, on views as they are:
    the function of ``flash_attention_bhsd`` with program b * H + h reading
    kv head h // (H // Hkv). On the card no operand is copied and the
    kernel writes the (B, Sq, H, D) result itself. Differentiable
    (``FlashAttention``)."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q and k must be 4-d, got {tuple(q.shape)} and "
                         f"{tuple(k.shape)}")
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    if hkv == 0 or h % hkv or k.shape[0] != b or k.shape[3] != d \
            or v.shape != k.shape:
        raise ValueError(f"need k, v (B, Sk, Hkv, D) with Hkv dividing H, "
                         f"got q {tuple(q.shape)}, k {tuple(k.shape)} and "
                         f"v {tuple(v.shape)}")
    _check(q, k, v)
    scale = d ** -0.5 if scale is None else scale
    if b == 0 or sq == 0 or d == 0:
        return torch.zeros_like(q)
    return _attend(q, k, v, "bshd", h // hkv, causal, window, scale)
