"""Blocked causal / sliding-window flash attention with GQA, for Hopper.

Port of ``repro.kernels.flash_attention``. For a CUDA tensor the wrappers
launch the hand-written kernel in ``csrc/flash_attention.cu`` (tensor-core
tiles of 64 query rows, 3xTF32 for float32, a cp.async ring of K/V tiles;
see the source's note) or raise; for a CPU tensor they run the plain
version in ``ref.py``. The kernel reads every operand through its strides,
so ``flash_attention_bshd`` takes the model's (B, S, H, D) views as they
are and writes (B, S, H, D). ``launches`` counts kernel launches, so a run
can show that it went through the kernel.

A layout is the triple of element strides (between sequences, between
heads, between rows) through which the attention kernels walk an operand
whose last dimension is contiguous; rows are positions, or query heads for
decode's query and output. The kernels only multiply these.
"""
from __future__ import annotations

import struct
import threading

import torch

from repro_torch.kernels import _build, ref

MAX_HEAD_DIM = 256  # the kernel's widest tile
DTYPES = (torch.float32, torch.bfloat16)

launches = 0
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


# the C entry point's packed arguments (FlashArgs in the source): q, k, v
# and o; their layouts; batch, heads, group, Sq, Sk, D, causal, window,
# bf16; scale
ARGS = struct.Struct("<4Q12q9if")


def pack_args(q, k, v, out, layouts, batch: int, heads: int, group: int,
              sq: int, sk: int, causal: bool, window: int,
              scale: float) -> bytes:
    """The kernel's arguments in one buffer: program b * heads + h of
    ``batch`` sequences reads kv head h // group; each operand is read or
    written through its own layout."""
    lq, lk, lv, lo = layouts
    return ARGS.pack(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     *lq, *lk, *lv, *lo, batch, heads, group, sq, sk,
                     q.shape[-1], causal, window, q.dtype == torch.bfloat16,
                     scale)


def _check(q, k, v) -> None:
    """Raise on dtypes the kernel and the plain version do not take."""
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k and v must share a dtype in {DTYPES}, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")


_entry = None  # the library's C function, looked up once


def _launch(q, k, v, out, layouts, batch: int, heads: int, group: int,
            sq: int, sk: int, causal: bool, window: int,
            scale: float) -> torch.Tensor:
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
    if _entry is None:
        _entry = _build.load("flash_attention").lib.flash_attention_bshd
    err = _entry(pack_args(q, k, v, out, layouts, batch, heads, group, sq,
                           sk, causal, window, scale),
                 _build.raw_stream(dev))
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    with _COUNT_LOCK:
        launches += 1
    return out


def _not_cuda(q) -> ValueError:
    return ValueError(f"flash attention runs on cpu or cuda, not {q.device}")


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
    defaults to D ** -0.5. Inputs may be strided views."""
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
    if not q.is_cuda:
        if q.device.type != "cpu":
            raise _not_cuda(q)
        return ref.flash_attention_bhsd(q, k, v, group=group, causal=causal,
                                        window=window, scale=scale)
    out = torch.empty_like(q)  # any dense layout: written through its strides
    # BH / group sequences, each of `group` query heads and one kv head
    return _launch(q, k, v, out, (bhsd_layout(q, group), bhsd_layout(k, 1),
                                  bhsd_layout(v, 1), bhsd_layout(out, group)),
                   bh // group, group, group, sq, k.shape[1], causal, window,
                   scale)


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
    kernel writes the (B, Sq, H, D) result itself."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q and k must be 4-d, got {tuple(q.shape)} and "
                         f"{tuple(k.shape)}")
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if hkv == 0 or h % hkv or k.shape[0] != b or k.shape[3] != d \
            or v.shape != k.shape:
        raise ValueError(f"need k, v (B, Sk, Hkv, D) with Hkv dividing H, "
                         f"got q {tuple(q.shape)}, k {tuple(k.shape)} and "
                         f"v {tuple(v.shape)}")
    _check(q, k, v)
    scale = d ** -0.5 if scale is None else scale
    if b == 0 or sq == 0 or d == 0:
        return torch.zeros_like(q)
    if not q.is_cuda:
        if q.device.type != "cpu":
            raise _not_cuda(q)
        return ref.flash_attention_bshd(q, k, v, causal=causal,
                                        window=window, scale=scale)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    return _launch(q, k, v, out, tuple(map(bshd_layout, (q, k, v, out))),
                   b, h, h // hkv, sq, sk, causal, window, scale)
