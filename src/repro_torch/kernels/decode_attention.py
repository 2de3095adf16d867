"""GQA flash-decode of one new token against a KV cache, for Hopper.

Port of ``repro.kernels.decode_attention``. For a CUDA tensor the wrappers
launch the hand-written kernel in ``csrc/decode_attention.cu`` (the cache
split into fixed ``SPLIT``-key stretches over CTAs, merged in split order
by a second kernel where S > SPLIT; see the source's note) or raise; for
a CPU tensor they run the plain version in ``ref.py``. The kernel reads
every operand through its strides, so ``decode_attention_bshd`` takes the
model's (B, H, D) query and (B, S, Hkv, D) cache views as they are.
``launches`` counts kernel launches (one a call, whether or not the
combine runs), so a run can show that it went through the kernel.
"""
from __future__ import annotations

import struct
import threading

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.launch import refuse_grad
from repro_torch.kernels.flash_attention import bhsd_layout

MAX_HEAD_DIM = 256  # the kernel's widest tile
MAX_GROUP = 32      # query heads per kv head: the rows of one CTA
SPLIT = 256         # cache keys of one CTA: fixed, never sized by the batch
DTYPES = (torch.float32, torch.bfloat16)

launches = 0
_COUNT_LOCK = threading.Lock()


def query_layout(t: torch.Tensor, group: int) -> tuple:
    """The layout (``flash_attention``'s module note) of a (B, H, D) query
    or output taken as B sequences of H / group kv heads with ``group``
    query rows each."""
    s = t.stride()
    return s[0], group * s[1], s[1]


def cache_layout(t: torch.Tensor) -> tuple:
    """The layout of a (B, S, Hkv, D) cache view."""
    s = t.stride()
    return s[0], s[2], s[1]


def splits(s: int) -> int:
    """CTAs a program's cache is split over: decided by S alone."""
    return -(-s // SPLIT)


# the C entry point's packed arguments (DecodeArgs in the source): q, the
# caches, lengths, o and the partials; their layouts; batch, kv heads, G,
# S, D, the split length, bf16; scale
ARGS = struct.Struct("<6Q12q7if")


def pack_args(q, k_cache, v_cache, lengths, out, partials, layouts,
              batch: int, kv_heads: int, g: int, s: int,
              scale: float) -> bytes:
    """The kernel's arguments in one buffer: program b * kv_heads + h
    attends the first lengths[b] entries of its cache with its G query
    rows; each operand is read or written through its own layout;
    ``partials`` is the combine's scratch (None when S <= SPLIT)."""
    lq, lk, lv, lo = layouts
    return ARGS.pack(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                     lengths.data_ptr(), out.data_ptr(),
                     0 if partials is None else partials.data_ptr(),
                     *lq, *lk, *lv, *lo, batch, kv_heads, g, s, q.shape[-1],
                     SPLIT, q.dtype == torch.bfloat16, scale)


_entry = None  # the library's C function, looked up once


def _launch(q, k_cache, v_cache, lengths, out, layouts, batch: int,
            kv_heads: int, g: int, s: int, scale: float) -> torch.Tensor:
    """Check what the kernel needs and launch it on the current stream."""
    global _entry, launches
    d = q.shape[-1]
    if d > MAX_HEAD_DIM or g > MAX_GROUP or s == 0:
        raise ValueError(f"need head_dim <= {MAX_HEAD_DIM}, G <= {MAX_GROUP} "
                         f"and S >= 1, got D={d} G={g} S={s}")
    if q.stride(-1) != 1 or k_cache.stride(-1) != 1 \
            or v_cache.stride(-1) != 1:
        raise ValueError("the last dimension of q and the caches must be "
                         "contiguous")
    dev = q.get_device()
    if k_cache.get_device() != dev or v_cache.get_device() != dev:
        raise ValueError(f"all inputs must lie on {q.device}")
    lens = lengths
    if lens.dtype != torch.int32 or lens.get_device() != dev \
            or lens.stride(0) != 1:
        lens = lens.to(device=q.device, dtype=torch.int32).contiguous()
    n = splits(s)
    part = (torch.empty(batch * kv_heads * n * g * (d + 2),
                        dtype=torch.float32, device=q.device)
            if n > 1 else None)
    _build.refuse_fake("decode_attention", q, k_cache, v_cache, lens, out,
                       part)
    if _entry is None:
        _entry = _build.load("decode_attention").lib.decode_attention_bshd
    err = _entry(pack_args(q, k_cache, v_cache, lens, out, part, layouts,
                           batch, kv_heads, g, s, scale),
                 _build.raw_stream(dev))
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    with _COUNT_LOCK:
        launches += 1
    return out


def _not_cuda(q) -> ValueError:
    return ValueError(f"decode attention runs on cpu or cuda, not {q.device}")


def _check_types(q, k_cache, v_cache, lengths) -> None:
    if q.dtype not in DTYPES or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise ValueError(f"q and the caches must share a dtype in {DTYPES}, "
                         f"got {q.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    if lengths.dtype.is_floating_point or lengths.dtype == torch.bool:
        raise ValueError(f"lengths must be integers, got {lengths.dtype}")


def decode_attention_bkgd(
    q: torch.Tensor,        # (B * Hkv, G, D)
    k_cache: torch.Tensor,  # (B * Hkv, S, D)
    v_cache: torch.Tensor,  # (B * Hkv, S, D)
    lengths: torch.Tensor,  # (B,) valid cache entries of each sequence
    *,
    num_kv_heads: int,
    scale: float | None = None,
) -> torch.Tensor:
    """(B * Hkv, G, D) in q's dtype (float32 or bfloat16; math in float32).

    Program b attends the first lengths[b // num_kv_heads] entries of its
    cache (a length past S attends all of them; length 0 gives 0).
    ``scale`` defaults to D ** -0.5. Inputs may be strided views."""
    refuse_grad("decode_attention", q, k_cache, v_cache)
    if q.dim() != 3 or k_cache.dim() != 3:
        raise ValueError(f"q and k_cache must be 3-d, got {tuple(q.shape)} "
                         f"and {tuple(k_cache.shape)}")
    bkv, g, d = q.shape
    if k_cache.shape[0] != bkv or k_cache.shape[2] != d \
            or v_cache.shape != k_cache.shape:
        raise ValueError(f"need caches (B * Hkv, S, D) = ({bkv}, S, {d}), got "
                         f"{tuple(k_cache.shape)} and {tuple(v_cache.shape)}")
    if num_kv_heads < 1 or bkv % num_kv_heads \
            or tuple(lengths.shape) != (bkv // num_kv_heads,):
        raise ValueError(f"need num_kv_heads | {bkv} and lengths "
                         f"({bkv} / num_kv_heads,), got num_kv_heads="
                         f"{num_kv_heads} and {tuple(lengths.shape)}")
    _check_types(q, k_cache, v_cache, lengths)
    scale = d ** -0.5 if scale is None else scale
    if bkv == 0 or g == 0 or d == 0:
        return torch.zeros_like(q)
    if not q.is_cuda:
        if q.device.type != "cpu":
            raise _not_cuda(q)
        return ref.decode_attention_bkgd(q, k_cache, v_cache, lengths,
                                         num_kv_heads=num_kv_heads,
                                         scale=scale)
    out = torch.empty_like(q)  # any dense layout: written through its strides
    return _launch(q, k_cache, v_cache, lengths, out,
                   tuple(bhsd_layout(t, num_kv_heads)
                         for t in (q, k_cache, v_cache, out)),
                   bkv // num_kv_heads, num_kv_heads, g, k_cache.shape[1],
                   scale)


def decode_attention_bshd(
    q: torch.Tensor,        # (B, H, D)
    k_cache: torch.Tensor,  # (B, S, Hkv, D)
    v_cache: torch.Tensor,  # (B, S, Hkv, D)
    lengths: torch.Tensor,  # (B,)
    *,
    scale: float | None = None,
) -> torch.Tensor:
    """(B, H, D) in the model's layout, on views as they are: the function
    of ``decode_attention_bkgd`` with query head h reading kv head h // G,
    G = H // Hkv. On the card no operand is copied."""
    refuse_grad("decode_attention", q, k_cache, v_cache)
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError(f"need q (B, H, D) and caches (B, S, Hkv, D), got "
                         f"{tuple(q.shape)} and {tuple(k_cache.shape)}")
    b, h, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    if hkv == 0 or h % hkv or k_cache.shape[0] != b or k_cache.shape[3] != d \
            or v_cache.shape != k_cache.shape:
        raise ValueError(f"need caches (B, S, Hkv, D) with Hkv dividing H, "
                         f"got q {tuple(q.shape)} and caches "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    if tuple(lengths.shape) != (b,):
        raise ValueError(f"need lengths ({b},), got {tuple(lengths.shape)}")
    _check_types(q, k_cache, v_cache, lengths)
    scale = d ** -0.5 if scale is None else scale
    g = h // hkv
    if b == 0 or h == 0 or d == 0:
        return torch.zeros_like(q)
    if not q.is_cuda:
        if q.device.type != "cpu":
            raise _not_cuda(q)
        out = ref.decode_attention_bkgd(
            q.reshape(b * hkv, g, d),
            k_cache.transpose(1, 2).reshape(b * hkv, s, d),
            v_cache.transpose(1, 2).reshape(b * hkv, s, d), lengths,
            num_kv_heads=hkv, scale=scale)
        return out.reshape(b, h, d)
    out = torch.empty_like(q)
    return _launch(q, k_cache, v_cache, lengths, out,
                   (query_layout(q, g), cache_layout(k_cache),
                    cache_layout(v_cache), query_layout(out, g)),
                   b, hkv, g, s, scale)
