"""GQA flash-decode of one new token against a KV cache, for Hopper.

Port of ``repro.kernels.decode_attention``. For a CUDA tensor
``decode_attention_bkgd`` launches the hand-written kernel in
``csrc/decode_attention.cu`` (a CTA per (sequence, kv head) walking the
cache up to its length, see the source's note) or raises; for a CPU
tensor it runs the plain version in ``ref.py``. ``launches`` counts
kernel launches, so a run can show that it went through the kernel.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels import _build, ref

MAX_HEAD_DIM = 256  # the kernel keeps a row's dims on one warp, 8 a lane
MAX_GROUP = 32      # query heads per kv head: 4 rows on each of 8 warps
DTYPES = (torch.float32, torch.bfloat16)

launches = 0
_COUNT_LOCK = threading.Lock()


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
    ``scale`` defaults to D ** -0.5."""
    global launches
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
    if q.dtype not in DTYPES or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise ValueError(f"q and the caches must share a dtype in {DTYPES}, "
                         f"got {q.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    if lengths.dtype.is_floating_point or lengths.dtype == torch.bool:
        raise ValueError(f"lengths must be integers, got {lengths.dtype}")
    scale = d ** -0.5 if scale is None else scale
    if bkv == 0 or g == 0 or d == 0:
        return torch.zeros_like(q)
    if q.device.type == "cpu":
        return ref.decode_attention_bkgd(q, k_cache, v_cache, lengths,
                                         num_kv_heads=num_kv_heads,
                                         scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_bkgd runs on cpu or cuda, not "
                         f"{q.device}")
    if d > MAX_HEAD_DIM or g > MAX_GROUP or k_cache.shape[1] == 0:
        raise ValueError(f"need head_dim <= {MAX_HEAD_DIM}, G <= {MAX_GROUP} "
                         f"and S >= 1, got D={d} G={g} S={k_cache.shape[1]}")
    ins = [t.contiguous() for t in (q, k_cache, v_cache)]
    lens = lengths.to(torch.int32).contiguous()
    if any(t.device != q.device for t in (*ins, lens)):
        raise ValueError(f"all inputs must lie on {q.device}")
    out = torch.empty_like(ins[0])
    lib = _build.load("decode_attention").lib
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.decode_attention_bkgd(
        *(t.data_ptr() for t in ins), lens.data_ptr(), out.data_ptr(), bkv,
        g, k_cache.shape[1], d, num_kv_heads, float(scale),
        int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    with _COUNT_LOCK:
        launches += 1
    return out
