"""Fused MoE top-k gating, for Hopper.

Port of ``repro.kernels.moe_router``. For a CUDA tensor ``moe_router_tk``
launches the hand-written kernel in ``csrc/moe_router.cu`` (one thread per
row, see the source's note) or raises; for a CPU tensor it runs the plain
version in ``ref.py``. ``launches`` counts kernel launches, so a run can
show that it went through the kernel.
"""
from __future__ import annotations

import struct
import threading

import torch

from repro_torch.kernels import _build, ref

MAX_EXPERTS = 64  # the kernel keeps a row's probabilities in registers

launches = 0
_COUNT_LOCK = threading.Lock()

# the C entry point's packed arguments (RouterArgs in the source): logits,
# w, idx; T, E, k and a pad
ARGS = struct.Struct("<3Q4i")
_entry = None  # the library's C function, looked up once


def moe_router_tk(
    logits: torch.Tensor,  # (T, E)
    k: int,
):
    """(weights (T, k) in the logits' dtype, idx (T, k) int32): softmax
    over E, k rounds of argmax (lowest index on ties) and mask, then the k
    weights renormalised. Each row has its own thread, so T is free."""
    global _entry, launches
    if logits.dim() != 2:
        raise ValueError(f"logits must be (T, E), got {tuple(logits.shape)}")
    t, e = logits.shape
    if not 1 <= k <= e:
        raise ValueError(f"need 1 <= k <= E, got k={k} E={e}")
    if t == 0:
        return (torch.zeros((0, k), dtype=logits.dtype, device=logits.device),
                torch.zeros((0, k), dtype=torch.int32, device=logits.device))
    if not logits.is_cuda:
        if logits.device.type != "cpu":
            raise ValueError(f"moe_router_tk runs on cpu or cuda, not "
                             f"{logits.device}")
        return ref.moe_topk_router(logits, k)
    if e > MAX_EXPERTS:
        raise ValueError(f"at most {MAX_EXPERTS} experts, got {e}")
    x = logits
    if x.dtype != torch.float32 or not x.is_contiguous():
        x = x.to(torch.float32).contiguous()
    w = torch.empty((t, k), dtype=torch.float32, device=x.device)
    idx = torch.empty((t, k), dtype=torch.int32, device=x.device)
    if _entry is None:
        _entry = _build.load("moe_router").lib.moe_router_tk
    err = _entry(ARGS.pack(x.data_ptr(), w.data_ptr(), idx.data_ptr(), t, e,
                           k, 0), _build.raw_stream(x.get_device()))
    if err != 0:
        raise RuntimeError(f"moe_router kernel launch failed: CUDA error {err}")
    with _COUNT_LOCK:
        launches += 1
    if logits.dtype != torch.float32:
        w = w.to(logits.dtype)
    return w, idx
