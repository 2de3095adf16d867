"""Fused MoE top-k gating, for Hopper.

Port of ``repro.kernels.moe_router``. For a CUDA tensor ``moe_router_tk``
launches the hand-written kernel in ``csrc/moe_router.cu`` (one thread per
row up to 64 experts, one warp per row up to 128, see the source's note)
or raises, and ``moe_router_tokens`` launches its token-fed entry (a warp
per row that forms the row's logits from its token ids first); for a CPU
tensor each runs its plain version in ``ref.py``. ``launches`` counts
kernel launches of both entries, so a run can show that it went through
the kernel.
"""
from __future__ import annotations

import struct
import threading

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.launch import refuse_grad

# the kernels keep a row's probabilities in registers: moe_router_tk in a
# thread (E <= 64) or spread over a warp (E <= 128); the token entry in a
# thread after its warp has formed the logits
MAX_EXPERTS = 128
MAX_TOKEN_EXPERTS = 64

launches = 0
_COUNT_LOCK = threading.Lock()

# the C entry points' packed arguments: RouterArgs (logits, w, idx; T, E,
# k and a pad) and RouterTokensArgs (toks, emb, w_gate, logits or 0, w,
# idx; B, S, D, E, k and V) in the source
ARGS = struct.Struct("<3Q4i")
TOKENS_ARGS = struct.Struct("<6Q6i")
_entries: dict = {}  # the library's C functions, looked up once


def _launch(fn: str, packed: bytes, dev: int) -> None:
    global launches
    entry = _entries.get(fn)
    if entry is None:
        entry = _entries[fn] = getattr(_build.load("moe_router").lib, fn)
    err = entry(packed, _build.raw_stream(dev))
    if err != 0:
        raise RuntimeError(f"moe_router kernel launch failed: CUDA error {err}")
    with _COUNT_LOCK:
        launches += 1


def _check_k(k: int, e: int) -> None:
    if not 1 <= k <= e:
        raise ValueError(f"need 1 <= k <= E, got k={k} E={e}")


def _not_cuda(t: torch.Tensor, name: str) -> ValueError:
    return ValueError(f"{name} runs on cpu or cuda, not {t.device}")


def moe_router_tk(
    logits: torch.Tensor,  # (T, E)
    k: int,
):
    """(weights (T, k) in the logits' dtype, idx (T, k) int32): softmax
    over E, k rounds of argmax (lowest index on ties) and mask, then the k
    weights renormalised. Each row has its own thread (its own warp above
    64 experts), so T is free; E is at most MAX_EXPERTS on the card."""
    refuse_grad("moe_router", logits)
    if logits.dim() != 2:
        raise ValueError(f"logits must be (T, E), got {tuple(logits.shape)}")
    t, e = logits.shape
    _check_k(k, e)
    if t == 0:
        return (torch.zeros((0, k), dtype=logits.dtype, device=logits.device),
                torch.zeros((0, k), dtype=torch.int32, device=logits.device))
    if not logits.is_cuda:
        if logits.device.type != "cpu":
            raise _not_cuda(logits, "moe_router_tk")
        return ref.moe_topk_router(logits, k)
    if e > MAX_EXPERTS:
        raise ValueError(f"at most {MAX_EXPERTS} experts, got {e}")
    x = _build.f32_contiguous(logits)
    w = torch.empty((t, k), dtype=torch.float32, device=x.device)
    idx = torch.empty((t, k), dtype=torch.int32, device=x.device)
    _launch("moe_router_tk", ARGS.pack(x.data_ptr(), w.data_ptr(),
                                       idx.data_ptr(), t, e, k, 0),
            x.get_device())
    if logits.dtype != torch.float32:
        w = w.to(logits.dtype)
    return w, idx


def moe_router_tokens(
    toks: torch.Tensor,    # (B, S) int32 token ids
    emb: torch.Tensor,     # (V, D) embedding table
    w_gate: torch.Tensor,  # (D, E)
    k: int,
    logits_out: torch.Tensor | None = None,  # (B, E) float32
):
    """(weights (B, k) float32, idx (B, k) int32) of the router over each
    row's mean-pooled token embeddings: ``moe_router_tk(router_logits(emb,
    w_gate, toks), k)`` in one launch on the card, the logits bit-equal to
    ``ref.router_logits``. ``logits_out``, if given, receives the logits.
    The caller keeps the ids in [0, V): on the card an id outside is taken
    as the JAX package's gather takes it (the predicate refuses such ids on
    the host); the plain version's indexing raises or wraps."""
    refuse_grad("moe_router", emb, w_gate)
    if toks.dim() != 2 or emb.dim() != 2 or w_gate.dim() != 2:
        raise ValueError(f"need toks (B, S), emb (V, D) and w_gate (D, E), "
                         f"got {tuple(toks.shape)}, {tuple(emb.shape)} and "
                         f"{tuple(w_gate.shape)}")
    b, s = toks.shape
    (v, d), e = emb.shape, w_gate.shape[1]
    if w_gate.shape[0] != d:
        raise ValueError(f"w_gate must be ({d}, E), got {tuple(w_gate.shape)}")
    _check_k(k, e)
    if s == 0 or v == 0:
        raise ValueError(f"need S >= 1 and V >= 1, got S={s} V={v}")
    if logits_out is not None and (
            tuple(logits_out.shape) != (b, e) or logits_out.dtype != torch.float32
            or not logits_out.is_contiguous()):
        raise ValueError(f"logits_out must be a contiguous float32 ({b}, {e})")
    if b == 0:
        return (torch.zeros((0, k), dtype=torch.float32, device=toks.device),
                torch.zeros((0, k), dtype=torch.int32, device=toks.device))
    if not toks.is_cuda:
        if toks.device.type != "cpu":
            raise _not_cuda(toks, "moe_router_tokens")
        return ref.moe_router_tokens(toks, emb, w_gate, k, logits_out)
    if e > MAX_TOKEN_EXPERTS:
        raise ValueError(f"at most {MAX_TOKEN_EXPERTS} experts, got {e}")
    dev = toks.get_device()
    ids = toks if toks.dtype == torch.int32 and toks.is_contiguous() else \
        toks.to(torch.int32).contiguous()
    table, gate = (_build.f32_contiguous(t) for t in (emb, w_gate))
    if table.get_device() != dev or gate.get_device() != dev or (
            logits_out is not None and logits_out.get_device() != dev):
        raise ValueError(f"all inputs must lie on {toks.device}")
    w = torch.empty((b, k), dtype=torch.float32, device=toks.device)
    idx = torch.empty((b, k), dtype=torch.int32, device=toks.device)
    _launch("moe_router_tokens", TOKENS_ARGS.pack(
        ids.data_ptr(), table.data_ptr(), gate.data_ptr(),
        0 if logits_out is None else logits_out.data_ptr(), w.data_ptr(),
        idx.data_ptr(), b, s, d, e, k, v), dev)
    return w, idx
