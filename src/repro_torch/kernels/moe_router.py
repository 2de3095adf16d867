"""Fused MoE top-k gating, for Hopper.

Port of ``repro.kernels.moe_router``. For a CUDA tensor ``moe_router_tk``
launches the hand-written kernel in ``csrc/moe_router.cu`` (one thread per
row up to 64 experts, one warp per row up to 128, see the source's note)
or raises, and ``moe_router_tokens`` launches its token-fed entry (a warp
per row that forms the row's logits from its token ids first); for a CPU
tensor each runs its plain version in ``ref.py``. ``launches`` counts
kernel launches of both entries, so a run can show that it went through
the kernel.

``moe_router_tk`` is differentiable in the logits: with grad mode on and
logits that require a gradient it goes through ``RouterTopK``, a
``torch.autograd.Function`` whose backward launches the hand-written
gradient kernel (``moe_router_bwd`` in the same source; counted by
``backward_launches``) on the card and runs ``ref.moe_router_bwd`` on the
CPU. The JAX package differentiates its plain router through XLA: no
Pallas kernel there has a backward. ``moe_router_tokens`` (the
predicates') refuses a gradient.
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

launches = 0           # forward launches of both entries
backward_launches = 0  # gradient kernel launches
_COUNT_LOCK = threading.Lock()

# the C entry points' packed arguments: RouterArgs (logits, w, idx; T, E,
# k and a pad) and RouterTokensArgs (toks, emb, w_gate, logits or 0, w,
# idx; B, S, D, E, k and V) in the source
ARGS = struct.Struct("<3Q4i")
# the gradient's (RouterBwdArgs): w, idx, dw, dlogits; T, E, k and a pad
BWD_ARGS = struct.Struct("<4Q4i")
TOKENS_ARGS = struct.Struct("<6Q6i")
_entries: dict = {}  # the library's C functions, looked up once


def _launch(fn: str, packed: bytes, dev: int) -> None:
    global launches, backward_launches
    entry = _entries.get(fn)
    if entry is None:
        entry = _entries[fn] = getattr(_build.load("moe_router").lib, fn)
    err = entry(packed, _build.raw_stream(dev))
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed: CUDA error {err}")
    with _COUNT_LOCK:
        if fn == "moe_router_bwd":
            backward_launches += 1
        else:
            launches += 1


def flops(t: int, e: int, k: int) -> int:
    """The forward's operations (``udfs/rooflines.moe_router``'s count)."""
    return t * e * (10 + 4 * k)


def bwd_flops(t: int, k: int) -> int:
    """The gradient's: a row's sum (2k) and its k outputs (2 each)."""
    return 4 * t * k


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
    64 experts), so T is free; E is at most MAX_EXPERTS on the card.
    Differentiable in the logits (``RouterTopK``)."""
    if logits.dim() != 2:
        raise ValueError(f"logits must be (T, E), got {tuple(logits.shape)}")
    t, e = logits.shape
    _check_k(k, e)
    if t == 0:
        return (torch.zeros((0, k), dtype=logits.dtype, device=logits.device),
                torch.zeros((0, k), dtype=torch.int32, device=logits.device))
    if torch.is_grad_enabled() and logits.requires_grad:
        return RouterTopK.apply(logits, k)
    return _forward(logits, k)


def _forward(logits: torch.Tensor, k: int):
    """(w, idx): the kernel's on the card, the plain version's on the CPU."""
    if not _build.on_card(logits):
        if logits.device.type != "cpu":
            raise _not_cuda(logits, "moe_router_tk")
        return ref.moe_topk_router(logits, k)
    t, e = logits.shape
    if e > MAX_EXPERTS:
        raise ValueError(f"at most {MAX_EXPERTS} experts, got {e}")
    x = _build.f32_contiguous(logits)
    w = torch.empty((t, k), dtype=torch.float32, device=x.device)
    idx = torch.empty((t, k), dtype=torch.int32, device=x.device)
    if not _build.traced("moe_router", flops(t, e, k), (x,), (w, idx)):
        _launch("moe_router_tk", ARGS.pack(x.data_ptr(), w.data_ptr(),
                                           idx.data_ptr(), t, e, k, 0),
                x.get_device())
    if logits.dtype != torch.float32:
        w = w.to(logits.dtype)
    return w, idx


def moe_router_bwd(w: torch.Tensor, idx: torch.Tensor, dw: torch.Tensor,
                   num_experts: int) -> torch.Tensor:
    """(T, E) float32, the logits' gradient of ``moe_router_tk`` for the
    weights' cotangent ``dw`` (formula in ``ref.moe_router_bwd``): on the
    card one launch of the gradient kernel, a thread per element of the
    result; on the CPU the plain version."""
    if not _build.on_card(w):
        if w.device.type != "cpu":
            raise _not_cuda(w, "moe_router_bwd")
        return ref.moe_router_bwd(w, idx, dw, num_experts)
    t, k = w.shape
    if num_experts > MAX_EXPERTS:
        raise ValueError(f"at most {MAX_EXPERTS} experts, got {num_experts}")
    wf, dwf = _build.f32_contiguous(w), _build.f32_contiguous(dw)
    ids = idx if idx.dtype == torch.int32 and idx.is_contiguous() else \
        idx.to(torch.int32).contiguous()
    dev = wf.get_device()
    if ids.get_device() != dev or dwf.get_device() != dev:
        raise ValueError(f"all inputs must lie on {w.device}")
    out = torch.empty((t, num_experts), dtype=torch.float32, device=w.device)
    if not _build.traced("moe_router_bwd", bwd_flops(t, k), (wf, ids, dwf),
                         (out,)):
        _launch("moe_router_bwd", BWD_ARGS.pack(
            wf.data_ptr(), ids.data_ptr(), dwf.data_ptr(), out.data_ptr(),
            t, num_experts, k, 0), dev)
    return out


class RouterTopK(torch.autograd.Function):
    """``moe_router_tk`` with the logits' gradient: ``apply(logits, k)``
    -> (w, idx). The forward keeps the weights and their experts; the
    backward is ``moe_router_bwd`` (the indices carry no gradient). Under
    remat the forward runs again in the backward pass (and counts again
    in ``launches``)."""

    @staticmethod
    def forward(ctx, logits, k):
        w, idx = _forward(logits, k)
        ctx.mark_non_differentiable(idx)
        ctx.save_for_backward(w, idx)
        ctx.num_experts, ctx.dtype = logits.shape[1], logits.dtype
        return w, idx

    @staticmethod
    def backward(ctx, dw, _didx):
        w, idx = ctx.saved_tensors
        if dw is None:
            return None, None
        return moe_router_bwd(w, idx, dw, ctx.num_experts).to(ctx.dtype), None


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
    _build.refuse_fake("moe_router", ids, table, gate, logits_out, w, idx)
    _launch("moe_router_tokens", TOKENS_ARGS.pack(
        ids.data_ptr(), table.data_ptr(), gate.data_ptr(),
        0 if logits_out is None else logits_out.data_ptr(), w.data_ptr(),
        idx.data_ptr(), b, s, d, e, k, v), dev)
    return w, idx
