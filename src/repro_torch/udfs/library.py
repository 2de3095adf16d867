"""Kernel-backed predicate builders of the port.

Port of ``repro.udfs.library``. Every builder returns a first-class
``Predicate`` whose UDF

  * launches the hand-written kernel through ``repro_torch.kernels.ops``
    (``launch.kernel_call``), so per-launch timings flow into the
    executor's StatsBoard via ``connect_stats_board``;
  * runs the host-to-device copy, the kernel and the copy back on the
    launching thread's own CUDA stream (``launch.thread_stream``);
  * warms up in ``warm_fn`` — GACU lazy activation (§5.1): the first batch
    routed to a worker pays the kernel's build, not every policy probe;
  * carries a roofline-derived ``cost_model`` prior
    (``repro_torch.udfs.rooflines``) for SimClock runs and cold starts;
  * declares a data-aware ``proxy_cost`` for Laminar data balancing;
  * carries a canonical ``fingerprint`` for the persistent StatsStore.

``device`` defaults to ``"cuda"``: the predicate runs on the card, and
building it without one raises. ``device="cpu"`` runs the plain version.

Text-consuming kernels (moe_router, ssd, rglru, flash and decode
attention) share a deterministic
seeded featurizer: token ids index fixed embedding tables (row 0 =
padding = zeros), so the predicate is a pure function of the ``tokens``
column and an oracle can re-evaluate it exactly. The tables are drawn from
``np.random.default_rng(seed)`` in the JAX package's order, so they equal
its tables bit for bit. The featurizer's sums run in an order fixed by
the shapes alone (``fixed_sum``), never by the batch, so a row's score is
the same in any batch the executor puts it in, and the same on the card
as on the CPU.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from repro_torch import convert
from repro_torch.core.statstore import canonical_fingerprint
from repro_torch.core.udf import Predicate, UDF
from repro_torch.kernels import launch, ops, ref
from repro_torch.kernels.ref import fixed_sum
from repro_torch.udfs import rooflines


# --------------------------------------------------------------------------- #
# helpers                                                                     #
# --------------------------------------------------------------------------- #
def block_divisor(n: int, cap: int) -> int:
    """Largest divisor of ``n`` that is <= cap (kernel block constraint)."""
    for b in range(min(cap, n), 0, -1):
        if n % b == 0:
            return b
    return 1


def one_row_probe(fn: Callable, columns: Dict[str, tuple],
                  dtypes: Dict[str, np.dtype]) -> Callable[[], object]:
    """GACU ``warm_fn``: run the kernel once on a single synthesized row.

    Returns the probe output so ``UDF.ensure_ready`` learns the output
    dtype/shape from the warm launch — zero-row batches then need no probe
    launch of their own."""

    def warm():
        return fn(
            {c: np.zeros((1,) + shape, dtypes[c])
             for c, shape in columns.items()}
        )

    return warm


def to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """float32 host array -> tensor on ``device`` (cast on the host first).

    Call inside ``launch.thread_stream(device)`` so the copy runs on the
    launching thread's stream."""
    host = torch.from_numpy(np.ascontiguousarray(array, dtype=np.float32))
    return host.to(device)


def _embed_table(rng: np.random.Generator, vocab: int, dim: int,
                 device: torch.device) -> torch.Tensor:
    """Fixed random embedding table; row 0 (padding) embeds to zero."""
    t = rng.standard_normal((vocab, dim)).astype(np.float32) / np.sqrt(dim)
    t[0] = 0.0
    return convert.embedding_table(t, device)


def _draw(values: np.ndarray, device: torch.device) -> torch.Tensor:
    """A parameter drawn on the host -> float32 on ``device``."""
    return torch.from_numpy(np.asarray(values, np.float32)).to(device)


def _pad_tokens(tokens: np.ndarray, seq: int) -> np.ndarray:
    """(B, L) int tokens -> (B, seq): truncate or zero-pad the time axis."""
    toks = np.asarray(tokens)
    b, length = toks.shape
    if length == seq:
        return toks.astype(np.int32)
    out = np.zeros((b, seq), np.int32)
    out[:, : min(length, seq)] = toks[:, :seq]
    return out


def _token_proxy(d: Dict[str, np.ndarray]) -> float:
    """Data-aware load: live (non-pad) tokens, the paper's input-size proxy."""
    return float((np.asarray(d["tokens"]) > 0).sum())


def _text_device(device) -> torch.device:
    """``device`` for a text predicate. On the card, float32 products stay
    float32: TF32 keeps about three digits, and the scores' decision
    margins are ~1e-7 (the plain SSD version's einsums check the flag)."""
    dev = launch.require_device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev


def token_ids(tokens: np.ndarray, seq: int, vocab: int,
              device: torch.device) -> torch.Tensor:
    """(B, L) host tokens -> (B, seq) int32 ids on ``device``: the input of
    the token-fed kernels, and what the other text predicates index their
    tables with. Raises ValueError for an id outside [0, vocab), checked on
    the host before the copy: a kernel would take such an id as the JAX
    package's gather does (clamped), torch indexing raises on the CPU and
    fails on the card. Call inside ``launch.thread_stream(device)``."""
    toks = np.asarray(tokens)
    head = toks[:, :seq]
    if head.size and (head.min() < 0 or head.max() >= vocab):
        raise ValueError(f"token ids must lie in [0, {vocab}), got "
                         f"{head.min()}..{head.max()}")
    return torch.from_numpy(_pad_tokens(toks, seq)).to(device)


def row_mean(x: torch.Tensor) -> torch.Tensor:
    """(B, ...) -> (B,) mean of each row: its ``fixed_sum`` scaled by the
    float32 reciprocal of the count, as the JAX package's ``mean`` does."""
    flat = x.flatten(1)
    return fixed_sum(flat, 1) * float(np.float32(1) / np.float32(flat.shape[1]))


# The tables and kernel inputs of each text predicate. The builders below
# and ``chip_smoke.py`` (which holds the kernels against their plain
# versions on the predicates' own inputs) share them.
def router_tables(*, n_experts: int = 8, dim: int = 16, vocab: int = 256,
                  seed: int = 0, device="cpu"):
    """(embedding table (vocab, dim), gate (dim, n_experts))."""
    rng = np.random.default_rng(seed)
    emb = _embed_table(rng, vocab, dim, device)
    w_gate = _draw(
        rng.standard_normal((dim, n_experts)).astype(np.float32) / np.sqrt(dim),
        device)
    return emb, w_gate


def ssd_tables(*, heads: int = 2, head_dim: int = 4, state: int = 4,
               vocab: int = 256, seed: int = 1, device="cpu"):
    """(x table, B table, C table, A (heads,))."""
    rng = np.random.default_rng(seed)
    emb_x = _embed_table(rng, vocab, heads * head_dim, device)
    emb_b = _embed_table(rng, vocab, state, device)
    emb_c = _embed_table(rng, vocab, state, device)
    A = _draw(-np.abs(rng.standard_normal(heads)).astype(np.float32), device)
    return emb_x, emb_b, emb_c, A


def ssd_inputs(tables, toks: torch.Tensor, *, heads: int = 2,
               head_dim: int = 4, state: int = 4):
    """(B, S) ids -> (x (B,S,H,P), dt (B,S,H), A, Bm, Cm (B,S,1,N)), the
    arguments of ``ops.ssd``. dt is 0.1 on live tokens and 0 on padding,
    so pads never update the state."""
    emb_x, emb_b, emb_c, A = tables
    b, seq = toks.shape
    x = emb_x[toks].reshape(b, seq, heads, head_dim)
    dt = ((toks > 0).to(torch.float32) * 0.1)[..., None].expand(b, seq, heads)
    Bm = emb_b[toks].reshape(b, seq, 1, state)
    Cm = emb_c[toks].reshape(b, seq, 1, state)
    return x, dt, A, Bm, Cm


def rglru_tables(*, width: int = 16, vocab: int = 256, seed: int = 2,
                 device="cpu"):
    """(x table, r table, i table, a_param (width,))."""
    rng = np.random.default_rng(seed)
    emb_x = _embed_table(rng, vocab, width, device)
    emb_r = _embed_table(rng, vocab, width, device)
    emb_i = _embed_table(rng, vocab, width, device)
    a_param = _draw(rng.standard_normal(width).astype(np.float32), device)
    return emb_x, emb_r, emb_i, a_param


def attention_tables(*, heads: int = 2, head_dim: int = 8, vocab: int = 256,
                     seed: int = 3, device="cpu"):
    """(q table, k table, v table), each (vocab, heads * head_dim)."""
    rng = np.random.default_rng(seed)
    return tuple(_embed_table(rng, vocab, heads * head_dim, device)
                 for _ in range(3))


def attention_inputs(tables, toks: torch.Tensor, *, heads: int = 2,
                     head_dim: int = 8):
    """(B, S) ids -> (q, k, v), each (B, S, heads, head_dim): the
    arguments of ``ops.flash_attention``. Pad tokens embed to zero, so a
    pad key scores exactly 0 and is attended, not masked."""
    b, seq = toks.shape
    return tuple(t[toks].reshape(b, seq, heads, head_dim) for t in tables)


def decode_tables(*, heads: int = 2, head_dim: int = 8, kv_heads: int = 1,
                  vocab: int = 256, seed: int = 4, device="cpu"):
    """(k table, v table, each (vocab, kv_heads * head_dim), and the fixed
    query (heads, head_dim))."""
    rng = np.random.default_rng(seed)
    emb_k = _embed_table(rng, vocab, kv_heads * head_dim, device)
    emb_v = _embed_table(rng, vocab, kv_heads * head_dim, device)
    query = _draw(rng.standard_normal((heads, head_dim)).astype(np.float32),
                  device)
    return emb_k, emb_v, query


def decode_inputs(tables, toks: torch.Tensor, *, kv_heads: int = 1):
    """(B, S) ids -> (q (B, heads, head_dim), k and v caches (B, S,
    kv_heads, head_dim), lengths (B,) int32): the arguments of
    ``ops.decode_attention``. A row's length is its live (non-pad) token
    count, at least 1."""
    emb_k, emb_v, query = tables
    b, seq = toks.shape
    head_dim = query.shape[1]
    lengths = (toks > 0).sum(1).clamp_min(1).to(torch.int32)
    return (query.expand(b, *query.shape),
            emb_k[toks].reshape(b, seq, kv_heads, head_dim),
            emb_v[toks].reshape(b, seq, kv_heads, head_dim), lengths)


def hsv_labels(crops: np.ndarray, ranges: torch.Tensor, device: torch.device,
               block_rows: int) -> np.ndarray:
    """(B, H, W, 3) host crops -> (B,) int64 dominant-color labels, through
    one hooked ``hsv_color`` launch on ``device``."""
    with launch.thread_stream(device):
        _, label = ops.hsv_color_classify(to_device(crops, device), ranges,
                                          block_rows=block_rows)
        return label.cpu().numpy()


# --------------------------------------------------------------------------- #
# builders                                                                    #
# --------------------------------------------------------------------------- #
def color_predicate(
    color: str = "black",
    *,
    size: int = 64,
    device="cuda",
    resource: str = "cuda:0",
    name: str = None,
) -> Predicate:
    """HSV color classifier over ``crop`` (B, size, size, 3) RGB [0,255].

    The paper's DogColorClassifier: kernel-fused RGB->HSV + range bucketing
    + histogram argmax; passes rows whose dominant color == ``color``."""
    target = ref.COLOR_NAMES.index(color)
    block_rows = block_divisor(size, 64)
    dev = launch.require_device(device)
    ranges = torch.as_tensor(ref.COLOR_RANGES, device=dev)

    def fn(d):
        return hsv_labels(d["crop"], ranges, dev, block_rows)

    name = name or f"color_is_{color}"
    udf = UDF(
        name, fn, columns=("crop",), resource=resource,
        warm_fn=one_row_probe(fn, {"crop": (size, size, 3)},
                               {"crop": np.float32}),
        cost_model=rooflines.hsv_color(size, size).cost_model,
        proxy_cost=lambda d: float(np.asarray(d["crop"]).size),
        fingerprint=canonical_fingerprint(
            "hsv_color", color=color, size=size, device=dev.type),
    )
    return Predicate(name, udf, compare=lambda o: o == target)


def topic_router_predicate(
    expert: int = 0,
    *,
    n_experts: int = 8,
    k: int = 2,
    dim: int = 16,
    vocab: int = 256,
    seq: int = 64,
    seed: int = 0,
    device="cuda",
    resource: str = "cuda:0",
    name: str = None,
) -> Predicate:
    """MoE top-k gate over mean-pooled token embeddings (``tokens`` column).

    Passes rows whose top-1 expert == ``expert`` — content routing as a
    predicate, with the fused moe_router kernel doing the gating."""
    dev = _text_device(device)
    emb, w_gate = router_tables(n_experts=n_experts, dim=dim, vocab=vocab,
                                seed=seed, device=dev)

    def fn(d):
        with launch.thread_stream(dev):
            toks = token_ids(d["tokens"], seq, vocab, dev)
            _, idx = ops.moe_router_tokens(toks, emb, w_gate, k)
            return idx.cpu().numpy()[:, 0]

    name = name or f"routes_to_expert{expert}"
    udf = UDF(
        name, fn, columns=("tokens",), resource=resource,
        warm_fn=one_row_probe(fn, {"tokens": (seq,)}, {"tokens": np.int32}),
        cost_model=rooflines.moe_router(n_experts, k).cost_model,
        proxy_cost=_token_proxy,
        fingerprint=canonical_fingerprint(
            "moe_router", expert=expert, n_experts=n_experts, k=k, dim=dim,
            vocab=vocab, seq=seq, seed=seed, device=dev.type),
    )
    return Predicate(name, udf, compare=lambda o: o == expert)


def ssd_scorer_predicate(
    threshold: float = 0.0,
    *,
    seq: int = 64,
    heads: int = 2,
    head_dim: int = 4,
    state: int = 4,
    vocab: int = 256,
    seed: int = 1,
    device="cuda",
    resource: str = "cuda:0",
    name: str = None,
) -> Predicate:
    """Mamba-2 SSD sequence scorer over ``tokens``; passes score > threshold.

    Token embeddings drive x/B/C; dt gates off padding (dt=0 there, so pads
    never update the state). Score = mean of the scanned output."""
    dev = _text_device(device)
    tables = ssd_tables(heads=heads, head_dim=head_dim, state=state,
                        vocab=vocab, seed=seed, device=dev)
    chunk = block_divisor(seq, 64)

    def fn(d):
        with launch.thread_stream(dev):
            toks = token_ids(d["tokens"], seq, vocab, dev)
            y, _ = ops.ssd(*ssd_inputs(tables, toks, heads=heads,
                                       head_dim=head_dim, state=state),
                           chunk=chunk)
            return row_mean(y).cpu().numpy()

    name = name or "ssd_score_pos"
    udf = UDF(
        name, fn, columns=("tokens",), resource=resource,
        warm_fn=one_row_probe(fn, {"tokens": (seq,)}, {"tokens": np.int32}),
        cost_model=rooflines.ssd(seq, heads, head_dim, state).cost_model,
        proxy_cost=_token_proxy,
        fingerprint=canonical_fingerprint(
            "ssd", threshold=threshold, seq=seq, heads=heads,
            head_dim=head_dim, state=state, vocab=vocab, seed=seed,
            device=dev.type),
    )
    return Predicate(name, udf, compare=lambda o: o > threshold)


def rglru_gate_predicate(
    threshold: float = 0.0,
    *,
    seq: int = 64,
    width: int = 16,
    vocab: int = 256,
    seed: int = 2,
    device="cuda",
    resource: str = "cuda:0",
    name: str = None,
) -> Predicate:
    """RG-LRU recurrent scorer over ``tokens``: final-state mean > threshold."""
    dev = _text_device(device)
    emb_x, emb_r, emb_i, a_param = rglru_tables(width=width, vocab=vocab,
                                                seed=seed, device=dev)

    def fn(d):
        with launch.thread_stream(dev):
            toks = token_ids(d["tokens"], seq, vocab, dev)
            _, h_last = ops.rglru_tokens(toks, emb_x, emb_r, emb_i, a_param)
            return row_mean(h_last).cpu().numpy()

    name = name or "rglru_gate_pos"
    udf = UDF(
        name, fn, columns=("tokens",), resource=resource,
        warm_fn=one_row_probe(fn, {"tokens": (seq,)}, {"tokens": np.int32}),
        cost_model=rooflines.rglru(seq, width).cost_model,
        proxy_cost=_token_proxy,
        fingerprint=canonical_fingerprint(
            "rglru", threshold=threshold, seq=seq, width=width, vocab=vocab,
            seed=seed, device=dev.type),
    )
    return Predicate(name, udf, compare=lambda o: o > threshold)


def attention_scorer_predicate(
    threshold: float = 0.0,
    *,
    seq: int = 32,
    heads: int = 2,
    head_dim: int = 8,
    vocab: int = 256,
    seed: int = 3,
    device="cuda",
    resource: str = "cuda:0",
    name: str = None,
) -> Predicate:
    """Causal flash-attention scorer over ``tokens``: output mean > threshold."""
    dev = _text_device(device)
    tables = attention_tables(heads=heads, head_dim=head_dim, vocab=vocab,
                              seed=seed, device=dev)

    def fn(d):
        with launch.thread_stream(dev):
            toks = token_ids(d["tokens"], seq, vocab, dev)
            out = ops.flash_attention(
                *attention_inputs(tables, toks, heads=heads,
                                  head_dim=head_dim),
                causal=True, block_q=seq, block_k=seq)
            return row_mean(out).cpu().numpy()

    name = name or "attn_score_pos"
    udf = UDF(
        name, fn, columns=("tokens",), resource=resource,
        warm_fn=one_row_probe(fn, {"tokens": (seq,)}, {"tokens": np.int32}),
        cost_model=rooflines.flash_attention(seq, heads, head_dim).cost_model,
        proxy_cost=_token_proxy,
        fingerprint=canonical_fingerprint(
            "flash_attention", threshold=threshold, seq=seq, heads=heads,
            head_dim=head_dim, vocab=vocab, seed=seed, device=dev.type),
    )
    return Predicate(name, udf, compare=lambda o: o > threshold)


def decode_relevance_predicate(
    threshold: float = 0.0,
    *,
    seq: int = 32,
    heads: int = 2,
    head_dim: int = 8,
    kv_heads: int = 1,
    vocab: int = 256,
    seed: int = 4,
    device="cuda",
    resource: str = "cuda:0",
    name: str = None,
) -> Predicate:
    """Decode-attention relevance over ``tokens``: a fixed query attends the
    row's token KV cache (true lengths mask padding); mean > threshold."""
    dev = _text_device(device)
    tables = decode_tables(heads=heads, head_dim=head_dim, kv_heads=kv_heads,
                           vocab=vocab, seed=seed, device=dev)

    def fn(d):
        with launch.thread_stream(dev):
            toks = token_ids(d["tokens"], seq, vocab, dev)
            out = ops.decode_attention(
                *decode_inputs(tables, toks, kv_heads=kv_heads), block_k=seq)
            return row_mean(out).cpu().numpy()

    name = name or "decode_relevance_pos"
    udf = UDF(
        name, fn, columns=("tokens",), resource=resource,
        warm_fn=one_row_probe(fn, {"tokens": (seq,)}, {"tokens": np.int32}),
        cost_model=rooflines.decode_attention(
            seq, heads, head_dim, kv_heads).cost_model,
        proxy_cost=_token_proxy,
        fingerprint=canonical_fingerprint(
            "decode_attention", threshold=threshold, seq=seq, heads=heads,
            head_dim=head_dim, kv_heads=kv_heads, vocab=vocab, seed=seed,
            device=dev.type),
    )
    return Predicate(name, udf, compare=lambda o: o > threshold)


# --------------------------------------------------------------------------- #
# registry                                                                    #
# --------------------------------------------------------------------------- #
# kernel launch name (what StatsBoard entries report under) -> builder
KERNEL_PREDICATES: Dict[str, Callable[..., Predicate]] = {
    "hsv_color": color_predicate,
    "moe_router": topic_router_predicate,
    "ssd": ssd_scorer_predicate,
    "rglru": rglru_gate_predicate,
    "flash_attention": attention_scorer_predicate,
    "decode_attention": decode_relevance_predicate,
}


def register_kernel_predicate(kernel: str,
                              builder: Callable[..., Predicate]) -> None:
    """Register a builder under its kernel's launch name."""
    if kernel in KERNEL_PREDICATES:
        raise ValueError(f"kernel predicate {kernel!r} already registered")
    KERNEL_PREDICATES[kernel] = builder


def build_predicate(kernel: str, **kwargs) -> Predicate:
    """Instantiate the registered builder for ``kernel``."""
    try:
        builder = KERNEL_PREDICATES[kernel]
    except KeyError:
        raise KeyError(
            f"no kernel predicate registered for {kernel!r}; "
            f"known: {sorted(KERNEL_PREDICATES)}"
        ) from None
    return builder(**kwargs)
