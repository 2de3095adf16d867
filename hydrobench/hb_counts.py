"""The yardstick's arithmetic: peaks, model FLOPs and kernel bounds.

Frozen with the benchmark. Every formula counts the work a call's shapes
need, whatever implements it, and never reads the program.

Peaks (NVIDIA H100 SXM data sheet, dense, no sparsity; at a power limit of
700 W): 989 TFLOP/s in bf16 on the tensor cores, 3.35 TB/s of HBM3. A
configuration that states bf16 is held to the bf16 peak: a kernel that
computes in float32 gains nothing the configuration asks for.

Model FLOPs (``dense_row_flops``, ``ssm_row_flops``) count the matrix
products of a forward over one row's live tokens, two operations a
multiply-add:

- dense decoder, per layer and token: q, k, v and o projections,
  2 d (H + 2 Hkv) D + 2 H D d, and the SwiGLU MLP, 6 d F; per layer and
  row, attention over the causal triangle, 4 H D n (n + 1) / 2 (scores
  and the weighted sum of values); the head, 2 d V a token.
- Mamba2, per layer and token: the in-projections to z, x, B, C and dt,
  2 d (2 Di + 2 G N + H), and the out-projection, 2 Di d; the SSD scan's
  chunked form (``ssd_flops``) over n tokens in chunks of Q = min(64, n):
  per head and chunk of L tokens 2 L P N multiply-adds (the chunk's state
  and C times the state coming in) and L (L + 1) / 2 (N + P) on the
  triangle (C B^T and its product with x); the head, 2 d V a token. The
  causal convolution, gates and norms are elementwise and not counted.

Kernel bounds (``flash_fwd_bound_s``, ``ssd_fwd_bound_s``): the larger of
the call's operations over the bf16 peak and its bytes over the HBM
bandwidth, each input read once and each output written once, at the
configuration's precision (2 bytes a bf16 element, 4 a float32 one).
"""
from __future__ import annotations

PEAK_BF16_FLOPS = 989e12   # H100 SXM, dense bf16 tensor-core rate
PEAK_HBM_BYTES = 3.35e12   # H100 SXM, HBM3
BF16, F32 = 2, 4


def dense_row_flops(cfg: dict, n: int) -> float:
    """Forward FLOPs of the dense decoder over one row of ``n`` live
    tokens. ``cfg`` holds the configuration file's published keys."""
    d = cfg["hidden_size"]
    h, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg["head_dim"]
    f, v, layers = cfg["intermediate_size"], cfg["vocab_size"], \
        cfg["num_hidden_layers"]
    per_token = layers * (2 * d * (h + 2 * hkv) * hd + 2 * h * hd * d
                          + 6 * d * f) + 2 * d * v
    attention = layers * 4 * h * hd * n * (n + 1) / 2
    return float(per_token * n + attention)


def ssd_flops(b: int, s: int, h: int, p: int, n: int, chunk: int) -> float:
    """The chunked SSD scan over ``b`` rows of ``s`` tokens, ``h`` heads of
    ``p`` channels and state ``n``, chunks of ``chunk`` (the last one may
    be shorter)."""
    total = 0.0
    full, rest = divmod(s, chunk)
    for length, count in ((chunk, full), (rest, 1 if rest else 0)):
        tri = length * (length + 1) / 2
        total += count * (2 * length * p * n + tri * (n + p))
    return 2.0 * b * h * total


def ssm_row_flops(cfg: dict, n: int) -> float:
    """Forward FLOPs of Mamba2 over one row of ``n`` live tokens."""
    d, layers, v = cfg["d_model"], cfg["n_layer"], cfg["vocab_size"]
    di = cfg["expand"] * d
    p, state, g = cfg["headdim"], cfg["d_state"], cfg["ngroups"]
    heads = di // p
    per_token = layers * (2 * d * (2 * di + 2 * g * state + heads)
                          + 2 * di * d) + 2 * d * v
    scan = layers * ssd_flops(1, n, heads, p, state, min(64, n))
    return float(per_token * n + scan)


def flash_fwd_bound_s(b: int, s: int, h: int, hkv: int, d: int) -> float:
    """Least time of one causal bf16 attention call: q, k, v read and o
    written once; 4 H D a visible (query, key) pair, S (S + 1) / 2 pairs a
    row and head."""
    ops = 4.0 * b * h * d * s * (s + 1) / 2
    nbytes = BF16 * b * s * d * (2 * h + 2 * hkv)
    return max(ops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def ssd_fwd_bound_s(b: int, s: int, h: int, p: int, n: int, g: int,
                    chunk: int) -> float:
    """Least time of one SSD forward call at the configuration's
    precision: x and y (B, S, H, P) and B, C (B, S, G, N) in bf16, dt (B,
    S, H) and the last state (B, H, P, N) in float32, each once; the
    chunked scan's operations (``ssd_flops``)."""
    ops = ssd_flops(b, s, h, p, n, chunk)
    nbytes = (BF16 * (2 * b * s * h * p + 2 * b * s * g * n)
              + F32 * (b * s * h + b * h * p * n))
    return max(ops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)
