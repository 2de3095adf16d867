"""Plain PyTorch versions of the port's kernels.

These are what the CPU tests compare against the JAX package and what
``chip_smoke.py`` holds each kernel against on the card. A kernel wrapper
takes its plain version only for tensors that lie on the CPU; nothing on
the main path runs them when a card is present.
"""
from __future__ import annotations

import numpy as np
import torch

# --------------------------------------------------------------------------- #
# HSV color classification (the paper's DogColorClassifier)                    #
# --------------------------------------------------------------------------- #
# ranges follow the paper's example: red = (0,50,70)..(9,255,255), etc.
COLOR_NAMES = (
    "red", "black", "gray", "yellow", "green", "blue", "purple", "pink",
    "white", "other",
)
# (lo_h, lo_s, lo_v, hi_h, hi_s, hi_v) with H in [0,180), S,V in [0,256)
COLOR_RANGES = np.array(
    [
        [0, 50, 70, 9, 255, 255],      # red
        [0, 0, 0, 180, 255, 45],       # black
        [0, 0, 46, 180, 50, 200],      # gray
        [20, 50, 70, 33, 255, 255],    # yellow
        [34, 50, 70, 85, 255, 255],    # green
        [86, 50, 70, 128, 255, 255],   # blue
        [129, 50, 70, 158, 255, 255],  # purple
        [159, 50, 70, 177, 255, 255],  # pink
        [0, 0, 201, 180, 49, 255],     # white
    ],
    dtype=np.float32,
)


def _remainder(x: torch.Tensor, m: float) -> torch.Tensor:
    """Float ``%`` as the JAX package computes it (``jnp.remainder``):
    C's ``fmod``, then ``+ m`` where the result is nonzero and of the other
    sign. ``torch.remainder`` computes ``x - m*floor(x/m)`` instead, which
    can differ in the last bit."""
    r = torch.fmod(x, m)
    return torch.where((r != 0) & (r < 0), r + m, r)


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """RGB in [0,255] -> HSV with H in [0,180), S,V in [0,255] (OpenCV scale).

    The float32 operations run in the JAX package's order, so results are
    bit-equal to ``repro.kernels.ref.rgb_to_hsv``."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    diff = mx - mn
    one = torch.ones((), dtype=rgb.dtype, device=rgb.device)
    safe = torch.where(diff == 0, one, diff)
    h = torch.where(
        mx == r,
        _remainder((g - b) / safe, 6.0),
        torch.where(mx == g, (b - r) / safe + 2.0, (r - g) / safe + 4.0),
    )
    h = torch.where(diff == 0, torch.zeros_like(h), h) * 30.0  # OpenCV H/2
    s = torch.where(mx == 0, torch.zeros_like(mx),
                    diff / torch.where(mx == 0, one, mx)) * 255.0
    return torch.stack([h, s, mx], dim=-1)


def hsv_color_buckets(crops: torch.Tensor,
                      ranges: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) RGB -> (B, H, W) int64 bucket per pixel: the index of
    the first range that holds it, or C ('other') when none does."""
    hsv = rgb_to_hsv(crops.to(torch.float32))
    c = ranges.shape[0]
    bucket = torch.full(hsv.shape[:-1], c, dtype=torch.int64,
                        device=crops.device)
    # walk the ranges last to first so the first match is written last
    for j in range(c - 1, -1, -1):
        lo, hi = ranges[j, 0:3], ranges[j, 3:6]
        inside = ((hsv >= lo) & (hsv <= hi)).all(dim=-1)
        bucket = torch.where(inside, torch.full_like(bucket, j), bucket)
    return bucket


def hsv_color_classify(crops: torch.Tensor, ranges: torch.Tensor | None = None):
    """(B, H, W, 3) RGB [0,255] -> (B, n_colors+1) pixel-fraction histogram.

    Class = argmax fraction (last bucket = 'other'; ties go to the lowest
    index). Returns (hist, label). The histogram is an exact integer count
    scaled once by ``inv_pixels(H*W)``, as the JAX package's ``mean``
    computes it."""
    if ranges is None:
        ranges = torch.as_tensor(COLOR_RANGES, device=crops.device)
    ranges = ranges.to(device=crops.device, dtype=torch.float32)
    b, h, w, _ = crops.shape
    nb = ranges.shape[0] + 1
    bucket = hsv_color_buckets(crops, ranges)
    offsets = torch.arange(b, device=crops.device).view(b, 1, 1) * nb
    counts = torch.bincount((bucket + offsets).reshape(-1),
                            minlength=b * nb).view(b, nb)
    hist = counts.to(torch.float32) * inv_pixels(h * w)
    return hist, torch.argmax(hist, dim=-1)


def inv_pixels(n: int) -> float:
    """The float32 reciprocal of ``n``. The JAX package's ``mean`` scales
    the exact count by it (XLA turns the division by a constant into this
    product), which can differ from the true quotient by one ulp; the
    kernel and this plain version scale the same way."""
    return float(np.float32(1.0) / np.float32(n))


# --------------------------------------------------------------------------- #
# MoE top-k router                                                             #
# --------------------------------------------------------------------------- #
MASKED = -1e30  # what the router writes over a chosen expert, and what a
                # masked attention logit becomes (finite, not -inf)


def softmax(x: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis as ``jax.nn.softmax`` computes it: the
    max subtracted, exp, divided by the sum."""
    unnormalized = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return unnormalized / unnormalized.sum(dim=-1, keepdim=True)


def moe_topk_router(logits: torch.Tensor, k: int):
    """(T, E) -> (weights (T,k) renormalized softmax, idx (T,k) int32).

    k rounds of argmax then mask, so the lowest index wins a tie as in the
    JAX package's ``lax.top_k`` and its kernel (``torch.topk`` leaves the
    order of ties unspecified)."""
    remaining = softmax(logits.to(torch.float32))
    ws, idxs = [], []
    for _ in range(k):
        idx = torch.argmax(remaining, dim=-1, keepdim=True)  # first maximum
        ws.append(torch.gather(remaining, -1, idx))
        idxs.append(idx)
        remaining = remaining.scatter(-1, idx, MASKED)
    w = torch.cat(ws, dim=-1)
    w = w / w.sum(dim=-1, keepdim=True)
    return w.to(logits.dtype), torch.cat(idxs, dim=-1).to(torch.int32)


def moe_router_bwd(w: torch.Tensor, idx: torch.Tensor, dw: torch.Tensor,
                   num_experts: int) -> torch.Tensor:
    """The logits' gradient of ``moe_topk_router``: (T, E) float32 from the
    (T, k) weights, their experts and the weights' cotangent.

    The renormalised weights are a softmax over the k chosen logits (the
    full softmax's sum cancels), so ``dlogit[t, idx[t, m]] = w[t, m] *
    (dw[t, m] - s[t])`` with ``s[t] = sum_j w[t, j] * dw[t, j]`` taken in
    j order, and 0 at every expert not chosen; the indices carry none. The
    kernel (``csrc/moe_router.cu``) computes the same products and sums in
    the same order."""
    w, dw = w.to(torch.float32), dw.to(torch.float32)
    s = torch.zeros_like(w[:, 0])
    for j in range(w.shape[1]):
        s = s + w[:, j] * dw[:, j]
    vals = w * (dw - s[:, None])
    out = torch.zeros((w.shape[0], num_experts), dtype=torch.float32,
                      device=w.device)
    return out.scatter_(1, idx.to(torch.int64), vals)


def fixed_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` by halving it, in an order fixed by its length.

    A library reduction may split its work by the other dimensions' sizes
    (and a matrix product pick its algorithm by them), so a row's sum could
    change with the batch it sits in; these elementwise adds cannot, and
    they round the same on the card and on the CPU. Each level adds
    element j + half to element j for j < half; an odd length moves its
    last element to slot half. The router kernel's token entry sums in
    this order too."""
    x = x.movedim(dim, 0)
    while x.shape[0] > 1:
        half = x.shape[0] // 2
        head = x[:half] + x[half:2 * half]
        x = torch.cat([head, x[2 * half:]]) if x.shape[0] % 2 else head
    return x[0]


def _mean_pool(emb: torch.Tensor, toks: torch.Tensor) -> torch.Tensor:
    """(B, S) ids -> (B, dim): the sum of their embeddings over S divided
    by the live (non-pad) count, at least 1."""
    live = (toks > 0).sum(1, keepdim=True).clamp_min(1)
    return fixed_sum(emb[toks], 1) / live.to(torch.float32)


def router_logits(emb: torch.Tensor, w_gate: torch.Tensor,
                  toks: torch.Tensor) -> torch.Tensor:
    """(B, S) ids -> (B, E) gate logits of the mean-pooled embeddings. The
    (B, dim) @ (dim, E) product is an elementwise product and a
    ``fixed_sum``, so a row's logits do not depend on its batch."""
    return fixed_sum(_mean_pool(emb, toks)[:, :, None] * w_gate, 1)


def moe_router_tokens(toks: torch.Tensor, emb: torch.Tensor,
                      w_gate: torch.Tensor, k: int,
                      logits_out: torch.Tensor | None = None):
    """The router over each row's mean-pooled token embeddings: (B, S) ids
    -> (weights (B, k), idx (B, k) int32), ``moe_topk_router`` of
    ``router_logits``; ``logits_out`` (B, E), if given, receives the
    logits."""
    logits = router_logits(emb, w_gate, toks)
    if logits_out is not None:
        logits_out.copy_(logits)
    return moe_topk_router(logits, k)


# --------------------------------------------------------------------------- #
# RG-LRU (recurrentgemma / griffin)                                            #
# --------------------------------------------------------------------------- #
def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, which is ``logaddexp(x, 0)``:
    ``max(x, 0) + log1p(exp(-|x|))``."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``1 / (1 + exp(-x))``, the form the CUDA kernel computes."""
    return 1.0 / (1.0 + torch.exp(-x))


def rglru(
    x: torch.Tensor,        # (B, S, W) gated input
    r: torch.Tensor,        # (B, S, W) recurrence gate pre-activation
    i: torch.Tensor,        # (B, S, W) input gate pre-activation
    a_param: torch.Tensor,  # (W,) learnable Lambda pre-activation
    h0: torch.Tensor | None = None,  # (B, W) initial state
    *,
    c: float = 8.0,
):
    """RG-LRU: h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t).

    a_t = exp(-c * softplus(a_param) * sigmoid(r_t)). Returns (h_seq,
    h_last), both in x's dtype; the scan walks S in order."""
    b, s, w = x.shape
    xf = x.to(torch.float32)
    log_a = -c * softplus(a_param.to(torch.float32)) * sigmoid(
        r.to(torch.float32))
    a = torch.exp(log_a)
    gated = sigmoid(i.to(torch.float32)) * xf
    multiplier = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12))
    inp = multiplier * gated
    h = (torch.zeros((b, w), dtype=torch.float32, device=x.device)
         if h0 is None else h0.to(torch.float32))
    hs = []
    for t in range(s):
        h = a[:, t] * h + inp[:, t]
        hs.append(h)
    out = torch.stack(hs, dim=1) if hs else xf.new_zeros((b, 0, w))
    return out.to(x.dtype), h.to(x.dtype)


def rglru_bwd(x, r, i, a_param, h0, hs, dout, dh_last, *, c: float = 8.0):
    """The RG-LRU gradient kernel's plain version, by the explicit formulas
    (no autograd), in float32: (dx, dr, di, da_param, dh0) of ``rglru(x,
    r, i, a_param, h0)`` for the cotangents ``dout`` (B, S, W) of its h
    sequence and ``dh_last`` (B, W) of its last state (None: zero). ``hs``
    is the forward's h sequence in float32 (a bf16 model's output is
    rounded, so h_{t-1} is not rebuilt from it); dh0 is None when h0 is.
    With sr = sigmoid(r), a = exp(-c softplus(a_param) sr), g =
    sigmoid(i) x and m = sqrt(max(1 - a^2, 1e-12)), walking t down from
    S - 1:
        dh_t = dout_t + a_{t+1} dh_{t+1}      (dh_last at t = S - 1)
        da_t = dh_t h_{t-1} - dh_t g_t a_t / m_t   (0 where the clamp binds)
    then dx = dh m sigmoid(i), di = dh m x sigmoid'(i), dr = da a (-c
    softplus(a_param)) sigmoid'(r), da_param = sum over B and S of da a
    (-c sr), times sigmoid(a_param), and dh0 = a_0 dh_0."""
    f32 = torch.float32
    b, s, w = x.shape
    xf = x.to(f32)
    nsp = -c * softplus(a_param.to(f32))
    sr = sigmoid(r.to(f32))
    si = sigmoid(i.to(f32))
    a = torch.exp(nsp * sr)
    g = si * xf
    one_m = 1.0 - a * a
    m = torch.sqrt(torch.clamp_min(one_m, 1e-12))
    first = (torch.zeros((b, 1, w), dtype=f32, device=x.device) if h0 is None
             else h0.to(f32)[:, None])
    hprev = torch.cat([first, hs.to(f32)[:, :-1]], dim=1)
    carry = (torch.zeros((b, w), dtype=f32, device=x.device)
             if dh_last is None else dh_last.to(f32))
    do = dout.to(f32)
    dh = torch.empty((b, s, w), dtype=f32, device=x.device)
    for t in range(s - 1, -1, -1):
        cur = do[:, t] + carry
        dh[:, t] = cur
        carry = a[:, t] * cur
    dg = dh * m
    dx = dg * si
    di = dg * xf * (si * (1.0 - si))
    da = dh * hprev - torch.where(one_m > 1e-12, dh * g * a / m,
                                  torch.zeros_like(a))
    dlog = da * a
    dr = dlog * nsp * (sr * (1.0 - sr))
    da_param = (dlog * (-c * sr)).sum((0, 1)) * sigmoid(a_param.to(f32))
    return dx, dr, di, da_param, None if h0 is None else carry


def rglru_tokens(
    toks: torch.Tensor,     # (B, S) token ids
    emb_x: torch.Tensor,    # (V, W)
    emb_r: torch.Tensor,    # (V, W)
    emb_i: torch.Tensor,    # (V, W)
    a_param: torch.Tensor,  # (W,)
    h0: torch.Tensor | None = None,
    *,
    c: float = 8.0,
):
    """``rglru`` over the embedding rows of each row's tokens."""
    return rglru(emb_x[toks], emb_r[toks], emb_i[toks], a_param, h0, c=c)


# --------------------------------------------------------------------------- #
# Mamba-2 SSD (state-space duality)                                            #
# --------------------------------------------------------------------------- #
def _segsum(x: torch.Tensor) -> torch.Tensor:
    """Stable segment-sum: out[..., i, j] = sum_{j < k <= i} x[..., k],
    -inf above the diagonal."""
    t = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
    return out.masked_fill(~mask, -torch.inf)


def ssd(
    x: torch.Tensor,    # (B, S, H, P)
    dt: torch.Tensor,   # (B, S, H) positive step sizes
    A: torch.Tensor,    # (H,) negative decay parameter
    Bm: torch.Tensor,   # (B, S, G, N)
    Cm: torch.Tensor,   # (B, S, G, N)
    h0: torch.Tensor | None = None,  # (B, H, P, N)
    *,
    chunk: int = 64,
):
    """Chunked SSD (Mamba-2). G (B/C groups) must divide H. Returns
    (y in x's dtype, h_last float32).

    y_t = C_t^T sum_{s<=t} (prod_{s<r<=t} exp(A*dt_r)) dt_s B_s x_s,
    computed chunkwise: quadratic within a chunk, a recurrence between."""
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("ref.ssd needs float32 products on the card: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    if h % g or s % chunk:
        raise ValueError(f"need G | H and chunk | S, got H={h} G={g} "
                         f"S={s} chunk={chunk}")
    nc = s // chunk
    rep = h // g

    xf = x.to(torch.float32)
    dtf = dt.to(torch.float32)
    Af = A.to(torch.float32)
    Bf = torch.repeat_interleave(Bm.to(torch.float32), rep, dim=2)  # (B,S,H,N)
    Cf = torch.repeat_interleave(Cm.to(torch.float32), rep, dim=2)

    xc = xf.reshape(b, nc, chunk, h, p)
    dtc = dtf.reshape(b, nc, chunk, h)
    Bc = Bf.reshape(b, nc, chunk, h, n)
    Cc = Cf.reshape(b, nc, chunk, h, n)

    dA = (dtc * Af).movedim(-1, 2)              # (B,NC,H,L) log-decay per step
    dA_cum = torch.cumsum(dA, dim=-1)

    # within a chunk (quadratic)
    Lmat = torch.exp(_segsum(dA))               # (B,NC,H,L,L)
    scores = torch.einsum("bchln,bcmhn->bchlm", Cc.movedim(3, 2), Bc)
    att = scores * Lmat * dtc.movedim(-1, 2)[:, :, :, None, :]
    y_intra = torch.einsum("bchlm,bcmhp->bclhp", att, xc)

    # each chunk's own state
    decay_to_end = torch.exp(dA_cum[..., -1:] - dA_cum)  # (B,NC,H,L)
    states = torch.einsum("bclhn,bchl,bclh,bclhp->bchpn",
                          Bc, decay_to_end, dtc, xc)      # (B,NC,H,P,N)

    # between chunks: the state entering each chunk
    chunk_decay = torch.exp(dA_cum[..., -1])    # (B,NC,H)
    hprev = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if h0 is None else h0.to(torch.float32))
    h_in = []
    for ci in range(nc):
        h_in.append(hprev)
        hprev = hprev * chunk_decay[:, ci, :, None, None] + states[:, ci]
    h_in = torch.stack(h_in, dim=1)             # (B,NC,H,P,N)

    in_decay = torch.exp(dA_cum)                # chunk start to position l
    y_inter = torch.einsum("bclhn,bchl,bchpn->bclhp", Cc, in_decay, h_in)

    y = (y_intra + y_inter).reshape(b, s, h, p)
    return y.to(x.dtype), hprev


def ssd_bwd(x, dt, A, Bm, Cm, h0, dy, dh_last, *, chunk: int = 64):
    """(dx, ddt, dA, dB, dC, dh0), float32 (float64 for float64 x): the
    gradient of ``ssd`` for
    the cotangents ``dy`` (B, S, H, P) and ``dh_last`` (B, H, P, N), each
    None for zero; dh0 is None when h0 is. In closed form, in the stages
    of the gradient kernel (``csrc/ssd_bwd.cu``), with cum the running sum
    of dt * A within a chunk, cum_L its last value, e_l = exp(cum_l),
    ex_l = exp(cum_L - cum_l) and w_lm = exp(cum_l - cum_m) for m <= l:

    1. chunk states: S_c = sum_l ex_l dt_l x_l B_l^T and
       Q_c = sum_l e_l dy_l C_l^T;
    2. the passes: h_in(c + 1) = exp(cum_L) h_in(c) + S_c from h0, and the
       gradient dH_c of chunk c's exit state, dH_{c-1} = exp(cum_L) dH_c
       + Q_c from dh_last (dh0 = dH_{-1});
    3. per chunk, with s_lm = C_l . B_m and D_lm = dy_l . x_m:
       dx_m = sum_l s_lm w_lm dt_m dy_l + ex_m dt_m dH B_m,
       dC_l = sum_m w_lm dt_m D_lm B_m + e_l h_in^T dy_l,
       dB_m = sum_l w_lm dt_m D_lm C_l + ex_m dt_m dH^T x_m,
       ddt_m = sum_l s_lm w_lm D_lm + ex_m x_m^T dH B_m + A da_m, where
       da_k = sum_{l >= k} dcum_l is the gradient through cum, and
       dA = sum dt da;
    4. dB and dC summed over the H / G heads of a group.

    ddt is a difference of large terms (dt's own weight against the decay
    it sets): compare it with a tolerance scaled by its largest value. At
    mamba2's widths every gradient sums ~100 terms with cancellation, so
    any two float32 orders differ by more than ``TOL_TIGHT`` on some
    elements; a float64 evaluation (float64 inputs) is the yardstick."""
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    if h % g or s % chunk:
        raise ValueError(f"need G | H and chunk | S, got H={h} G={g} "
                         f"S={s} chunk={chunk}")
    nc, rep, L = s // chunk, h // g, chunk
    work = torch.promote_types(x.dtype, torch.float32)

    def heads_first(t, last):   # (B, S, H, last) -> (B, H, NC, L, last)
        return t.to(work).reshape(b, nc, L, h, last).permute(0, 3, 1, 2, 4)

    xc = heads_first(x, p)
    dyc = (torch.zeros_like(xc) if dy is None else heads_first(dy, p))
    Bc = heads_first(torch.repeat_interleave(Bm.to(work), rep, dim=2), n)
    Cc = heads_first(torch.repeat_interleave(Cm.to(work), rep, dim=2), n)
    dtc = dt.to(work).reshape(b, nc, L, h).permute(0, 3, 1, 2)  # (B,H,NC,L)
    Af = A.to(work)[None, :, None, None]
    cum = torch.cumsum(dtc * Af, dim=-1)
    cum_last = cum[..., -1]                                    # (B,H,NC)
    e = torch.exp(cum)
    ex = torch.exp(cum_last[..., None] - cum)

    # 1. chunk states
    S = torch.einsum("bhcl,bhclp,bhcln->bhcpn", ex * dtc, xc, Bc)
    Q = torch.einsum("bhcl,bhclp,bhcln->bhcpn", e, dyc, Cc)

    # 2. the two passes over the chunks
    decay = torch.exp(cum_last)[..., None, None]               # (B,H,NC,1,1)
    state = (torch.zeros((b, h, p, n), dtype=work, device=x.device)
             if h0 is None else h0.to(work))
    h_in = []
    for c in range(nc):
        h_in.append(state)
        state = decay[:, :, c] * state + S[:, :, c]
    h_in = torch.stack(h_in, dim=2)                            # (B,H,NC,P,N)
    grad = (torch.zeros((b, h, p, n), dtype=work, device=x.device)
            if dh_last is None else dh_last.to(work))
    dH = [None] * nc
    for c in reversed(range(nc)):
        dH[c] = grad
        grad = decay[:, :, c] * grad + Q[:, :, c]
    dH = torch.stack(dH, dim=2)
    dh0 = None if h0 is None else grad

    # 3. per chunk
    seg = cum[..., :, None] - cum[..., None, :]                # l, m
    lower = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    w = torch.exp(seg.masked_fill(~lower, -torch.inf))         # 0 above
    sc = torch.einsum("bhcln,bhcmn->bhclm", Cc, Bc)
    D = torch.einsum("bhclp,bhcmp->bhclm", dyc, xc)
    dt_m = dtc[..., None, :]
    M = sc * w * dt_m                     # y_l's weight of x_m
    E = w * dt_m * D
    row = (M * D).sum(-1)                 # d/dcum_l of the intra terms
    colp = (sc * w * D).sum(-2)           # d/ddt_m of the intra terms
    HB = torch.einsum("bhcpn,bhcmn->bhcmp", dH, Bc)            # dH B_m
    gm = (xc * HB).sum(-1)                                     # x_m . dH B_m
    dx = (torch.einsum("bhclm,bhclp->bhcmp", M, dyc)
          + (ex * dtc)[..., None] * HB)
    hC = torch.einsum("bhcpn,bhcln->bhclp", h_in, Cc)          # h_in C_l
    u = e * (dyc * hC).sum(-1)
    dC = (torch.einsum("bhclm,bhcmn->bhcln", E, Bc)
          + e[..., None] * torch.einsum("bhclp,bhcpn->bhcln", dyc, h_in))
    dB = (torch.einsum("bhclm,bhcln->bhcmn", E, Cc)
          + (ex * dtc)[..., None] * torch.einsum("bhcmp,bhcpn->bhcmn", xc,
                                                 dH))
    v = torch.exp(cum_last) * (h_in * dH).sum((-2, -1))        # (B,H,NC)
    r = dtc * ex * gm
    dcum = row - dtc * colp + u - r
    dcum[..., -1] += v + r.sum(-1)
    da = dcum.flip(-1).cumsum(-1).flip(-1)
    ddt = colp + ex * gm + Af * da
    dA = (dtc * da).sum((0, 2, 3))

    # 4. back to (B, S, ...), dB and dC summed over each group's heads
    def seq_first(t):   # (B, H, NC, L, last) -> (B, S, H, last)
        return t.permute(0, 2, 3, 1, 4).reshape(b, s, h, t.shape[-1])

    dB = seq_first(dB).reshape(b, s, g, rep, n).sum(3)
    dC = seq_first(dC).reshape(b, s, g, rep, n).sum(3)
    return (seq_first(dx), ddt.permute(0, 2, 3, 1).reshape(b, s, h), dA, dB,
            dC, dh0)


def ssd_decode_step(
    x: torch.Tensor,    # (B, H, P) one token
    dt: torch.Tensor,   # (B, H)
    A: torch.Tensor,    # (H,)
    Bm: torch.Tensor,   # (B, G, N)
    Cm: torch.Tensor,   # (B, G, N)
    h: torch.Tensor,    # (B, H, P, N) float32 state
):
    """One recurrent SSD step: h' = exp(dt A) h + dt x B^T, y = h' C.
    Returns (y in x's dtype, h' float32). The JAX package runs this step
    outside any kernel too."""
    rep = x.shape[1] // Bm.shape[1]
    Bf = torch.repeat_interleave(Bm.to(torch.float32), rep, dim=1)  # (B,H,N)
    Cf = torch.repeat_interleave(Cm.to(torch.float32), rep, dim=1)
    dtf = dt.to(torch.float32)
    dA = torch.exp(dtf * A.to(torch.float32))                      # (B,H)
    hnew = h * dA[..., None, None] + (
        (Bf * dtf[..., None])[:, :, None, :] * x.to(torch.float32)[..., None])
    y = torch.einsum("bhn,bhpn->bhp", Cf, hnew)
    return y.to(x.dtype), hnew


# --------------------------------------------------------------------------- #
# attention                                                                    #
# --------------------------------------------------------------------------- #
def _require_float32_products(x: torch.Tensor, name: str) -> None:
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(f"ref.{name} needs float32 products on the card: "
                           "set torch.backends.cuda.matmul.allow_tf32 = False")


def _gqa_expand(k: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, S, Hkv, D) -> (B, S, H, D) by repeating kv heads per group."""
    return torch.repeat_interleave(k, num_heads // k.shape[2], dim=2)


def _visible(sq: int, sk: int, *, causal: bool, window: int, q_offset: int = 0,
             k_offset: int = 0, device=None) -> torch.Tensor:
    """(Sq, Sk) bool: key position j visible to query position i, with
    (not causal or j <= i) and (window <= 0 or j > i - window)."""
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    kpos = torch.arange(sk, device=device)[None, :] + k_offset
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    return mask


def _attn_dense(q, k, v, *, causal, window, q_offset, k_offset=0, kv_len=None):
    """One dense attention tile; q (B,Sq,H,D) vs k/v (B,Sk,H,D) fp32 math.

    Masked logits are -1e30, so a row with no visible key averages every
    value row, as the JAX package's version does."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = float(1.0 / np.sqrt(d))
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    mask = _visible(sq, sk, causal=causal, window=window, q_offset=q_offset,
                    k_offset=k_offset, device=q.device)[None, None]
    if kv_len is not None:
        # kv_len masks ABSOLUTE positions (kpos includes k_offset)
        kpos = torch.arange(sk, device=q.device) + k_offset
        mask = mask & (kpos < kv_len[:, None, None, None])
    probs = softmax(logits.masked_fill(~mask, MASKED))
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.to(torch.float32))
    return out.to(q.dtype)


Q_CHUNK = 512  # q blocking of the chunked path: bounds the live S x S tile


def mha_attention(
    q: torch.Tensor,   # (B, Sq, H, D)
    k: torch.Tensor,   # (B, Sk, Hkv, D)
    v: torch.Tensor,   # (B, Sk, Hkv, D)
    *,
    causal: bool = True,
    window: int = 0,            # >0: sliding window (causal)
    q_offset: int = 0,          # absolute position of q[0] (for decode/chunks)
    kv_len: torch.Tensor | None = None,  # (B,) valid kv length (masks the rest)
    chunk_q: int = Q_CHUNK,     # 0 disables chunking (dense)
) -> torch.Tensor:
    """Reference attention: GQA, causal, sliding-window, length masking.

    q is processed in ``chunk_q`` blocks, one at a time, so only one
    (chunk, Sk) score tile is live; with a sliding window each block sees
    only its (window + chunk) band of k/v."""
    _require_float32_products(q, "mha_attention")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    k = _gqa_expand(k, h)
    v = _gqa_expand(v, h)

    if chunk_q <= 0 or sq <= chunk_q or sq % chunk_q != 0:
        return _attn_dense(q, k, v, causal=causal, window=window,
                           q_offset=q_offset, kv_len=kv_len)

    banded = window > 0 and window + chunk_q < sk
    band = window + chunk_q
    outs = []
    for ci in range(sq // chunk_q):
        qb = q[:, ci * chunk_q:(ci + 1) * chunk_q]
        if banded:
            start = min(max(ci * chunk_q - window, 0), sk - band)
            outs.append(_attn_dense(
                qb, k[:, start:start + band], v[:, start:start + band],
                causal=causal, window=window,
                q_offset=q_offset + ci * chunk_q, k_offset=start,
                kv_len=kv_len))
        else:
            outs.append(_attn_dense(
                qb, k, v, causal=causal, window=window,
                q_offset=q_offset + ci * chunk_q, kv_len=kv_len))
    return torch.cat(outs, dim=1)


def decode_attention(
    q: torch.Tensor,        # (B, H, D) one new token per sequence
    k_cache: torch.Tensor,  # (B, S, Hkv, D)
    v_cache: torch.Tensor,  # (B, S, Hkv, D)
    lengths: torch.Tensor,  # (B,) int32 — number of valid cache entries
) -> torch.Tensor:
    out = mha_attention(q[:, None], k_cache, v_cache, causal=False,
                        kv_len=lengths)
    return out[:, 0]


def _attend(logits: torch.Tensor, mask: torch.Tensor,
            v: torch.Tensor) -> torch.Tensor:
    """Softmax over the visible logits, then the weighted sum of v rows. A
    row with no visible key is 0: the kernels' rule (the TPU kernels write
    0 where the running sum l is 0), not the dense version's average."""
    if not logits.shape[-1]:  # no keys at all
        return logits.new_zeros(logits.shape[:-1] + v.shape[-1:])
    probs = softmax(logits.masked_fill(~mask, MASKED))
    probs = probs.masked_fill(~mask.any(-1, keepdim=True), 0.0)
    return torch.matmul(probs, v.to(torch.float32))


def flash_attention_bhsd(
    q: torch.Tensor,  # (BH, Sq, D)
    k: torch.Tensor,  # (BH / group, Sk, D)
    v: torch.Tensor,  # (BH / group, Sk, D)
    *,
    group: int,
    causal: bool = True,
    window: int = 0,
    scale: float | None = None,
) -> torch.Tensor:
    """The flash kernel's plain version in its own layout: program b reads
    kv head b // group; query and key positions both start at 0. Returns
    (BH, Sq, D) in q's dtype."""
    _require_float32_products(q, "flash_attention_bhsd")
    bh, sq, d = q.shape
    sk = k.shape[1]
    scale = d ** -0.5 if scale is None else scale
    kx = torch.repeat_interleave(k, group, dim=0).to(torch.float32)
    vx = torch.repeat_interleave(v, group, dim=0)
    logits = torch.matmul(q.to(torch.float32), kx.transpose(1, 2)) * scale
    mask = _visible(sq, sk, causal=causal, window=window, device=q.device)
    return _attend(logits, mask, vx).to(q.dtype)


def flash_attention_bshd(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, Hkv, D)
    v: torch.Tensor,  # (B, Sk, Hkv, D)
    *,
    causal: bool = True,
    window: int = 0,
    scale: float | None = None,
) -> torch.Tensor:
    """``flash_attention_bhsd`` in the model's layout: query head h of
    sequence b reads kv head h // (H // Hkv). Returns (B, Sq, H, D)."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    out = flash_attention_bhsd(
        q.transpose(1, 2).reshape(b * h, sq, d),
        k.transpose(1, 2).reshape(b * hkv, sk, d),
        v.transpose(1, 2).reshape(b * hkv, sk, d), group=h // hkv,
        causal=causal, window=window, scale=scale)
    return out.reshape(b, h, sq, d).transpose(1, 2)


def flash_bf16_limit(q, k, v, want, *, causal: bool = True, window: int = 0,
                     scale: float | None = None) -> torch.Tensor:
    """Per-element limits for the bf16 flash kernel's output against
    ``want``, this plain version's on the same bf16 (B, S, H, D) inputs: 2
    bf16 ulps of the output (2^-6 |want|; each side rounds its output
    once) plus 4 times the most that the kernel's rounding of P to bf16
    for P.V can move it (2^-9 P.|V|: the row sums add the unrounded P),
    with P.|V| from this plain version on |V| in float32. A kernel that
    drops or mis-scales a key tile leaves it."""
    pv = flash_attention_bshd(q.float(), k.float(), v.float().abs(),
                              causal=causal, window=window, scale=scale)
    return 2.0 ** -6 * want.float().abs() + 2.0 ** -7 * pv


def flash_attention_terms(q, k, v, out, dout, *, group: int,
                          causal: bool = True, window: int = 0,
                          scale: float | None = None):
    """(P, dS), the flash gradient's two (BH, Sq, Sk) float32 terms in the
    kernel's layout: P the softmax weights over the visible keys (0 for a
    masked key and for a row with no visible key), dS = P (dO V^T - D)
    with D = rowsum(dO * out), the gradient of the scaled logits. ``out``
    is the forward's result as it was returned (rounded to its dtype)."""
    _require_float32_products(q, "flash_attention_terms")
    sq, d = q.shape[1], q.shape[2]
    sk = k.shape[1]
    scale = d ** -0.5 if scale is None else scale
    kx = torch.repeat_interleave(k, group, dim=0).to(torch.float32)
    vx = torch.repeat_interleave(v, group, dim=0).to(torch.float32)
    logits = torch.matmul(q.to(torch.float32), kx.transpose(1, 2)) * scale
    mask = _visible(sq, sk, causal=causal, window=window, device=q.device)
    probs = softmax(logits.masked_fill(~mask, MASKED))
    probs = probs.masked_fill(~mask.any(-1, keepdim=True), 0.0)
    do = dout.to(torch.float32)
    dp = torch.matmul(do, vx.transpose(1, 2))
    delta = (do * out.to(torch.float32)).sum(-1, keepdim=True)
    return probs, probs * (dp - delta)


def flash_attention_bwd(q, k, v, out, dout, *, group: int,
                        causal: bool = True, window: int = 0,
                        scale: float | None = None):
    """The flash gradient kernel's plain version in its layout, by the
    explicit formulas (no autograd): (dQ, dK, dV) for q (BH, Sq, D), k, v
    (BH / group, Sk, D), the forward's ``out`` and its cotangent ``dout``
    (BH, Sq, D). dQ = scale dS K, dK = scale dS^T Q summed over each kv
    head's ``group`` query heads, dV = P^T dO likewise; float32 math, each
    result in its input's dtype. A row with no visible key adds nothing
    and gets dQ = 0."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    scale = d ** -0.5 if scale is None else scale
    probs, ds = flash_attention_terms(q, k, v, out, dout, group=group,
                                      causal=causal, window=window,
                                      scale=scale)
    kx = torch.repeat_interleave(k, group, dim=0).to(torch.float32)
    dq = torch.matmul(ds, kx) * scale
    dkx = torch.matmul(ds.transpose(1, 2), q.to(torch.float32)) * scale
    dvx = torch.matmul(probs.transpose(1, 2), dout.to(torch.float32))
    dk = dkx.reshape(bh // group, group, sk, d).sum(1)
    dv = dvx.reshape(bh // group, group, sk, d).sum(1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_bf16_limits(q, k, v, out, dout, want, *, group: int,
                          causal: bool = True, window: int = 0):
    """Per-element limits on how far the bf16 gradient kernel's (dQ, dK,
    dV) may lie from ``want``, this plain version's on the same bf16
    inputs in the (BH, S, D) layout: 2 bf16 ulps of each result (2^-6
    |want|: each side rounds it once), plus twice the most that rounding
    P or dS to bf16 (2^-8 relative) for its product can move it (2^-7
    P^T |dO| for dV, 2^-7 scale |dS| |K| for dQ, 2^-7 scale |dS|^T |Q|
    for dK), plus float32 rounding in dS = P (dP - D), where dP and D are
    sums whose terms cancel: 2^-16 P (|dO| |V|^T + rowsum |dO| |O|)
    carried through the dQ and dK products. The magnitudes come from this
    plain version in float32."""
    d = q.shape[-1]
    scale = d ** -0.5
    probs, ds = flash_attention_terms(q, k, v, out, dout, group=group,
                                      causal=causal, window=window)
    aq, ak, av, ao, ado = (t.to(torch.float32).abs()
                           for t in (q, k, v, out, dout))
    kx = torch.repeat_interleave(ak, group, dim=0)
    vx = torch.repeat_interleave(av, group, dim=0)
    noise = 2.0 ** -16 * probs * (torch.matmul(ado, vx.transpose(1, 2))
                                  + (ado * ao).sum(-1, keepdim=True))
    ds_term = 2.0 ** -7 * ds.abs() + noise
    bhk, sk = k.shape[0], k.shape[1]

    def per_kv_head(x):
        return x.reshape(bhk, group, sk, d).sum(1)

    terms = (scale * torch.matmul(ds_term, kx),
             scale * per_kv_head(torch.matmul(ds_term.transpose(1, 2), aq)),
             2.0 ** -7 * per_kv_head(torch.matmul(probs.transpose(1, 2), ado)))
    return [2.0 ** -6 * w.to(torch.float32).abs() + t
            for w, t in zip(want, terms)]


def flash_attention_bwd_bshd(q, k, v, out, dout, *, causal: bool = True,
                             window: int = 0, scale: float | None = None):
    """``flash_attention_bwd`` in the model's layout: q, out, dout (B, Sq,
    H, D), k, v (B, Sk, Hkv, D); returns (dQ, dK, dV) in those shapes."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]

    def bhsd(t):
        return t.transpose(1, 2).reshape(-1, t.shape[1], d)

    dq, dk, dv = flash_attention_bwd(
        bhsd(q), bhsd(k), bhsd(v), bhsd(out), bhsd(dout), group=h // hkv,
        causal=causal, window=window, scale=scale)
    return (dq.reshape(b, h, sq, d).transpose(1, 2),
            dk.reshape(b, hkv, sk, d).transpose(1, 2),
            dv.reshape(b, hkv, sk, d).transpose(1, 2))


def decode_attention_bkgd(
    q: torch.Tensor,        # (B * Hkv, G, D)
    k_cache: torch.Tensor,  # (B * Hkv, S, D)
    v_cache: torch.Tensor,  # (B * Hkv, S, D)
    lengths: torch.Tensor,  # (B,)
    *,
    num_kv_heads: int,
    scale: float | None = None,
) -> torch.Tensor:
    """The decode kernel's plain version in its own layout: program b sees
    the first lengths[b // num_kv_heads] cache entries (a length past S
    sees all of them; 0 writes 0). Returns (B * Hkv, G, D) in q's dtype."""
    _require_float32_products(q, "decode_attention_bkgd")
    bkv, g, d = q.shape
    s = k_cache.shape[1]
    scale = d ** -0.5 if scale is None else scale
    prog = torch.arange(bkv, device=q.device) // num_kv_heads
    length = lengths.to(device=q.device, dtype=torch.int64)[prog]
    logits = torch.matmul(q.to(torch.float32),
                          k_cache.to(torch.float32).transpose(1, 2)) * scale
    mask = (torch.arange(s, device=q.device)[None, :] < length[:, None])
    return _attend(logits, mask[:, None, :], v_cache).to(q.dtype)


def decode_attention_split(
    q: torch.Tensor,        # (B * Hkv, G, D)
    k_cache: torch.Tensor,  # (B * Hkv, S, D)
    v_cache: torch.Tensor,  # (B * Hkv, S, D)
    lengths: torch.Tensor,  # (B,)
    *,
    num_kv_heads: int,
    split: int,
    scale: float | None = None,
) -> torch.Tensor:
    """``decode_attention_bkgd`` as the split-cache kernel computes it: a
    partial (m, l, acc) over each ``split``-key stretch of the cache (m =
    -1e30, l = 0, acc = 0 where the stretch holds no live key), then the
    partials merged in split order: M = max m, L = sum l exp(m - M), o =
    sum acc exp(m - M) / L, and 0 where L = 0."""
    _require_float32_products(q, "decode_attention_split")
    bkv, g, d = q.shape
    s = k_cache.shape[1]
    scale = d ** -0.5 if scale is None else scale
    n = -(-s // split)
    pad = n * split - s
    k = torch.nn.functional.pad(k_cache.to(torch.float32), (0, 0, 0, pad))
    v = torch.nn.functional.pad(v_cache.to(torch.float32), (0, 0, 0, pad))
    prog = torch.arange(bkv, device=q.device) // num_kv_heads
    length = lengths.to(device=q.device, dtype=torch.int64)[prog].clamp(0, s)
    live = (torch.arange(n * split, device=q.device)[None, :]
            < length[:, None]).reshape(bkv, 1, n, split)
    logits = torch.matmul(q.to(torch.float32)[:, :, None, None, :],
                          k.reshape(bkv, 1, n, split, d).transpose(-1, -2))
    logits = (logits[..., 0, :] * scale).masked_fill(~live, MASKED)
    m = logits.amax(-1)                                # (bkv, G, n)
    p = torch.exp(logits - m[..., None]).masked_fill(~live, 0.0)
    l = p.sum(-1)
    acc = torch.matmul(p[..., None, :],
                       v.reshape(bkv, 1, n, split, d))[..., 0, :]
    big = m.amax(-1, keepdim=True)
    f = torch.exp(m - big)
    total = (l * f).sum(-1)                            # (bkv, G)
    out = (acc * f[..., None]).sum(-2)
    out = torch.where(total[..., None] == 0, torch.zeros_like(out),
                      out / torch.where(total == 0, 1.0, total)[..., None])
    return out.to(q.dtype)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 stored mantissa bits) to nearest, ties
    away from zero, as ``cvt.rna.tf32.f32`` does."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the flash kernel forms float32 products on the tensor cores:
    each operand split into hi = tf32(x) and lo = tf32(x - hi), and
    lo.hi' + hi.lo' + hi.hi' summed in float32 (the lo.lo' term, ~2^-22 of
    the product, is dropped)."""
    a_hi, b_hi = tf32_round(a), tf32_round(b)
    a_lo, b_lo = tf32_round(a - a_hi), tf32_round(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi
