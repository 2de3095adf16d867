"""The plain reference's shared parts: float32 products, the fp8 control's
rounding, RMSNorm, and the token-pool score.

Plain PyTorch, float32, TF32 off (``float32_products``). Imports nothing
of the program. A family's forward (``families/<family>.py``) calls
``linear`` for every weight product, so the same code computes the
reference (``quant=None``) and its control (``quant="fp8"``: each
product's operands rounded to float8 e4m3 with a scale a row of the
activations and a scale for the weight, the products then taken in
float32 -- fp8 being the precision below the bf16 the configurations
state).

The score is the LLM(...) predicate's, written out from its definition:
a row's float32 log-softmax summed over its live positions (token id >
0), averaged over the food words less the average over the service
words. The log-sum-exp of a position is common to every word and cancels
in that difference, but it is kept, as the predicate computes it.
"""
from __future__ import annotations

import torch

FOOD_WORDS = list(range(10, 60))
SERVICE_WORDS = list(range(60, 110))
FP8_MAX = 448.0   # largest finite float8 e4m3fn


def float32_products() -> None:
    """Matrix products in float32 on the card, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8_round(x: torch.Tensor, dim) -> torch.Tensor:
    """``x`` (float32) rounded to float8 e4m3 with one scale for each slice
    along ``dim`` (None: one scale for the tensor), and scaled back."""
    amax = (x.abs().amax() if dim is None
            else x.abs().amax(dim=dim, keepdim=True))
    scale = torch.clamp(amax, min=1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def linear(x: torch.Tensor, w: torch.Tensor, quant=None) -> torch.Tensor:
    """``x @ w`` in float32 (w (K, N) or (K, ...) flattened to (K, N)), or
    the fp8 control's product."""
    w2 = w.reshape(w.shape[0], -1).to(torch.float32)
    if quant == "fp8":
        x = fp8_round(x, -1)
        w2 = fp8_round(w2, None)
    elif quant is not None:
        raise ValueError(f"unknown control precision {quant!r}")
    return (x @ w2).reshape(*x.shape[:-1], *w.shape[1:])


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with the scale stored as an offset from one (a weight of
    zero is the identity scale), as the configurations' weights are
    stored."""
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * (1.0 + w.to(torch.float32))


def pool_score(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """(R, n, V) float32 logits of rows (R, n) -> (R,) float64 scores."""
    logp = torch.log_softmax(logits, dim=-1)
    live = (tokens > 0).to(logp.dtype)[..., None]
    pooled = (logp * live).sum(1, dtype=torch.float64)
    dev = logits.device
    food = torch.as_tensor(FOOD_WORDS, device=dev)
    service = torch.as_tensor(SERVICE_WORDS, device=dev)
    return pooled[:, food].mean(-1) - pooled[:, service].mean(-1)


def scores(family, cfg: dict, weights: dict, rows: list, quant=None,
           block_tokens: int = 8192) -> list:
    """Reference scores of ``rows`` (each a 1-d int tensor of its live
    tokens, ids > 0) in float64 by ``family.forward``: rows sorted by
    length and run in blocks of at most ``block_tokens`` positions, each
    block padded with id 0 to its longest row rounded up to
    ``family.pad_to`` (padding comes after every live token and the models
    are causal, so it moves no live logit)."""
    def padded(i):
        return -(-len(rows[i]) // family.pad_to) * family.pad_to

    order = sorted(range(len(rows)), key=lambda i: len(rows[i]))
    out = [0.0] * len(rows)
    dev = weights["embed"].device
    start = 0
    while start < len(order):
        stop = start + 1
        while (stop < len(order)
               and (stop + 1 - start) * padded(order[stop]) <= block_tokens):
            stop += 1
        block = order[start:stop]
        toks = torch.zeros((len(block), padded(block[-1])), dtype=torch.int64,
                           device=dev)
        for k, idx in enumerate(block):
            toks[k, :len(rows[idx])] = rows[idx].to(dev)
        with torch.no_grad():
            logits = family.forward(cfg, weights, toks, quant)
            s = pool_score(logits, toks).cpu().tolist()
        del logits
        for k, idx in enumerate(block):
            out[idx] = s[k]
        start = stop
    return out
