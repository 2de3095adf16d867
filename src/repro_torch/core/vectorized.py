"""On-device short-circuit filtering: an AND of predicates with each
expensive one evaluated on compacted buckets of the rows that survived
the cheaper ones.

Port of ``repro.core.vectorized``. Host-side eddy routing costs ~100 us a
decision, fine for video batches that wrap 30 ms UDFs but not inside a
serving step that evaluates thousands of rows. Here the same
short-circuit semantics run as tensor code on the rows' device:

  evaluate the cheapest predicate on the whole batch
  -> compact the survivors into a bucket of a fixed size (sort by mask)
  -> evaluate the next predicate on the compacted bucket only
  -> scatter the verdicts back.

Buckets have one shape whatever the selectivity, so a kernel behind the
expensive predicate sees one shape; a bucket that is not full is padded
with row n, a zero sentinel row whose verdict lands on a discarded slot.
The reference loops with ``jax.lax.while_loop`` inside one jitted
program; PyTorch runs eagerly, so the loop is a host loop on whether any
survivor is still uncovered (one device-to-host read a pass).
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch


def compact_indices(mask: torch.Tensor, bucket: int) -> torch.Tensor:
    """Indices of True entries, padded with n (an out-of-range sentinel)
    to ``bucket``."""
    n = mask.shape[0]
    idx = torch.where(mask, torch.arange(n, device=mask.device), n)
    return torch.sort(idx).values[:bucket]


def two_stage_filter(
    cheap_fn: Callable[[torch.Tensor], torch.Tensor],
    expensive_fn: Callable[[torch.Tensor], torch.Tensor],
    x: torch.Tensor,
    *,
    bucket_fraction: float = 0.5,
) -> torch.Tensor:
    """AND of two predicates with the expensive one on compacted buckets.

    x: (N, ...) rows -> (N,) bool, exact for any selectivity: the loop
    keeps evaluating bucket-sized compactions of the survivors not yet
    covered until none remain, ceil(survivors / bucket) passes, each of
    ``expensive_fn`` on ``bucket`` rows."""
    n = x.shape[0]
    bucket = max(1, int(n * bucket_fraction))
    cheap = cheap_fn(x).to(torch.bool)                       # (N,)
    no = torch.zeros((1,), dtype=torch.bool, device=x.device)
    cheapp = torch.cat([cheap, no])                          # sentinel False
    xpad = torch.cat([x, torch.zeros_like(x[:1])], dim=0)
    out = torch.zeros((n + 1,), dtype=torch.bool, device=x.device)
    covered = torch.zeros((n + 1,), dtype=torch.bool, device=x.device)
    covered[n] = True
    while bool((cheapp & ~covered).any()):
        rest = (cheapp & ~covered)[:n]
        idx = compact_indices(rest, bucket)      # (bucket,) with sentinel n
        out[idx] = expensive_fn(xpad[idx]).to(torch.bool)  # n: discarded
        covered[idx] = True
    return cheap & out[:n]


def cascade_filter(
    fns_cheap_to_expensive: Sequence[Callable[[torch.Tensor], torch.Tensor]],
    x: torch.Tensor,
    *,
    bucket_fractions: Sequence[float] | None = None,
) -> torch.Tensor:
    """N-stage cascade: each stage sees only the survivors of the ones
    before it. Exact at any selectivity. Order the stages cheap to
    expensive: at serve time the caller orders them by the StatsBoard's
    costs, the tensor twin of cost-driven routing."""
    fns = list(fns_cheap_to_expensive)
    if bucket_fractions is None:
        bucket_fractions = [0.5] * (len(fns) - 1)
    mask = fns[0](x).to(torch.bool)
    for fn, frac in zip(fns[1:], bucket_fractions):
        mask = mask & two_stage_filter(lambda _: mask, fn, x,
                                       bucket_fraction=frac)
    return mask
