"""Roofline-derived a-priori cost models for kernel-backed predicates.

Hydro's position (§3.3) is that UDF statistics are PROFILED at run time,
never estimated — so these analytic models are deliberately second-class:
they seed the cold-start cost prior (what a policy sees before the first
launch lands) and drive the deterministic SimClock benchmarks. Once the
executor's launch hook records real per-launch timings, the EMA overrides
everything here.

Each model is the classic roofline lower bound over the H100 constants
in ``repro_torch.roofline.hw``:

    seconds(rows) = overhead + max(flops(rows) / peak_FLOP/s,
                                   bytes(rows) / HBM_bw)

FLOP/byte counts are per *predicate row* (one crop, one token sequence, one
routed token) and derived from the kernel's algorithmic shape, not from a
compiled artifact — exact HLO accounting lives in ``repro.roofline`` and
needs a lowered executable, which a cold predicate does not have yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from repro_torch.roofline import hw

# Per-launch dispatch/DMA-setup floor: keeps tiny-batch estimates from
# rounding to zero seconds, which would make a cold kernel look free.
LAUNCH_OVERHEAD_S = 5e-5

F32 = 4  # bytes


@dataclass(frozen=True)
class Roofline:
    """Analytic per-row roofline: flops/bytes scale linearly with rows."""

    flops_per_row: float
    bytes_per_row: float
    overhead_s: float = LAUNCH_OVERHEAD_S

    def seconds(self, rows: int) -> float:
        return self.overhead_s + max(
            rows * self.flops_per_row / hw.PEAK_FLOPS_BF16,
            rows * self.bytes_per_row / hw.HBM_BW,
        )

    @property
    def cost_model(self) -> Callable[[int], float]:
        """The ``UDF.cost_model`` callable (simulated seconds for N rows)."""
        return self.seconds


# --------------------------------------------------------------------------- #
# per-kernel derivations (row = one predicate input row)                      #
# --------------------------------------------------------------------------- #
def hsv_color(height: int, width: int, n_colors: int = 9) -> Roofline:
    """Row = one crop: RGB->HSV (~30 flop/px) + C range checks (8 flop each)."""
    px = height * width
    return Roofline(
        flops_per_row=px * (30 + 8 * n_colors),
        bytes_per_row=px * 3 * F32 + (n_colors + 1) * F32,
    )


def moe_router(n_experts: int, k: int = 2) -> Roofline:
    """Row = one token: softmax over E + k argmax/mask passes + renorm."""
    return Roofline(
        flops_per_row=n_experts * (10 + 4 * k),
        bytes_per_row=n_experts * F32 + 2 * k * F32,
    )


def flash_attention(seq: int, heads: int, head_dim: int,
                    causal: bool = True) -> Roofline:
    """Row = one sequence: 4*S^2*H*D matmul flops (halved when causal)."""
    flops = 4.0 * seq * seq * heads * head_dim
    if causal:
        flops /= 2
    return Roofline(
        flops_per_row=flops,
        bytes_per_row=4 * seq * heads * head_dim * F32,  # q,k,v in + out
    )


def decode_attention(seq: int, heads: int, head_dim: int,
                     kv_heads: int = 1) -> Roofline:
    """Row = one query over an S-long KV cache: 4*S*H*D flops, cache-bound."""
    return Roofline(
        flops_per_row=4.0 * seq * heads * head_dim,
        bytes_per_row=(2 * seq * kv_heads + 2 * heads) * head_dim * F32,
    )


def ssd(seq: int, heads: int, head_dim: int, state: int) -> Roofline:
    """Row = one sequence: intra-chunk duals + state updates, ~6*S*H*P*N."""
    return Roofline(
        flops_per_row=6.0 * seq * heads * head_dim * state,
        bytes_per_row=seq * heads * (head_dim + 2 * state + 1) * F32,
    )


def rglru(seq: int, width: int) -> Roofline:
    """Row = one sequence: gate activations + scan, ~12 flop per (t, w)."""
    return Roofline(
        flops_per_row=12.0 * seq * width,
        bytes_per_row=4 * seq * width * F32,  # x, r, i in + h out
    )
