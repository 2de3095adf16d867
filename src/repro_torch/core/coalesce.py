"""Adaptive micro-batch coalescing (§5.1 utilization, GRACEFUL cost shape).

Hydro's bottleneck argument is UDF evaluation throughput: accelerator
utilization per invocation is what the executor must maximize.  A stream of
tiny routing batches defeats that — every batch pays the per-launch
dispatch/trace/probe overhead and pads up to its own power-of-two bucket.
GRACEFUL-style learned UDF cost models show per-invocation cost decomposes
into a FIXED launch term plus a MARGINAL per-row term; this module turns
that decomposition into a fusing decision:

    cost(rows) ~= fixed + marginal * rows
    per-row launch share at r rows = fixed / r
    amortized once fixed / r <= amortize_eps * marginal
    =>  target_rows = fixed / (amortize_eps * marginal)

A worker that dequeues a batch asks its predicate's ``CoalescePlanner``
for a ``FusePlan``; when the plan's ``target_rows`` exceeds the batch it
drains more queued batches (non-blocking first, then waiting up to the
latency budget) and evaluates the fused batch through the normal
cache-probe -> bucketed-launch -> mask pipeline ONCE (see
``core/worker.evaluate_fused``).

Evidence, in priority order:

1. the ONLINE decomposition fitted from observed per-launch timings
   (``PredicateStats.launch_decomposition`` — refined as fused launches
   create row-count spread);
2. a SEED probed from the predicate's a-priori cost model (the
   ``udfs/rooflines.py`` priors expose exactly ``overhead + per-row``:
   ``cost_model(0)`` is the fixed term, ``cost_model(1) - cost_model(0)``
   the marginal term).

WHEN ADAPTIVE MODE DECLINES TO FUSE: with neither evidence source
available (no cost model, no fitted decomposition yet) the planner
passes batches through untouched — coalescing must never speculate on a
predicate it knows nothing about.  It also declines when the computed
target does not exceed the rows already in hand: an expensive predicate
whose per-row work dwarfs its launch overhead is already saturated, and
fusing it would only add queueing latency.  ``fixed == 0`` (no overhead
to amortize) declines too.

Fixed-k mode skips the model entirely and fuses up to ``k`` batches per
launch (row-capped) — the ablation baseline for the adaptive policy.
"""
from __future__ import annotations

import math
import threading
from dataclasses import dataclass
from typing import Optional

# Fuse until the per-row launch share drops to this fraction of the
# marginal per-row cost (0.25 => launch overhead <= 20% of total time).
AMORTIZE_EPS = 0.25

# Defaults for the executor's ``coalesce=`` knob.
DEFAULT_MAX_BATCHES = 8      # max original batches fused into one launch
DEFAULT_MAX_ROWS = 1024      # hard row cap on a fused batch
DEFAULT_MAX_WAIT_S = 0.002   # latency budget waiting for more batches

# A worker queue this deep keeps enough batches in hand to fuse; the
# executor raises the default worker queue capacity to this when
# coalescing is enabled (explicit ``worker_queue_capacity`` wins).
COALESCE_QUEUE_CAPACITY = 8


@dataclass(frozen=True)
class CoalesceConfig:
    """Resolved form of the executor's ``coalesce=`` knob.

    mode: "adaptive" (learned target), "fixed" (always fuse up to ``k``),
    or "off".  ``max_wait_s`` bounds how long a worker holding fewer than
    ``target_rows`` waits for more batches — the latency cost of fusing is
    explicit and capped.  Under SimClock the wait is forced to zero
    (wall-clock waits are meaningless in virtual time): only batches
    already queued fuse."""

    mode: str = "adaptive"
    k: int = DEFAULT_MAX_BATCHES
    max_rows: int = DEFAULT_MAX_ROWS
    max_wait_s: float = DEFAULT_MAX_WAIT_S
    amortize_eps: float = AMORTIZE_EPS

    def __post_init__(self):
        if self.mode not in ("off", "fixed", "adaptive"):
            raise ValueError(f"coalesce mode must be off|fixed|adaptive, "
                             f"got {self.mode!r}")
        if self.k < 2 and self.mode != "off":
            raise ValueError(f"coalesce k must be >= 2, got {self.k}")

    @classmethod
    def resolve(cls, spec) -> Optional["CoalesceConfig"]:
        """Normalize the executor knob: None/"off"/0/False -> None (no
        coalescing); "adaptive" -> adaptive defaults; "fixed" -> fixed-k
        defaults; an int k -> fixed-k; a CoalesceConfig passes through."""
        if spec is None or spec is False or spec == "off" or spec == 0:
            return None
        if isinstance(spec, cls):
            return None if spec.mode == "off" else spec
        if spec == "adaptive" or spec is True:
            return cls(mode="adaptive")
        if spec == "fixed":
            return cls(mode="fixed")
        if isinstance(spec, int):
            return cls(mode="fixed", k=spec)
        raise ValueError(
            f"coalesce must be None, 'off', 'fixed', 'adaptive', an int k, "
            f"or a CoalesceConfig; got {spec!r}"
        )


@dataclass(frozen=True)
class FusePlan:
    """One dequeue's fusing budget: drain until ``target_rows`` rows or
    ``max_batches`` batches are in hand, waiting at most ``max_wait_s``."""

    target_rows: int
    max_batches: int
    max_wait_s: float


class CoalescePlanner:
    """Per-predicate fusing decisions; shared by that predicate's workers.

    Thread-safe: the only mutable state is the observability counters
    (guarded by a small lock); the estimate reads fold the stats entry's
    own synchronization."""

    def __init__(self, pred, stats_entry, config: CoalesceConfig, *,
                 wall_clock: bool = True):
        self.pred = pred
        self.stats_entry = stats_entry
        self.config = config
        # SimClock: wall-clock waiting is meaningless in virtual time —
        # fuse only what is already queued (deterministic paths stay
        # coalescing-free by default anyway; this governs explicit opt-in)
        self.max_wait_s = config.max_wait_s if wall_clock else 0.0
        self._seed = self._seed_from_cost_model(pred.udf.cost_model)
        self._lock = threading.Lock()
        self.plans = 0      # dequeues that got a fuse plan
        self.declines = 0   # dequeues passed through untouched
        self.fused = 0      # launches that actually fused >= 2 batches

    # ------------------------- evidence ------------------------- #
    @staticmethod
    def _seed_from_cost_model(cost_model):
        """(fixed, marginal) probed from an a-priori cost model, or None.

        ``cost_model(0)`` is the launch-overhead intercept and
        ``cost_model(1) - cost_model(0)`` the per-row slope — exact for
        the affine ``udfs/rooflines.py`` priors, a tangent-at-one-row
        approximation otherwise.  Data-aware models (which require the
        batch payload) and models that reject ``rows=0`` yield no seed."""
        if cost_model is None:
            return None
        try:
            f0 = float(cost_model(0))
            f1 = float(cost_model(1))
        except Exception:
            return None
        if not (math.isfinite(f0) and math.isfinite(f1)):
            return None
        return max(f0, 0.0), max(f1 - f0, 0.0)

    def estimate(self):
        """Best available (fixed, marginal): online fit, else seed."""
        fitted = self.stats_entry.launch_decomposition()
        return fitted if fitted is not None else self._seed

    # ------------------------- decisions ------------------------- #
    def target_rows(self) -> Optional[int]:
        """Adaptive fuse target in rows, or None to decline (see module
        docstring for the decline conditions)."""
        cfg = self.config
        est = self.estimate()
        if est is None:
            return None
        fixed, marginal = est
        if fixed <= 0.0:
            return None  # no launch overhead to amortize
        if marginal <= 0.0:
            # pure fixed-cost launch: every fused row is free — cap-bound
            return cfg.max_rows
        return int(min(cfg.max_rows, fixed / (cfg.amortize_eps * marginal)))

    def plan(self, first_rows: int) -> Optional[FusePlan]:
        """Fusing budget for a dequeue holding ``first_rows`` rows, or
        None to pass the batch through uncoalesced."""
        cfg = self.config
        if cfg.mode == "fixed":
            with self._lock:
                self.plans += 1
            return FusePlan(cfg.max_rows, cfg.k, self.max_wait_s)
        target = self.target_rows()
        if target is None or target <= first_rows:
            with self._lock:
                self.declines += 1
            return None
        with self._lock:
            self.plans += 1
        return FusePlan(target, cfg.k, self.max_wait_s)

    def note_fused(self, n_batches: int) -> None:
        if n_batches > 1:
            with self._lock:
                self.fused += 1

    def counters(self):
        with self._lock:
            return {"plans": self.plans, "declines": self.declines,
                    "fused": self.fused}
