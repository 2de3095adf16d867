"""Routing policies (§4.1, §4.3, §5.3).

EDDY policies rank the unvisited predicates for a batch; the routing shard
sends the batch to the first. All estimates come from run-time stats
(StatsBoard) — never a-priori. On a sharded board (N-shard eddy core),
``stats[name]`` yields a MERGED view folding every shard's write stripe,
so each shard ranks on global statistics while recording stays
uncontended; policies are stateless sorts (or keep only GIL-atomic
counters), so one policy instance is safely shared by all shards.

  * CostDriven       — Hydro's contribution: rank by measured cost/row.
                       Optimal when predicates run CONCURRENTLY (different
                       resources): the cheap predicate drains the pipeline
                       and the expensive one overlaps (paper Fig. 4:
                       14 vs 20 time units).
  * ScoreDriven      — classic cost/(1-selectivity) [Hellerstein '94].
  * SelectivityDriven— rank by selectivity only (ablation).
  * ReuseAware       — CostDriven with per-BATCH cache-hit discounting:
                       est = (1 - hit_rate(batch)) * cost  (§4.3).
  * HydroPolicy      — cost-driven when the batch's unvisited predicates
                       occupy pairwise-disjoint resources (concurrent),
                       else falls back to score-driven, per §4.1.

LAMINAR policies pick a worker for a batch:
  * RoundRobin        — paper default.
  * DataAware         — least outstanding PROXY load (input size), assigned
                        proactively at enqueue (§5.3).
  * DeviceAlternating — alternate device groups on consecutive batches
                        (the paper's GPU-aware routing, §5.1 scaling out).

ARBITER policies decide which predicate a contended device slot goes to
(§5.2 dynamic resource allocation; see core/resources.py):
  * PressureRanked    — default: highest measured cost x queue-depth wins;
                        deadline/priority-aware when claimants carry an
                        URGENCY weight (multi-tenant QueryService: each
                        query's priority x deadline proximity scales its
                        predicates' pressure in the comparison).
  * StaticPartition   — ablation: fixed per-predicate quota, no scale-down.
"""
from __future__ import annotations

import itertools
from typing import List, Optional

from repro_torch.core.batch import RoutingBatch
from repro_torch.core.cache import ReuseCache
from repro_torch.core.stats import StatsBoard
from repro_torch.core.udf import Predicate


# Rank-estimate resolution (Adaptive Cost Model line of work): run-time
# statistics are noisy estimators, so two predicates whose true statistics
# are EQUAL will report values that differ by estimator noise (the lottery
# selectivity estimator drifts by ~1/tickets per batch). Ranking on the raw
# floats makes the predicate order flip nondeterministically mid-run at
# degenerate (tied) statistics. Policies therefore quantize selectivity to
# this resolution inside their sort keys — well above the noise floor, well
# below any meaningful selectivity difference — and break the resulting
# ties deterministically (cost, then name). Point estimates returned by
# ``PredicateStats`` stay exact; only rank keys quantize.
SEL_RESOLUTION = 1.0 / 64.0


def _sel_key(sel: float, resolution: float = SEL_RESOLUTION) -> float:
    """Selectivity as a rank key: quantized so noise-level differences tie."""
    return round(sel / resolution) * resolution


def _fault_penalty(stats, name: str) -> float:
    """Failure-aware rank multiplier (core/faults.py): the error-rate EMA
    of a flaky predicate inflates its cost/score key so healthy siblings
    run first — a soft deferral; outright removal from routing is the
    quarantine skip in the eddy shard, not a policy concern.  Exactly 1.0
    (so ``key * 1.0 == key`` bit-exact) when no ledger is attached or the
    predicate has never failed; SelectivityDriven deliberately ignores it
    (pure-selectivity ablation)."""
    ledger = getattr(stats, "faults", None)
    return 1.0 if ledger is None else ledger.rank_penalty(name)


class EddyPolicy:
    name = "base"

    def rank(self, batch: RoutingBatch, preds: List[Predicate],
             stats: StatsBoard, cache: Optional[ReuseCache]) -> List[Predicate]:
        raise NotImplementedError


class CostDriven(EddyPolicy):
    name = "cost"

    def est_cost(self, batch, p, stats, cache) -> float:
        return stats[p.name].cost()

    def rank(self, batch, preds, stats, cache):
        # deterministic tie-break: equal-cost predicates order by
        # (quantized) selectivity — drop more rows first — then by name.
        return sorted(preds, key=lambda p: (
            self.est_cost(batch, p, stats, cache) * _fault_penalty(stats, p.name),
            _sel_key(stats[p.name].selectivity()),
            p.name,
        ))


class ReuseAware(CostDriven):
    name = "reuse-aware"

    def est_cost(self, batch, p, stats, cache) -> float:
        cost = stats[p.name].cost()
        if cache is None or not p.cacheable:
            return cost
        # pass the UDF's input columns so a LAYERED cache can fold
        # content-hash hits (same payload under fresh row ids) into the
        # paper's (1 - hit_rate) x cost estimate; id-keyed caches ignore it
        data = {c: batch.data[c] for c in p.udf.columns if c in batch.data}
        hit = cache.hit_rate(p.udf.name, batch.row_ids, data=data or None)
        return (1.0 - hit) * cost


class ScoreDriven(EddyPolicy):
    name = "score"

    def rank(self, batch, preds, stats, cache):
        return sorted(preds, key=lambda p: (
            stats[p.name].score(resolution=SEL_RESOLUTION)
            * _fault_penalty(stats, p.name),
            stats[p.name].cost(),
            p.name,
        ))


class SelectivityDriven(EddyPolicy):
    name = "selectivity"

    def rank(self, batch, preds, stats, cache):
        # quantized selectivity first; at a tie the cheaper predicate runs
        # first (the only well-defined order at degenerate statistics).
        return sorted(preds, key=lambda p: (
            _sel_key(stats[p.name].selectivity()),
            stats[p.name].cost(),
            p.name,
        ))


class ContentBased(EddyPolicy):
    """Content-based routing [Bizarro et al. 2005, the paper's §2.2].

    Per-batch predicate ordering from CONTENT-bucket-specific selectivities
    (lottery counters keyed by ``bucket_fn(batch)``). The original
    tuple-granularity overhead objection dissolves at Hydro's routing-batch
    granularity: one bucket lookup per ~10-row batch. Falls back to global
    estimates until a bucket accumulates enough tickets."""

    name = "content"

    def __init__(self, bucket_fn):
        self.bucket_fn = bucket_fn

    def rank(self, batch, preds, stats, cache):
        if stats.bucket_fn is None:
            # wire the eval-side recording; benign if shards race here
            # (every shard writes the same function)
            stats.bucket_fn = self.bucket_fn
        b = stats.bucket_of(batch)
        return sorted(preds, key=lambda p: (
            stats[p.name].score(bucket=b, resolution=SEL_RESOLUTION)
            * _fault_penalty(stats, p.name),
            stats[p.name].cost(),
            p.name,
        ))


class HydroPolicy(EddyPolicy):
    """Cost-driven under concurrency, score-driven otherwise (§4.1)."""

    name = "hydro"

    def __init__(self):
        self._cost = CostDriven()
        self._score = ScoreDriven()

    def rank(self, batch, preds, stats, cache):
        resources = [p.resource for p in preds]
        concurrent = len(set(resources)) == len(resources)
        inner = self._cost if concurrent else self._score
        return inner.rank(batch, preds, stats, cache)


# --------------------------------------------------------------------------- #
# Laminar policies                                                             #
# --------------------------------------------------------------------------- #
class LaminarPolicy:
    name = "base"

    def choose(self, workers, batch: RoutingBatch, stats: StatsBoard):
        raise NotImplementedError


class RoundRobin(LaminarPolicy):
    name = "round-robin"

    def __init__(self):
        self._counter = itertools.count()

    def choose(self, workers, batch, stats):
        return workers[next(self._counter) % len(workers)]


class DataAware(LaminarPolicy):
    """Least outstanding proxy load; load added proactively at enqueue.

    Under the simulated clock the authoritative outstanding-work signal is
    the worker's VIRTUAL busy horizon (completed-but-virtually-queued work
    drains at sim time, not wall time); the proactive proxy load breaks
    ties for batches submitted but not yet evaluated."""

    name = "data-aware"

    def choose(self, workers, batch, stats):
        from repro_torch.core.simclock import SimClock

        clock = getattr(workers[0], "clock", None)
        if isinstance(clock, SimClock):
            # expected completion: virtual horizon (evaluated-queued work)
            # + pending proxy load converted to seconds by the measured rate
            rate = stats.proxy_rate.get(0.0)

            def eta(w):
                start = max(clock.resource_busy_until(w.wid), batch.sim_ready)
                return start + stats.load_of(w.wid) * rate

            return min(workers, key=eta)
        return min(workers, key=lambda w: stats.load_of(w.wid))


class DeviceAlternating(LaminarPolicy):
    """Alternate across device groups for consecutive batches (§5.1)."""

    name = "device-alternating"

    def __init__(self):
        self._counter = itertools.count()
        self._inner: dict = {}

    def choose(self, workers, batch, stats):
        devices = sorted({w.device_group for w in workers})
        dev = devices[next(self._counter) % len(devices)]
        group = [w for w in workers if w.device_group == dev]
        inner = self._inner.setdefault(dev, itertools.count())
        return group[next(inner) % len(group)]


class StickyDevice(LaminarPolicy):
    """Route RUNS of consecutive batches to the same device group — the
    paper's non-GPU-aware baseline (continuous data sequences land on one
    accelerator), used as the UC3 'w/o alternating' ablation."""

    name = "sticky-device"

    def __init__(self, run_length: int = 16):
        self.run_length = run_length
        self._n = 0
        self._inner: dict = {}

    def choose(self, workers, batch, stats):
        devices = sorted({w.device_group for w in workers})
        dev = devices[(self._n // self.run_length) % len(devices)]
        self._n += 1
        group = [w for w in workers if w.device_group == dev]
        inner = self._inner.setdefault(dev, itertools.count())
        return group[next(inner) % len(group)]


# --------------------------------------------------------------------------- #
# Arbiter policies (§5.2 dynamic resource allocation)                          #
# --------------------------------------------------------------------------- #
def urgency_weight(priority: float = 1.0, deadline: Optional[float] = None,
                   now: float = 0.0) -> float:
    """Deadline/priority urgency multiplier for arbitration pressure.

    ``priority`` scales linearly (a priority-2 query's predicates weigh
    twice a priority-1 rival's at equal measured pressure). A ``deadline``
    (absolute, same clock as ``now``) adds proximity urgency that grows as
    the deadline nears: with ``t = deadline - now`` seconds remaining the
    weight is ``priority * (1 + 1 / max(t, 0.1))`` — an already-missed or
    imminent deadline saturates at ``priority * 11`` rather than diverging,
    so one late query cannot starve the fleet forever."""
    w = max(0.0, float(priority))
    if deadline is not None:
        w *= 1.0 + 1.0 / max(float(deadline) - float(now), 0.1)
    return w


class ArbiterPolicy:
    """Arbitrates device-slot leases between predicate claimants.

    ``grant`` is consulted by ``ResourceArbiter.lease`` for every non-floor
    request (a claimant's FIRST lease always bypasses arbitration — the
    no-starvation floor). ``scale_down`` gates the drain-threshold retire
    path: a policy that forbids it reproduces pools that only grow."""

    name = "base"
    scale_down = True

    def grant(self, requester: str, *, pressures, wants, held,
              urgency=None) -> bool:
        """May ``requester`` take a free slot right now?

        pressures: claimant -> measured cost x queue-depth pressure
        wants:     claimant -> was recently denied (a live, standing claim)
        held:      claimant -> leases currently held
        urgency:   claimant -> deadline/priority weight (``urgency_weight``)
                   or None — absent claimants weigh 1.0, so a single-query
                   executor arbitrates exactly as before the QueryService
        """
        raise NotImplementedError


class PressureRanked(ArbiterPolicy):
    """Default: the slot goes to the highest-pressure standing claimant.

    Pressure is profiled cost/row x queue depth from the StatsBoard (§3.3:
    collected DURING execution — the GRACEFUL argument for profiled over
    estimated UDF cost). A requester outranked by a rival with a standing
    denied claim steps aside; rivals whose pressure has since drained to or
    below the requester's no longer block (stale wants are harmless because
    pressures are always read live).

    Deadline/priority awareness (multi-tenant QueryService): each
    claimant's pressure is scaled by its query's urgency weight before the
    comparison, so a higher-priority or deadline-pressed query wins
    contended slots at equal measured pressure. With no urgency map (the
    single-query executor) every weight is 1.0 — bit-identical to the
    pre-service arbitration."""

    name = "pressure"

    def grant(self, requester, *, pressures, wants, held, urgency=None):
        rivals = [n for n, w in wants.items() if w and n != requester]
        if not rivals:
            return True
        u = urgency or {}
        mine = pressures.get(requester, 0.0) * u.get(requester, 1.0)
        return all(
            pressures.get(n, 0.0) * u.get(n, 1.0) <= mine for n in rivals
        )


class StaticPartition(ArbiterPolicy):
    """Ablation: the pre-arbiter behavior — a fixed per-predicate quota,
    no scale-down, no cross-predicate reallocation. ``quota=None`` means
    each predicate is limited only by its own ``max_workers`` ceiling
    (exactly the old private pools)."""

    name = "static"
    scale_down = False

    def __init__(self, quota: Optional[int] = None):
        self.quota = quota

    def grant(self, requester, *, pressures, wants, held, urgency=None):
        if self.quota is None:
            return True
        return held.get(requester, 0) < self.quota


EDDY_POLICIES = {
    p.name: p for p in (CostDriven, ScoreDriven, SelectivityDriven, ReuseAware, HydroPolicy)
}
EDDY_POLICIES_EXT = dict(EDDY_POLICIES, content=ContentBased)
LAMINAR_POLICIES = {
    p.name: p for p in (RoundRobin, DataAware, DeviceAlternating, StickyDevice)
}
ARBITER_POLICIES = {p.name: p for p in (PressureRanked, StaticPartition)}
