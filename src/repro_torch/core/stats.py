"""Runtime UDF statistics (§3.3) — collected DURING execution, never a-priori.

Per predicate: EMA cost per row, lottery-based selectivity (tickets =
rows routed, wins = rows dropped — the Eddy paper's estimator), cache hit
rate, queue length, and per-worker outstanding-work accounting for the
data-aware Laminar policy.

LOCK-SHARDED (``shards > 1``): each predicate's entry becomes a
``ShardedPredicateStats`` — one ``PredicateStats`` stripe per routing
shard. Writers (worker threads recording eval timings, kernel launch
hooks) record into a THREAD-AFFINE stripe, so concurrent recorders on
different threads never contend on one lock; readers (the shards' routing
policies) fold the stripes into a merged estimate (tickets/wins summed,
cost = batch-weighted mean of the stripe EMAs). ``shards=1`` (the default,
and always the case under SimClock) keeps the original single-entry
behavior bit-for-bit.

LAUNCH-COST DECOMPOSITION (micro-batch coalescing, GRACEFUL-style): each
entry additionally keeps EMA moments of per-LAUNCH ``(computed_rows,
seconds)`` samples and fits ``seconds ~= fixed + marginal * rows`` online
(one-variable least squares over the EMA moments).  ``launch_overhead()``
exposes the fitted fixed term and ``marginal_cost()`` the per-row slope —
the evidence the adaptive CoalescePlanner (core/coalesce.py) uses to pick
the row count where launch amortization flattens.  Samples are recorded
against COMPUTED rows (cache hits excluded): the decomposition models the
kernel launch, not the probe.  ``record_fused_eval`` records one fused
launch while crediting tickets/wins per original segment, so the lottery
selectivity estimator sees exactly the per-batch history the uncoalesced
path would have produced.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

# Launch-decomposition fit gates: at least this many per-launch samples,
# with row-count variance above the (relative) floor — a single repeated
# batch size cannot identify a slope, so the fit stays None until fused
# or heterogeneous launches provide spread.
LAUNCH_FIT_MIN_SAMPLES = 4
LAUNCH_FIT_MIN_REL_VAR = 1e-6


@dataclass
class Ema:
    alpha: float = 0.2
    value: Optional[float] = None

    def update(self, x: float) -> float:
        self.value = x if self.value is None else (
            self.alpha * x + (1 - self.alpha) * self.value
        )
        return self.value

    def get(self, default: float = 0.0) -> float:
        return default if self.value is None else self.value


@dataclass
class PredicateStats:
    name: str
    cost_per_row: Ema = field(default_factory=lambda: Ema(0.3))
    tickets: int = 0          # rows routed (lottery tickets)
    wins: int = 0             # rows filtered out (lottery wins)
    cache_hits: int = 0
    cache_probes: int = 0
    batches: int = 0
    queue_len: int = 0
    busy_until: float = 0.0   # simulated-clock resource horizon
    # content-based routing [Bizarro et al., cited by the paper §2.2]:
    # per-content-bucket lottery counters
    bucket_tickets: Dict[int, int] = field(default_factory=dict)
    bucket_wins: Dict[int, int] = field(default_factory=dict)

    # coalescing observability: launches counts kernel-launch-level samples
    # (a fused launch counts ONCE); fused_* count only launches that fused
    # >= 2 batches and the original batches they covered
    launches: int = 0
    fused_launches: int = 0
    fused_batches: int = 0
    coalesced_rows: int = 0

    # launch-cost decomposition moments: EMAs of rows, seconds, rows^2 and
    # rows*seconds over per-launch samples (see module docstring)
    lc_rows: Ema = field(default_factory=lambda: Ema(0.2))
    lc_secs: Ema = field(default_factory=lambda: Ema(0.2))
    lc_rows2: Ema = field(default_factory=lambda: Ema(0.2))
    lc_rowsecs: Ema = field(default_factory=lambda: Ema(0.2))

    _lock: threading.Lock = field(default_factory=threading.Lock)

    # ------------------------- recording ------------------------- #
    def _note_launch_locked(self, computed_rows: int, seconds: float) -> None:
        """One per-launch decomposition sample (caller holds the lock).

        ``computed_rows == 0`` means no kernel ran (full cache hit): there
        is no launch to decompose, so the sample is skipped."""
        if computed_rows <= 0:
            return
        self.launches += 1
        r = float(computed_rows)
        self.lc_rows.update(r)
        self.lc_secs.update(seconds)
        self.lc_rows2.update(r * r)
        self.lc_rowsecs.update(r * seconds)

    def record_eval(self, rows_in: int, rows_out: int, seconds: float,
                    bucket: Optional[int] = None,
                    computed_rows: Optional[int] = None) -> None:
        """One uncoalesced evaluation. ``computed_rows`` (defaulting to
        ``rows_in``) is the number of rows the launch actually computed —
        cache hits excluded — and feeds the launch-cost decomposition."""
        with self._lock:
            self.batches += 1
            self.tickets += rows_in
            self.wins += rows_in - rows_out
            if rows_in > 0:
                self.cost_per_row.update(seconds / rows_in)
            self._note_launch_locked(
                rows_in if computed_rows is None else computed_rows, seconds
            )
            if bucket is not None:
                self.bucket_tickets[bucket] = (
                    self.bucket_tickets.get(bucket, 0) + rows_in
                )
                self.bucket_wins[bucket] = (
                    self.bucket_wins.get(bucket, 0) + rows_in - rows_out
                )

    def record_fused_eval(
        self,
        segments: Sequence[Tuple[int, int, Optional[int]]],
        seconds: float,
        computed_rows: Optional[int] = None,
    ) -> None:
        """One FUSED launch covering ``segments`` of original batches.

        ``segments`` is ``[(rows_in, rows_out, bucket), ...]`` per original
        batch: tickets/wins (global and per content bucket) are credited
        per segment — identical to what per-batch ``record_eval`` calls
        would have accumulated — while the cost EMA and the decomposition
        see ONE launch over the summed rows, so fusing never drags
        ``cost_per_row`` up by charging the full fused launch to each
        small batch."""
        with self._lock:
            total_in = sum(s[0] for s in segments)
            total_out = sum(s[1] for s in segments)
            self.batches += len(segments)
            self.tickets += total_in
            self.wins += total_in - total_out
            if total_in > 0:
                self.cost_per_row.update(seconds / total_in)
            self._note_launch_locked(
                total_in if computed_rows is None else computed_rows, seconds
            )
            if len(segments) > 1:
                self.fused_launches += 1
                self.fused_batches += len(segments)
                self.coalesced_rows += total_in
            for rows_in, rows_out, bucket in segments:
                if bucket is not None:
                    self.bucket_tickets[bucket] = (
                        self.bucket_tickets.get(bucket, 0) + rows_in
                    )
                    self.bucket_wins[bucket] = (
                        self.bucket_wins.get(bucket, 0) + rows_in - rows_out
                    )

    def record_cache(self, probes: int, hits: int) -> None:
        with self._lock:
            self.cache_probes += probes
            self.cache_hits += hits

    # ------------------------- estimates ------------------------- #
    @property
    def measured(self) -> bool:
        return self.batches > 0

    def cost(self, default: float = 1e-3) -> float:
        return self.cost_per_row.get(default)

    def selectivity(self, default: float = 0.5,
                    bucket: Optional[int] = None,
                    min_bucket_tickets: int = 20) -> float:
        """Fraction of rows that PASS (lottery estimator).

        With ``bucket`` given, uses the content-bucket-specific estimate
        once it has enough tickets, else falls back to the global one."""
        with self._lock:
            if bucket is not None:
                bt = self.bucket_tickets.get(bucket, 0)
                if bt >= min_bucket_tickets:
                    return 1.0 - self.bucket_wins.get(bucket, 0) / bt
            if self.tickets == 0:
                return default
            return 1.0 - self.wins / self.tickets

    def pressure(self, queue_depth: int) -> float:
        """Resource-arbitration pressure: measured cost/row x queue depth.

        The ResourceArbiter ranks slot claimants on this (§5.2): a
        predicate whose PROFILED cost is high and whose queues are deep is
        the current bottleneck and wins contended capacity. A drained
        predicate (depth 0) exerts no pressure regardless of cost."""
        return self.cost() * max(0, queue_depth)

    def cache_hit_rate(self) -> float:
        with self._lock:
            if self.cache_probes == 0:
                return 0.0
            return self.cache_hits / self.cache_probes

    def launch_decomposition(
        self, min_samples: int = LAUNCH_FIT_MIN_SAMPLES,
    ) -> Optional[Tuple[float, float]]:
        """Fitted ``(fixed_seconds, marginal_seconds_per_row)`` or None.

        One-variable least squares over the EMA moments of per-launch
        ``(rows, seconds)`` samples: ``marginal = cov(r, s) / var(r)``,
        ``fixed = mean(s) - marginal * mean(r)``.  Returns None until
        ``min_samples`` launches landed AND the observed row counts have
        enough spread to identify a slope (all-identical batch sizes
        cannot); both terms are clamped non-negative — estimator noise can
        produce a slightly negative intercept, which would otherwise make
        the planner chase negative overhead."""
        with self._lock:
            if self.launches < min_samples:
                return None
            r, s = self.lc_rows.get(), self.lc_secs.get()
            var = self.lc_rows2.get() - r * r
            if var <= LAUNCH_FIT_MIN_REL_VAR * max(r * r, 1.0):
                return None
            marginal = (self.lc_rowsecs.get() - r * s) / var
            fixed = s - marginal * r
            return max(fixed, 0.0), max(marginal, 0.0)

    def score(self, bucket: Optional[int] = None,
              resolution: Optional[float] = None) -> float:
        """Classic rank: cost / (1 - selectivity); lower runs first.

        ``resolution`` quantizes the selectivity estimate before scoring so
        rank keys tie at degenerate (noise-level-equal) statistics instead
        of flipping on estimator drift — the policies pass their rank
        resolution here to keep this formula the single source of truth."""
        sel = self.selectivity(bucket=bucket)
        if resolution:
            sel = round(sel / resolution) * resolution
        return self.cost() / max(1.0 - sel, 1e-6)

    def snapshot(self) -> Dict[str, float]:
        return {
            "cost_per_row": self.cost(),
            "selectivity": self.selectivity(),
            "score": self.score(),
            "cache_hit_rate": self.cache_hit_rate(),
            "batches": self.batches,
            "launches": self.launches,
            "fused_launches": self.fused_launches,
            "fused_batches": self.fused_batches,
        }


class ShardedPredicateStats:
    """Lock-sharded predicate statistics: one ``PredicateStats`` stripe per
    routing shard, merged on read.

    Writes go to a THREAD-AFFINE stripe (``thread id % shards``): each
    recording thread owns one stripe's lock, so N workers + N shards never
    serialize on a single per-predicate lock. Reads fold across stripes —
    counter sums for the lottery estimator, a batch-weighted mean of the
    stripe EMAs for cost — without any global lock (counter reads are
    GIL-atomic; a fold may see a stripe mid-update, which perturbs the
    estimate by at most one batch, well under estimator noise)."""

    def __init__(self, name: str, stripes):
        self.name = name
        self.stripes = list(stripes)

    def _stripe(self) -> PredicateStats:
        return self.stripes[threading.get_ident() % len(self.stripes)]

    def stripe(self, i: int) -> PredicateStats:
        """Direct stripe access (tests / per-shard observability)."""
        return self.stripes[i % len(self.stripes)]

    # ------------------------- recording ------------------------- #
    def record_eval(self, rows_in: int, rows_out: int, seconds: float,
                    bucket: Optional[int] = None,
                    computed_rows: Optional[int] = None) -> None:
        self._stripe().record_eval(rows_in, rows_out, seconds, bucket=bucket,
                                   computed_rows=computed_rows)

    def record_fused_eval(
        self,
        segments: Sequence[Tuple[int, int, Optional[int]]],
        seconds: float,
        computed_rows: Optional[int] = None,
    ) -> None:
        self._stripe().record_fused_eval(segments, seconds,
                                         computed_rows=computed_rows)

    def record_cache(self, probes: int, hits: int) -> None:
        self._stripe().record_cache(probes, hits)

    # ------------------------- merged estimates ------------------------- #
    @property
    def measured(self) -> bool:
        return any(s.measured for s in self.stripes)

    @property
    def batches(self) -> int:
        return sum(s.batches for s in self.stripes)

    @property
    def tickets(self) -> int:
        return sum(s.tickets for s in self.stripes)

    @property
    def wins(self) -> int:
        return sum(s.wins for s in self.stripes)

    @property
    def launches(self) -> int:
        return sum(s.launches for s in self.stripes)

    @property
    def fused_launches(self) -> int:
        return sum(s.fused_launches for s in self.stripes)

    @property
    def fused_batches(self) -> int:
        return sum(s.fused_batches for s in self.stripes)

    @property
    def coalesced_rows(self) -> int:
        return sum(s.coalesced_rows for s in self.stripes)

    def launch_decomposition(
        self, min_samples: int = LAUNCH_FIT_MIN_SAMPLES,
    ) -> Optional[Tuple[float, float]]:
        """Launch-weighted fold of the per-stripe moment EMAs, fitted once.

        Folding the MOMENTS (not the per-stripe fits) keeps a stripe with
        too little spread from vetoing the merged estimate: the variance
        that identifies the slope may only exist ACROSS stripes."""
        num_r = num_s = num_r2 = num_rs = den = 0.0
        total = 0
        for s in self.stripes:
            with s._lock:
                if s.launches == 0:
                    continue
                w = s.launches
                total += w
                num_r += s.lc_rows.get() * w
                num_s += s.lc_secs.get() * w
                num_r2 += s.lc_rows2.get() * w
                num_rs += s.lc_rowsecs.get() * w
                den += w
        if total < min_samples or den == 0:
            return None
        r, sec = num_r / den, num_s / den
        var = num_r2 / den - r * r
        if var <= LAUNCH_FIT_MIN_REL_VAR * max(r * r, 1.0):
            return None
        marginal = (num_rs / den - r * sec) / var
        fixed = sec - marginal * r
        return max(fixed, 0.0), max(marginal, 0.0)

    def cost(self, default: float = 1e-3) -> float:
        num = den = 0.0
        for s in self.stripes:
            v = s.cost_per_row.value
            if v is not None:
                w = max(s.batches, 1)
                num += v * w
                den += w
        return num / den if den else default

    def selectivity(self, default: float = 0.5,
                    bucket: Optional[int] = None,
                    min_bucket_tickets: int = 20) -> float:
        if bucket is not None:
            bt = sum(s.bucket_tickets.get(bucket, 0) for s in self.stripes)
            if bt >= min_bucket_tickets:
                bw = sum(s.bucket_wins.get(bucket, 0) for s in self.stripes)
                return 1.0 - bw / bt
        tickets = self.tickets
        if tickets == 0:
            return default
        return 1.0 - self.wins / tickets

    def pressure(self, queue_depth: int) -> float:
        return self.cost() * max(0, queue_depth)

    def cache_hit_rate(self) -> float:
        probes = sum(s.cache_probes for s in self.stripes)
        if probes == 0:
            return 0.0
        return sum(s.cache_hits for s in self.stripes) / probes

    def score(self, bucket: Optional[int] = None,
              resolution: Optional[float] = None) -> float:
        sel = self.selectivity(bucket=bucket)
        if resolution:
            sel = round(sel / resolution) * resolution
        return self.cost() / max(1.0 - sel, 1e-6)

    def snapshot(self) -> Dict[str, float]:
        return {
            "cost_per_row": self.cost(),
            "selectivity": self.selectivity(),
            "score": self.score(),
            "cache_hit_rate": self.cache_hit_rate(),
            "batches": self.batches,
            "launches": self.launches,
            "fused_launches": self.fused_launches,
            "fused_batches": self.fused_batches,
        }


class StatsBoard:
    """All predicate stats + per-worker load accounting (one per executor).

    ``cost_alpha`` sets the cost-estimator EMA horizon: small values model
    long-window averaging (the paper's Fig 9a estimator that "cannot
    promptly adjust" across cache-boundary segments).

    ``shards`` lock-shards every entry (see ``ShardedPredicateStats``) for
    the N-shard routing core; the worker-load ledger's lock is striped by
    worker id so concurrent ``LaminarRouter.submit`` calls from different
    shards don't serialize on one lock either."""

    def __init__(self, predicate_names, *, cost_alpha: float = 0.3,
                 shards: int = 1):
        self.cost_alpha = cost_alpha
        self.shards = max(1, shards)
        self.preds: Dict[str, PredicateStats] = {
            n: self._new_entry(n) for n in predicate_names
        }
        # Routing predicates declared at construction. Auxiliary entries
        # (per-kernel launch costs, fed by ``launch.connect_stats_board``)
        # are created lazily via ``ensure`` and never gate warmup.
        self._declared = frozenset(predicate_names)
        self.worker_load: Dict[str, float] = {}
        self.proxy_rate = Ema(0.3)  # seconds per proxy unit (data-aware ETA)
        self.bucket_fn = None       # content-based routing: batch -> bucket id
        # failure-aware routing: the executor attaches its FaultLedger
        # (core/faults.py) here; policies fold ``fault_penalty`` into
        # their rank keys. None (or a clean ledger) => penalty exactly
        # 1.0, so fault-free rank keys are bit-identical.
        self.faults = None
        self._lock = threading.Lock()
        self._load_locks = [threading.Lock() for _ in range(self.shards)]

    def _new_entry(self, name: str):
        if self.shards == 1:
            return PredicateStats(name, cost_per_row=Ema(self.cost_alpha))
        return ShardedPredicateStats(name, [
            PredicateStats(name, cost_per_row=Ema(self.cost_alpha))
            for _ in range(self.shards)
        ])

    def _load_lock(self, worker: str) -> threading.Lock:
        return self._load_locks[hash(worker) % len(self._load_locks)]

    def bucket_of(self, batch) -> Optional[int]:
        if self.bucket_fn is None:
            return None
        try:
            return int(self.bucket_fn(batch))
        except Exception:
            return None

    def fault_penalty(self, name: str) -> float:
        """Routing rank multiplier from the attached FaultLedger: exactly
        1.0 for a healthy predicate, growing in the error-rate EMA for a
        flaky one (see core/faults.FaultLedger.rank_penalty)."""
        f = self.faults
        return 1.0 if f is None else f.rank_penalty(name)

    def note_proxy_rate(self, units: float, seconds: float) -> None:
        if units > 0:
            with self._lock:
                self.proxy_rate.update(seconds / units)

    def __getitem__(self, name: str) -> PredicateStats:
        return self.preds[name]

    def ensure(self, name: str, shard: Optional[int] = None):
        """Get-or-create an entry, safely from any worker thread.

        Kernel launch hooks report under the kernel's own name, which is
        unknown until the first launch; entries appear mid-run while the
        eddy shards read the board, so creation must hold the lock.

        Shard-aware: with ``shard`` given on a sharded board, returns that
        shard's write stripe directly (an uncontended recording target);
        otherwise returns the merged entry (whose recorders pick a
        thread-affine stripe themselves)."""
        with self._lock:
            st = self.preds.get(name)
            if st is None:
                st = self._new_entry(name)
                self.preds[name] = st
        if shard is not None and isinstance(st, ShardedPredicateStats):
            return st.stripe(shard)
        return st

    def seed_prior(self, name: str, *, cost_per_row: Optional[float] = None,
                   selectivity: Optional[float] = None,
                   tickets: int = 0):
        """Warm-start an entry from a persistent statistics store.

        Seeds the cost EMA and plants ``tickets`` pseudo-tickets at the
        given selectivity (wins derived), then marks the entry measured
        (``batches >= 1``) so the warmup circulation does not re-profile a
        predicate another query already profiled. Pseudo-tickets bound the
        seed's vote against fresh observations: the lottery estimator
        folds real rows straight in, so a run that disagrees with the seed
        out-votes it after ~``tickets`` routed rows. On a sharded board
        the seed lands on stripe 0 and merged reads fold it exactly like
        any other stripe's history. Call BEFORE the run starts — seeding
        overwrites the cost EMA's current value."""
        st = self.ensure(name)
        target = st.stripe(0) if isinstance(st, ShardedPredicateStats) else st
        with target._lock:
            if cost_per_row is not None:
                target.cost_per_row.value = float(cost_per_row)
            if selectivity is not None and tickets > 0:
                sel = min(max(float(selectivity), 0.0), 1.0)
                target.tickets += int(tickets)
                target.wins += int(round(tickets * (1.0 - sel)))
            target.batches = max(target.batches, 1)
        return st

    def ensure_kernel(self, name: str) -> PredicateStats:
        """Entry for a kernel-launch timing stream.

        If a DECLARED routing predicate already owns ``name`` (a predicate
        deliberately named after its kernel), the kernel entry is
        namespaced ``kernel:<name>`` — launch events are compute samples
        (rows_in == rows_out), so merging them into a predicate's entry
        would drag its lottery selectivity toward 1.0 and flip its warmup
        'measured' bit before any batch was routed."""
        if name in self._declared:
            name = "kernel:" + name
        return self.ensure(name)

    def batch_counts(self) -> Dict[str, int]:
        """Merged per-predicate batch counts (declared predicates only).

        The live-fold bookkeeping the multi-tenant service reads: paired
        with ``StatsStore.record_live`` it tells how much NEW evidence a
        running executor has produced since the last cross-query fold."""
        with self._lock:
            items = list(self.preds.items())
        return {name: st.batches for name, st in items}

    def all_measured(self, exclude: Sequence[str] = ()) -> bool:
        """Warmup gate: every DECLARED routing predicate has a measurement.

        Lazily-created kernel entries are deliberately excluded — a kernel
        timing arriving mid-warmup must not wedge the router into waiting
        for a "predicate" it can never route a batch to.  ``exclude``
        names predicates exempt from the gate: a QUARANTINED predicate
        (core/faults.py) may never produce a measurement, and waiting for
        one would circulate warmup batches forever."""
        with self._lock:
            return all(
                self.preds[n].measured for n in self._declared
                if n not in exclude
            )

    # ---------------- data-aware load accounting ---------------- #
    # The ledger lock is striped by worker id: submits racing from
    # different shards only contend when they touch the same worker.
    def add_load(self, worker: str, units: float) -> None:
        with self._load_lock(worker):
            self.worker_load[worker] = self.worker_load.get(worker, 0.0) + units

    def finish_load(self, worker: str, units: float) -> None:
        with self._load_lock(worker):
            self.worker_load[worker] = max(
                0.0, self.worker_load.get(worker, 0.0) - units
            )

    def load_of(self, worker: str) -> float:
        with self._load_lock(worker):
            return self.worker_load.get(worker, 0.0)

    def snapshot(self, shard: Optional[int] = None) -> Dict[str, Dict[str, float]]:
        """Per-predicate snapshots — merged by default; ``shard=i`` returns
        shard ``i``'s un-merged stripe view on a sharded board (per-shard
        observability; identical to the merged view when ``shards == 1``)."""
        with self._lock:  # copy first: entries may be created concurrently
            items = list(self.preds.items())
        if shard is not None:
            return {
                n: (p.stripe(shard) if isinstance(p, ShardedPredicateStats)
                    else p).snapshot()
                for n, p in items
            }
        return {n: p.snapshot() for n, p in items}
