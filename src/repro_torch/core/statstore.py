"""Persistent cross-query statistics store (ROADMAP: cross-query reuse).

Hydro's position (§3.3) is that UDF statistics are PROFILED, never
estimated a priori — but profiling restarted from roofline priors on every
``AQPExecutor.run()``. This store carries profiled cost/selectivity ACROSS
queries and processes (the GRACEFUL / Adaptive Cost Model argument for
profiled, drift-tracked UDF costs): canonical predicate fingerprints map
to EMA records that warm-start each run's StatsBoard and are re-observed
when the run ends.

Fingerprints
------------
``canonical_fingerprint(kernel, **config)`` builds a deterministic string
``"<kernel>|k1=v1|...|cmv=<COST_MODEL_VERSION>"`` from the kernel name,
its configuration (sorted, repr-ed — no process-randomized hashing), and
the cost-model version, so

  * the same predicate built in two processes maps to the same record;
  * two configs of one kernel (``color='black'`` vs ``'white'``) never
    share a profile;
  * bumping ``COST_MODEL_VERSION`` orphans every old record when cost
    semantics change.

UDF builders attach the fingerprint via ``UDF.fingerprint``;
``fingerprint_of(pred)`` falls back to ``udf:<name>`` for ad-hoc UDFs so
any predicate with a stable name still warm-starts.

Age decay (knobs)
-----------------
A record observed ``age`` seconds ago carries weight
``0.5 ** (age / half_life_s)``. The weight scales the warm-start's
pseudo-ticket count (``pseudo_tickets * weight``), so a stale profile
seeds a weaker prior that fresh lottery observations out-vote quickly;
below ``min_weight`` the record is not seeded at all — stale profiles
lose to fresh observations by construction. Re-observation blends with
the same weight: a record that sat unused for many half-lives is mostly
replaced by the new profile rather than averaged with it.

Defaults: ``half_life_s`` 6h, ``pseudo_tickets`` 256 (≈ a few dozen
routing batches of evidence), ``min_weight`` 0.05, observation EMA
``alpha`` 0.3. Persistence is JSON with temp-file + ``os.replace``
(atomic); a corrupt store file warns and starts cold, mirroring
``ReuseCache``.
"""
from __future__ import annotations

import json
import os
import threading
import time
import warnings
from typing import Dict, List, Optional

# Bump when cost-model semantics change (e.g. cost_per_row units or the
# roofline seed): old profiles become unreachable under the new version's
# fingerprints instead of silently mis-seeding.
COST_MODEL_VERSION = 1

DEFAULT_HALF_LIFE_S = 6 * 3600.0
DEFAULT_PSEUDO_TICKETS = 256
DEFAULT_MIN_WEIGHT = 0.05


def canonical_fingerprint(kernel: str, *, version: int = COST_MODEL_VERSION,
                          **config) -> str:
    """Deterministic cross-process fingerprint: kernel + config + version."""
    parts = [str(kernel)]
    parts += [f"{k}={config[k]!r}" for k in sorted(config)]
    parts.append(f"cmv={version}")
    return "|".join(parts)


def fingerprint_of(pred) -> str:
    """A predicate's canonical fingerprint.

    Kernel-backed UDFs carry one from their builder (``UDF.fingerprint``);
    ad-hoc UDFs fall back to their stable name."""
    fp = getattr(pred.udf, "fingerprint", None)
    return fp or canonical_fingerprint(f"udf:{pred.udf.name}")


class StatsStore:
    """Fingerprint -> EMA cost/selectivity records, decayed by age.

    ``path=None`` keeps the store in memory (benchmarks sharing one store
    across executors); with a path, ``flush()`` persists atomically and
    construction loads tolerantly. Thread-safe: one executor may record
    while another warm-starts."""

    def __init__(self, path: Optional[str] = None, *,
                 half_life_s: float = DEFAULT_HALF_LIFE_S,
                 pseudo_tickets: int = DEFAULT_PSEUDO_TICKETS,
                 min_weight: float = DEFAULT_MIN_WEIGHT,
                 alpha: float = 0.3,
                 clock=time.time):
        self.path = path
        self.half_life_s = half_life_s
        self.pseudo_tickets = pseudo_tickets
        self.min_weight = min_weight
        self.alpha = alpha
        self.clock = clock
        self._records: Dict[str, Dict[str, float]] = {}
        self._lock = threading.RLock()
        if path and os.path.exists(path):
            self._load()

    # --------------------------- records --------------------------- #
    def get(self, fingerprint: str) -> Optional[Dict[str, float]]:
        with self._lock:
            rec = self._records.get(fingerprint)
            return dict(rec) if rec is not None else None

    def weight_of(self, record: Dict[str, float]) -> float:
        """Age-decay weight in [0, 1]: halves every ``half_life_s``."""
        age = max(0.0, self.clock() - record.get("updated_at", 0.0))
        return 0.5 ** (age / self.half_life_s)

    def observe(self, fingerprint: str, *, cost_per_row: float,
                selectivity: float, batches: int = 1) -> None:
        """Fold one run's profiled statistics into the record.

        The blend is age-weighted: the old value enters at
        ``(1 - alpha) * weight``, so a record decayed to ~0 is effectively
        replaced by the fresh profile."""
        with self._lock:
            rec = self._records.get(fingerprint)
            now = self.clock()
            if rec is None:
                rec = {
                    "cost_per_row": float(cost_per_row),
                    "selectivity": float(selectivity),
                    "batches": int(batches),
                    "updated_at": now,
                }
            else:
                w_old = (1.0 - self.alpha) * self.weight_of(rec)
                denom = self.alpha + w_old
                rec["cost_per_row"] = (
                    self.alpha * cost_per_row
                    + w_old * rec["cost_per_row"]
                ) / denom
                rec["selectivity"] = (
                    self.alpha * selectivity
                    + w_old * rec["selectivity"]
                ) / denom
                rec["batches"] = int(rec.get("batches", 0)) + int(batches)
                rec["updated_at"] = now
            self._records[fingerprint] = rec

    # -------------------------- board glue -------------------------- #
    def warm_start(self, board, predicates: List) -> Dict[str, int]:
        """Seed a StatsBoard from stored records; returns the per-name
        batch count contributed by seeds (so callers can tell seeded
        entries from genuinely-profiled ones when recording back).

        Seeding marks the entry measured, so a fully warm-started run
        skips the warmup circulation entirely — the cross-query
        equivalent of the paper's warmup phase having already happened."""
        seeded: Dict[str, int] = {}
        for p in predicates:
            rec = self.get(fingerprint_of(p))
            if rec is None:
                continue
            w = self.weight_of(rec)
            if w < self.min_weight:
                continue  # stale beyond use: let the run profile afresh
            tickets = int(round(self.pseudo_tickets * w))
            if tickets < 1:
                continue
            board.seed_prior(
                p.name,
                cost_per_row=rec["cost_per_row"],
                selectivity=rec["selectivity"],
                tickets=tickets,
            )
            seeded[p.name] = 1
        return seeded

    def record_board(self, board, predicates: List,
                     seeded: Optional[Dict[str, int]] = None) -> None:
        """Fold a finished run's board back into the store.

        Entries whose batch count never grew past their seed are skipped:
        re-observing a seed would refresh ``updated_at`` and make stale
        data look freshly profiled."""
        seeded = seeded or {}
        for p in predicates:
            try:
                st = board[p.name]
            except KeyError:
                continue
            base = seeded.get(p.name, 0)
            if st.batches <= base:
                continue
            self.observe(
                fingerprint_of(p),
                cost_per_row=st.cost(),
                selectivity=st.selectivity(),
                batches=st.batches - base,
            )

    def record_live(self, board, predicates: List,
                    bases: Dict[str, int]) -> Dict[str, int]:
        """Fold a STILL-RUNNING executor's live profile into the store.

        The multi-tenant live-prior channel (launch/serve.py QueryService):
        before dispatching a new query, the service folds each running
        executor's current board here so the newcomer's ``warm_start``
        sees its rivals' in-flight measurements, not just finished runs.

        ``bases`` maps predicate name -> batch count already folded (the
        warm-start seed on first call, then whatever this method returned
        last time); only the delta since the base is observed, so repeated
        folds never double-count evidence. Returns the updated bases."""
        out = dict(bases)
        for p in predicates:
            try:
                st = board[p.name]
            except KeyError:
                continue
            base = out.get(p.name, 0)
            if st.batches <= base:
                continue
            self.observe(
                fingerprint_of(p),
                cost_per_row=st.cost(),
                selectivity=st.selectivity(),
                batches=st.batches - base,
            )
            out[p.name] = st.batches
        return out

    # ----------------------------- disk ----------------------------- #
    def flush(self) -> None:
        """Atomic JSON snapshot (temp file + ``os.replace``)."""
        if not self.path:
            return
        with self._lock:
            payload = json.dumps(
                {"version": COST_MODEL_VERSION, "records": self._records},
                sort_keys=True,
            )
        tmp = self.path + ".tmp"
        try:
            with open(tmp, "w") as f:
                f.write(payload)
            os.replace(tmp, self.path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)

    def _load(self) -> None:
        try:
            with open(self.path) as f:
                blob = json.load(f)
            records = blob["records"] if isinstance(blob, dict) else {}
            if not isinstance(records, dict):
                raise ValueError("malformed records")
            self._records = {
                str(k): dict(v) for k, v in records.items()
                if isinstance(v, dict)
            }
        except Exception as e:
            self._records = {}
            warnings.warn(
                f"StatsStore: could not load {self.path!r} ({e!r}); "
                "starting cold"
            )

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)
