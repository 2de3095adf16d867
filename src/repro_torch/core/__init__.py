"""Hydro: adaptive query processing of ML queries — the paper's contribution.

Public surface:
  RoutingBatch / make_batch          — §3.3 batch + metadata
  CentralQueue / BoundedQueue        — §3.2/§3.3 queues, lambda watermark
  StatsBoard                         — §3.3 runtime statistics
  UDF / Predicate                    — ML UDF wrappers (shape-bucketed)
  ReuseCache / ContentHashCache / LayeredReuseCache — §4.3 result reuse
    (id-keyed, content-hash + TTL, and the cross-query layered composition)
  StatsStore / canonical_fingerprint — cross-query persistent statistics
    (fingerprint -> age-decayed EMA cost/selectivity, warm-starts runs)
  policies: CostDriven / ScoreDriven / SelectivityDriven / ReuseAware /
            HydroPolicy; RoundRobin / DataAware / DeviceAlternating;
            PressureRanked / StaticPartition (arbiter)
  DevicePool / ResourceArbiter       — §5.2 elastic cross-predicate leasing
  LaminarRouter (GACU) / EddyShardSet / AQPExecutor — §3.2, §4, §5
    (the eddy core runs as N routing shards with work-stealing and merged
    statistics; single-shard is the deterministic default — see core/eddy.py)
  Query / optimize / PhysicalPlan    — §3.1 rule-based plan -> AQP plan
  SimClock / WallClock               — deterministic scheduling evaluation
  CoalesceConfig / CoalescePlanner   — §5.1 adaptive micro-batch coalescing
    (fuse queued batches into one launch; executor knob ``coalesce=``)
  FaultPlan / FaultLedger / FaultConfig / LaunchWatchdog / ReverifyQueue —
    fault injection, per-predicate failure statistics (with recovery
    probes un-quarantining on success), retry/degrade/quarantine policy,
    hung-launch detection, and the pass-through re-verification queue
    (executor knobs ``on_fault=`` / ``reverify=``; see core/faults.py)
  QuerySession / urgency_weight      — restartable per-query sessions and
    deadline/priority arbitration urgency (multi-tenant QueryService —
    the serving layer itself lives in repro.launch.serve)
  vectorized (two_stage_filter / cascade_filter) — TPU-native short-circuit
"""
from repro_torch.core.batch import (  # noqa: F401
    BatchSegment,
    RoutingBatch,
    concat,
    make_batch,
    split_back,
)
from repro_torch.core.coalesce import (  # noqa: F401
    CoalesceConfig,
    CoalescePlanner,
    FusePlan,
)
from repro_torch.core.cache import (  # noqa: F401
    ContentHashCache,
    LayeredReuseCache,
    ReuseCache,
    row_digests,
)
from repro_torch.core.eddy import (  # noqa: F401
    SHARD_AUTO_MAX,
    SHARD_AUTO_THRESHOLD_BPS,
    EddyShardSet,
    InFlightTracker,
)
from repro_torch.core.executor import AQPExecutor, QuerySession  # noqa: F401
from repro_torch.core.faults import (  # noqa: F401
    CorruptOutputError,
    FaultConfig,
    FaultLedger,
    FaultPlan,
    InjectedFault,
    LaunchWatchdog,
    ReverifyQueue,
)
from repro_torch.core.laminar import GACU_MAX_WORKERS, LaminarRouter  # noqa: F401
from repro_torch.core.plan import (  # noqa: F401
    PhysicalPlan,
    Query,
    TrivialPredicate,
    batches_of,
    optimize,
)
from repro_torch.core.policies import (  # noqa: F401
    ArbiterPolicy,
    CostDriven,
    DataAware,
    DeviceAlternating,
    HydroPolicy,
    PressureRanked,
    ReuseAware,
    RoundRobin,
    ScoreDriven,
    SelectivityDriven,
    StaticPartition,
    urgency_weight,
)
from repro_torch.core.queues import BoundedQueue, CentralQueue  # noqa: F401
from repro_torch.core.resources import (  # noqa: F401
    DRAIN_THRESHOLD_S,
    DevicePool,
    ResourceArbiter,
)
from repro_torch.core.simclock import SimClock, WallClock  # noqa: F401
from repro_torch.core.stats import PredicateStats, StatsBoard  # noqa: F401
from repro_torch.core.statstore import (  # noqa: F401
    COST_MODEL_VERSION,
    StatsStore,
    canonical_fingerprint,
    fingerprint_of,
)
from repro_torch.core.udf import UDF, Predicate  # noqa: F401
