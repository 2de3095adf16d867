"""repro_torch.udfs — the kernel-backed predicate library of the port.

Kernels become first-class ``Predicate``s whose per-launch timings feed
the SAME ``StatsBoard.record_eval`` path the eddy routing policies rank
on: ``AQPExecutor.run()`` registers ``launch.connect_stats_board`` for the
lifetime of a run, so a predicate built here reports kernel cost under the
kernel's launch name, beside its predicate-level stats.

Layout
------
``library``   kernel predicate builders + the ``KERNEL_PREDICATES``
              registry (hsv_color, moe_router, ssd, rglru, flash_attention,
              decode_attention)
``rooflines`` analytic roofline cost priors (cold-start / SimClock only)
``synthetic`` planted predicates for deterministic benchmarks
"""
from repro_torch.udfs.library import (  # noqa: F401
    KERNEL_PREDICATES,
    attention_scorer_predicate,
    build_predicate,
    color_predicate,
    decode_relevance_predicate,
    register_kernel_predicate,
    rglru_gate_predicate,
    ssd_scorer_predicate,
    topic_router_predicate,
)
from repro_torch.udfs.synthetic import (  # noqa: F401
    planted_classifier,
    planted_detector,
    planted_predicate,
)
