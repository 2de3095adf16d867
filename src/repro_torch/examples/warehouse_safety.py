"""UC2 + UC3: warehouse-safety analytics with result reuse and Laminar.

Port of the JAX package's examples/warehouse_safety.py. Runs the paper's
exploratory sequence (Listing 3):
  Q1: ObjectDetector over frames [A, B)        -> populates cache
  Q2: HardHatDetector over frames [C, D)       -> populates cache
  Q3: person AND no-hardhat over ALL frames    -> recurrent query

Q3 executes twice, cost-driven and reuse-aware, and reports how much of
the work the reuse-aware router avoided. GACU worker counts show Laminar
scaling on the expensive predicate.

Both detectors are ``repro_torch.udfs.planted_detector``s: the
hand-written HSV kernel's compute with planted labels, so the executor's
launch hook records genuine per-launch kernel cost under "hsv_color" in
the routing statistics. They hold the arbiter label "cuda:0" (the JAX
package's "tpu:0") and run on ``--device``.

  PYTHONPATH=src python -m repro_torch.examples.warehouse_safety --frames 400

--device cpu runs the kernel's plain version; the default, cuda, raises
at once without a card.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import udfs
from repro_torch.core import (
    AQPExecutor, CostDriven, ReuseAware, ReuseCache, make_batch,
)


def frame_batches(n_frames, work_dim=96, per=10, seed=0):
    rng = np.random.default_rng(seed)
    for i in range(0, n_frames, per):
        rid = np.arange(i, min(i + per, n_frames))
        yield make_batch(
            {"frame": rng.integers(0, 255, (len(rid), work_dim, work_dim, 3)
                                   ).astype(np.float32),
             "rid": rid},
            rid,
        )


def main(argv=None) -> dict:
    """Returns {policy label: {"rows": Q3's frame ids, "stats": its
    executor's snapshot}} and the ground truth under "expect"."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=400)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    n = args.frames
    rng = np.random.default_rng(1)
    person = rng.random(n) < 0.5
    nohat = rng.random(n) < 0.3

    p_obj = udfs.planted_detector("person", person, work_dim=96,
                                  device=args.device)
    p_hat = udfs.planted_detector("no_hardhat", nohat, work_dim=96,
                                  device=args.device)
    obj_udf, hat_udf = p_obj.udf, p_hat.udf

    def primed_cache():
        """Q1/Q2: exploratory queries populate a fresh cache."""
        cache = ReuseCache()
        seg = n // 4
        for name, udf, lo, hi in (
            ("Q1 ObjectDetector", obj_udf, 0, 2 * seg),
            ("Q2 HardHatDetector", hat_udf, 2 * seg, n),
        ):
            rid = np.arange(lo, hi)
            frames = np.zeros((len(rid), 96, 96, 3), np.float32)
            t0 = time.perf_counter()
            out = udf({"frame": frames, "rid": rid})
            cache.put(udf.name, rid, out)
            print(f"{name}: cached frames [{lo},{hi}) in "
                  f"{time.perf_counter()-t0:.2f}s")
        return cache

    # ---- Q3 recurrent query: cost-driven vs reuse-aware (fresh identical
    # caches, so the comparison is about ROUTING, not cache state) ----
    results = {}
    for label, policy in (("cost-driven", CostDriven()),
                          ("reuse-aware", ReuseAware())):
        ex = AQPExecutor([p_obj, p_hat], policy=policy, cache=primed_cache(),
                         max_workers=8, cost_alpha=0.05)
        t0 = time.perf_counter()
        got = {int(i) for b in ex.run(iter(frame_batches(n))) for i in b.row_ids}
        dt = time.perf_counter() - t0
        snap = ex.stats_snapshot()
        results[label] = {"rows": got, "stats": snap, "wall_s": dt}
        print(f"\nQ3 [{label}] -> {len(got)} unsafe frames in {dt:.2f}s")
        for pname in ("person", "no_hardhat"):
            s = snap[pname]
            print(f"  {pname}: cache_hit_rate={s['cache_hit_rate']:.2f} "
                  f"est_cost/row={s['cost_per_row']*1e3:.2f}ms")
        if "hsv_color" in snap:  # launch hook: real per-kernel launch cost
            s = snap["hsv_color"]
            print(f"  hsv_color kernel: cost/row={s['cost_per_row']*1e3:.3f}ms"
                  f" launches={int(s['batches'])}")
        print(f"  GACU active workers: {ex.active_worker_counts()}")
        print(f"  arbiter (leases/releases/handoffs): {snap['_arbiter']}")

    assert results["cost-driven"]["rows"] == results["reuse-aware"]["rows"]
    expect = set(np.nonzero(person & nohat)[0].tolist())
    assert results["reuse-aware"]["rows"] == expect, "must match ground truth"
    print("\nresults identical across policies and equal to ground truth ✓")
    return {**results, "expect": expect}


if __name__ == "__main__":
    main()
