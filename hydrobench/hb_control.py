"""The check's control: the reference in the program's place, computed in
fp8 (the precision below the bf16 the configurations state), judged by
the run's own check.

  python3 hydrobench/hb_control.py --workload smollm-135m.long \
      --seeds 11,12,13

For each seed: the cell's weights and traffic as a run makes them, and
the first queries of the size deck, each answered as a run would record
it: the queries ``hb_harness.check`` will sample (as many rows that reach
the UDF as a run's check reads, the largest query first) get the fp8
reference's scores as the timed path's evaluations and, as their answer,
the rows whose fp8 score is above 0. ``hb_harness.check`` then holds them
to the float32 reference. Prints one JSON line a seed: ``correct`` as a
run computes it, and each compared number beside its limit. The
benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def control(cell, seed: int, device) -> dict:
    import numpy as np
    import torch

    import hb_harness
    import hb_reference
    from hb_traffic import Traffic

    traffic = Traffic(cell.traffic, seed)
    column, op, value = cell.spec["query"]["trivial"]
    dev = torch.device(device)
    gen = torch.Generator(dev).manual_seed(int(seed) % (1 << 63))
    weights = cell.family.make_weights(
        cell.cfg, gen, dev,
        getattr(torch, hb_harness.port_config(cell.cfg).dtype))

    def keep(r):
        return r.rating <= value

    queries = [{"k": k, "rows": traffic.size(k), "state": "DONE", "ids": []}
               for k in range(len(traffic.deck))]
    sample = hb_harness.sample_queries(
        traffic, queries, cell.spec["check"]["sample_rows"], seed, keep)
    evals = []
    hb_reference.float32_products()
    for q in sample:
        rows = [r for r in traffic.rows(q["k"]) if keep(r)]
        low = hb_reference.scores(
            cell.family, cell.cfg, weights,
            [torch.from_numpy(np.asarray(r.tokens, np.int64)) for r in rows],
            "fp8")
        evals.append(([hb_harness.row_key(r.tokens) for r in rows],
                      np.asarray(low, np.float64), None))
        q["ids"] = [r.rid for r, s in zip(rows, low) if s > 0]
    checks = hb_harness.check(cell, traffic, queries, evals, weights, seed)
    return {"seed": seed, "queries": len(sample),
            "correct": hb_harness.is_correct(checks),
            "checks": {k: {"value": v, "limit": lim}
                       for k, (v, lim) in checks.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(HERE.parent / "src"), str(HERE)]
    import hb_harness

    cell = hb_harness.load_cell(args.workload, False)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(control(cell, seed, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
