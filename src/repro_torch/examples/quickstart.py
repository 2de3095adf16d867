"""Quickstart: a Hydro AQP query in ~50 lines.

Port of the JAX package's examples/quickstart.py. Two ML-ish predicates
over a small table; the eddy router discovers at run time that the cheap
heuristic should run first, and the result set is identical to naive
evaluation (Hydro never trades accuracy). The "embedder" (a 16 x 512
product and a tanh) runs on ``--device`` and holds the arbiter label
"cuda:0" (the JAX package's "tpu:0"); the heuristic runs on the host.

  PYTHONPATH=src python -m repro_torch.examples.quickstart --device cuda

--device cpu runs the embedder on the CPU; the default, cuda, raises at
once without a card.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import AQPExecutor, HydroPolicy, Predicate, UDF, make_batch
from repro_torch.kernels import launch


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = launch.require_device(args.device)

    rng = np.random.default_rng(0)
    x = rng.standard_normal((200, 16)).astype(np.float32)
    # an expensive "model" (a wide product) and a cheap heuristic
    W = torch.from_numpy(rng.standard_normal((16, 512)).astype(np.float32)
                         ).to(dev)

    def embed(d):
        with launch.thread_stream(dev):
            xt = torch.from_numpy(np.asarray(d["x"], np.float32)).to(dev)
            return torch.tanh(xt @ W).mean(1).cpu().numpy()

    expensive = UDF("embedder", fn=embed, columns=("x",), resource="cuda:0")
    cheap = UDF("heuristic", fn=lambda d: d["x"].mean(1),
                columns=("x",), resource="cpu")
    preds = [
        Predicate("embed_score", expensive, compare=lambda s: s > 0.0),
        Predicate("mean_filter", cheap, compare=lambda s: s > -0.5),
    ]
    batches = [make_batch({"x": x[i:i + 10]}, np.arange(i, i + 10))
               for i in range(0, 200, 10)]

    ex = AQPExecutor(preds, policy=HydroPolicy(), max_workers=4)
    matched = sorted(int(i) for b in ex.run(iter(batches)) for i in b.row_ids)

    naive = np.nonzero((embed({"x": x}) > 0.0) & (x.mean(1) > -0.5))[0]
    assert matched == naive.tolist(), "AQP must equal naive evaluation"

    print(f"matched {len(matched)} rows (== naive evaluation) on {dev}")
    print("runtime statistics the router discovered:")
    snap = ex.stats_snapshot()
    for name, s in snap.items():
        if name.startswith("_"):   # reserved sections (e.g. _arbiter counters)
            continue
        print(f"  {name}: cost/row={s['cost_per_row']*1e6:.1f}us "
              f"selectivity={s['selectivity']:.2f}")
    return {"matched": matched, "stats": snap}


if __name__ == "__main__":
    main()
