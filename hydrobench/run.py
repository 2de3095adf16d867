"""Run one cell of the benchmark of the PyTorch and CUDA port on one card.

  python3 hydrobench/run.py --workload smollm-135m.long --seed 7 \
      --seconds 30 --trace 0

From the root of a checkout. Prints the result as the last line of its
standard output (one JSON object) and the compared numbers beside their
limits as the last lines of its standard error. Exits with a code other
than 0, printing no result, when torch sees no card or fewer cards than
the cell asks for, and when the process holds JAX or the JAX package
(``repro``) once the window has closed.
"""
from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# every build and kernel cache of the program inside the checkout, at a
# fixed path (the kernels' own libraries go to build/repro_torch)
CACHES = {"TRITON_CACHE_DIR": ROOT / "build" / "hydrobench" / "triton",
          "TORCH_EXTENSIONS_DIR": ROOT / "build" / "hydrobench" / "torch_ext"}
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for key, path in CACHES.items():
        os.environ[key] = str(path)
    sys.path[:0] = [str(ROOT / "src"), str(HERE)]
    import torch

    import hb_harness

    cell = hb_harness.load_cell(args.workload, bool(args.trace))
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"hydrobench: the cell needs {cell.chips} CUDA card(s); torch "
              f"sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, lines = hb_harness.run_cell(cell, args.seed, args.seconds,
                                        bool(args.trace), device="cuda",
                                        t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"hydrobench: the process holds {bad}: the benchmark runs the "
              "port without JAX", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
