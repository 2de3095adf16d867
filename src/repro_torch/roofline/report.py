"""Markdown report generation from dry-run artifacts.

Port of ``repro.roofline.report`` (which imports nothing of JAX; the port
keeps its own copy): the same tables from the port's dry-run records
(``launch/dryrun.py``), read by default from ``results/dryrun_torch/``.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, List

ARCH_ORDER = [
    "yi-6b", "smollm-135m", "llama3-8b", "h2o-danube-1.8b", "arctic-480b",
    "grok-1-314b", "whisper-small", "recurrentgemma-9b", "llava-next-34b",
    "mamba2-370m",
]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(dirname: str) -> Dict[str, dict]:
    out = {}
    for f in glob.glob(os.path.join(dirname, "*.json")):
        r = json.load(open(f))
        out[f"{r['arch']}__{r['shape']}__{r.get('mesh', r.get('variant'))}"] = r
    return out


def _gb(x) -> str:
    return f"{x/1e9:.2f}"


def dryrun_table(records: Dict[str, dict]) -> List[str]:
    lines = [
        "| arch | shape | mesh | status | bytes/device (arg+temp) GB | "
        "flops/dev (scan-once) | collectives (count) |",
        "|---|---|---|---|---|---|---|",
    ]
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            for mesh in ("singlepod", "multipod"):
                r = records.get(f"{arch}__{shape}__{mesh}")
                if r is None:
                    continue
                if r["status"] != "ok":
                    lines.append(
                        f"| {arch} | {shape} | {mesh} | {r['status']}: "
                        f"{r.get('reason', r.get('error', ''))[:60]} | — | — | — |"
                    )
                    continue
                mem = r["memory"]
                colls = ", ".join(
                    f"{k}:{v['count']}" for k, v in r["collectives"].items()
                    if v["count"]
                ) or "none"
                lines.append(
                    f"| {arch} | {shape} | {mesh} | ok | "
                    f"{_gb(mem['argument_bytes'])}+{_gb(mem['temp_bytes'])} | "
                    f"{r['per_device']['flops_scan_once']:.3g} | {colls} |"
                )
    return lines


def roofline_table(records: Dict[str, dict]) -> List[str]:
    lines = [
        "| arch | shape | compute (s) | memory (s) | collective (s) | dominant "
        "| roofline fraction | MODEL_FLOPS | useful ratio | next lever |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            r = records.get(f"{arch}__{shape}__singlepod")
            if r is None or "roofline" not in r:
                continue
            t = r["roofline"]["terms"]
            lever = LEVERS.get((arch, shape)) or LEVERS.get(
                ("*", t["dominant"]), ""
            )
            lines.append(
                f"| {arch} | {shape} | {t['compute_s']:.3g} | {t['memory_s']:.3g} "
                f"| {t['collective_s']:.3g} | {t['dominant'].replace('_s','')} "
                f"| {t['roofline_fraction']:.3f} | {r['roofline']['model_flops']:.3g} "
                f"| {r['roofline']['useful_ratio']:.3f} | {lever} |"
            )
    return lines


# one-sentence "what would move the dominant term down", per cell
LEVERS = {
    ("*", "memory_s"): "fuse/bf16 intermediates; shrink recompute traffic (remat policy)",
    ("*", "collective_s"): "reshard to cut gathers; overlap collectives with compute",
    ("smollm-135m", "train_4k"): "model axis wasted on a 135M model: drop TP to 1, pure DP",
    ("whisper-small", "train_4k"): "12 heads %% 16 replicate attention: use TP=4 submesh",
    ("arctic-480b", "decode_32k"): "resident-expert ep2d kills per-layer weight gather (DONE, SS Perf)",
    ("grok-1-314b", "train_4k"): "fewer microbatches => fewer FSDP regathers (SS Perf)",
    ("llama3-8b", "decode_32k"): "fp8 cache + row-wise DUS (DONE, SS Perf)",
    ("mamba2-370m", "train_4k"): "370M model over-sharded: TP=1; state dims replicated",
}


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=os.path.join(
        os.path.dirname(__file__), "..", "..", "..", "results", "dryrun_torch"))
    recs = load(os.path.abspath(ap.parse_args(argv).dir))
    print("\n".join(dryrun_table(recs)))
    print()
    print("\n".join(roofline_table(recs)))


if __name__ == "__main__":
    main()
