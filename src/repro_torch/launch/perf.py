"""Perf hillclimbing driver: trace a cell under named variants and report
the roofline-term deltas and per-collective-type byte breakdowns.

Port of ``repro.launch.perf``, on the port's dry run (``launch/dryrun.py``:
a fake process group, fake tensors, ``roofline.analysis.Trace``). Each
iteration is one invocation:

  PYTHONPATH=src python -m repro_torch.launch.perf --arch arctic-480b \\
      --shape decode_32k --variant baseline --variant moe_ep2d

Variants are config transforms (the code paths they enable live in the
model zoo behind config flags, so production configs can adopt them).
Results accumulate in ``results/perf_torch/<cell>__<variant>.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

from repro_torch.configs import get_config, get_shape
from repro_torch.launch.dryrun import compile_cell, mesh_for, roofline_record
from repro_torch.launch.mesh import make_fake_mesh, mesh_chip_count, start_fake_world

RESULTS = os.path.join(os.path.dirname(__file__), "..", "..", "..", "results",
                       "perf_torch")


# ----------------------------- variants ----------------------------------- #
def v_baseline(cfg):
    return cfg


def v_moe_ep2d(cfg):
    """Resident-expert 2D EP at serve: experts over 'data', d_ff over
    'model' — removes the per-layer expert weight gather entirely."""
    return dataclasses.replace(cfg, moe_serve_ep2d=True)


def v_cache_fp8(cfg):
    """KV cache stored in fp8_e4m3 (halves cache reads/writes)."""
    return dataclasses.replace(cfg, cache_dtype="float8_e4m3fn")


def v_remat_dots(cfg):
    return dataclasses.replace(cfg, remat_policy="dots_no_batch")


def v_accum16(cfg):
    return dataclasses.replace(cfg, grad_accum=16)


def v_accum4(cfg):
    return dataclasses.replace(cfg, grad_accum=4)


def v_sp_accum1(cfg):
    """Sequence-parallel activations + NO grad accumulation: the residual
    stream shards seq over 'model' (16x smaller), so the global batch fits
    in one pass and the per-microbatch FSDP weight regathers disappear."""
    return dataclasses.replace(cfg, seq_parallel=True, grad_accum=0)


def v_sp_accum2(cfg):
    return dataclasses.replace(cfg, seq_parallel=True, grad_accum=2)


def v_sp_accum4(cfg):
    return dataclasses.replace(cfg, seq_parallel=True, grad_accum=4)


def v_ep2d_fp8(cfg):
    """Stacked serving optimizations: resident experts + fp8 KV cache."""
    return dataclasses.replace(cfg, moe_serve_ep2d=True,
                               cache_dtype="float8_e4m3fn")


VARIANTS = {
    "baseline": v_baseline,
    "moe_ep2d": v_moe_ep2d,
    "cache_fp8": v_cache_fp8,
    "remat_dots": v_remat_dots,
    "accum16": v_accum16,
    "accum4": v_accum4,
    "sp_accum1": v_sp_accum1,
    "sp_accum2": v_sp_accum2,
    "sp_accum4": v_sp_accum4,
    "ep2d_fp8": v_ep2d_fp8,
}


def collective_breakdown(sample):
    out = {}
    for op, rec in sample.collectives.items():
        if rec["count"]:
            out[op] = {
                "count": rec["count"],
                "wire_GB": round(rec["wire_bytes"] / 1e9, 4),
            }
    return out


def run(arch: str, shape_name: str, variant: str, *, outdir: str,
        mesh_shape=None) -> dict:
    cfg0, shape = get_config(arch), get_shape(shape_name)
    cfg = VARIANTS[variant](cfg0)
    if mesh_shape is None:
        mesh = mesh_for("singlepod")
    else:
        n = 1
        for s in mesh_shape:
            n *= s
        start_fake_world(n)
        mesh = make_fake_mesh(tuple(mesh_shape))
    chips = mesh_chip_count(mesh)

    # the full cell: the REAL step, accumulation included (eager torch
    # counts every layer and microbatch, so no delta units are needed)
    sample, times = compile_cell(cfg, shape, mesh)
    roof = roofline_record(cfg, cfg0, shape, sample, chips)
    terms, totals = roof["terms"], roof["per_device"]

    rec = {
        "arch": arch, "shape": shape_name, "variant": variant,
        "mesh_shape": list(mesh.shape),
        "terms": terms,
        "per_device": totals,
        "memory": sample.mem,
        "collectives_full_model_scan_once": collective_breakdown(sample),
        "model_flops": roof["model_flops"],
        "useful_ratio": roof["useful_ratio"],
        "times": times,
    }
    os.makedirs(outdir, exist_ok=True)
    tag = "" if mesh_shape is None else f"__mesh{'x'.join(map(str, mesh_shape))}"
    path = os.path.join(outdir, f"{arch}__{shape_name}__{variant}{tag}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=float)

    print(f"== {arch} / {shape_name} / {variant} ==")
    print(f" compute_s={terms['compute_s']:.4g} memory_s={terms['memory_s']:.4g} "
          f"collective_s={terms['collective_s']:.4g} dominant={terms['dominant']}")
    print(f" roofline_fraction={terms['roofline_fraction']:.4f} "
          f"useful_ratio={rec['useful_ratio']:.3f}")
    print(f" temp_bytes/dev={sample.mem['temp_bytes']/1e9:.2f}GB "
          f"args/dev={sample.mem['argument_bytes']/1e9:.2f}GB")
    print(f" collectives (full model): "
          f"{rec['collectives_full_model_scan_once']}")
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", action="append", default=None,
                    choices=sorted(VARIANTS))
    ap.add_argument("--mesh-shape", default=None,
                    help="override (data,model), e.g. 256,1 for pure DP")
    ap.add_argument("--outdir", default=os.path.abspath(RESULTS))
    args = ap.parse_args(argv)
    ms = tuple(int(x) for x in args.mesh_shape.split(",")) if args.mesh_shape else None
    try:
        for v in args.variant or ["baseline"]:
            run(args.arch, args.shape, v, outdir=args.outdir, mesh_shape=ms)
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
