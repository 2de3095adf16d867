"""Multi-pod dry run: trace every (arch x shape x mesh) cell.

Port of ``repro.launch.dryrun``. The reference lowers and compiles each
cell's step with XLA on 512 placeholder devices. The port starts a fake
process group of 256 or 512 ranks (``launch.mesh.start_fake_world``;
its collectives move nothing), places the cell's parameters, optimizer
state, inputs and cache on the production mesh as fake ``DTensor``s (no
storage, ``sharding.tree_shape_dtypes``), and runs the train step,
prefill or decode step once under ``FakeTensorMode`` and
``roofline.analysis.Trace``, which counts rank 0's share. The
hand-written kernels launch nothing on fake tensors under the trace:
their wrappers report each call's operations and bytes instead, so the
records account for the card's kernels and not their plain versions
(whose temporaries, such as attention's full score matrix, the kernels
never hold). Importing this module starts no process group.

Per cell this prints and records:
  * memory: argument, output and temp bytes a device (proves it fits)
  * FLOPs and bytes accessed a device, for the roofline
  * the collectives, by the reference's five names

Records land in ``results/dryrun_torch/<cell>.json`` (resumable: existing
records are skipped unless --force; an error is recorded, not raised).
``--roofline`` adds the roofline terms of the cell's trace.

The mesh's tensors are CUDA tensors where torch has a card, CPU tensors
otherwise (``launch.mesh.fake_device_type``): a CPU-only build of torch
cannot differentiate fake CUDA tensors. Either way the kernels'
accounting is the card's.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --roofline
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from repro_torch.configs import ARCHS, SHAPES, cell_applicable, get_config, get_shape
from repro_torch.distributed.sharding import (
    SERVE_RULES, TRAIN_RULES, tree_shape_dtypes,
)
from repro_torch.launch.mesh import (
    PRODUCTION_SHAPES, make_production_mesh, mesh_chip_count, start_fake_world,
)
from repro_torch.models.layers import ShardCtx
from repro_torch.models.params import distribute_params, param_leaves
from repro_torch.models.registry import model_api
from repro_torch.optim import AdamW
from repro_torch.roofline import analysis

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")

BIG_MODEL_PARAMS = 100e9    # above this, optimizer moments go bf16
HUGE_MODEL_PARAMS = 250e9   # above this, Adafactor (factored second moment)


def choose_optimizer(cfg):
    from repro_torch.optim import Adafactor

    n = model_api(cfg).param_count(cfg)
    if n > HUGE_MODEL_PARAMS:
        return Adafactor()
    return AdamW(moment_dtype="bfloat16" if n > BIG_MODEL_PARAMS else "float32")


def train_overrides(cfg, shape):
    """Per-cell memory-fit knobs: 8 microbatches for a train cell at
    d_model >= 2048. grad_accum == 0 is the explicit "forced off" sentinel
    used by the roofline unit traces (make_train_step treats it as 1)."""
    if shape.kind == "train" and cfg.d_model >= 2048 and cfg.grad_accum == 1:
        return dataclasses.replace(cfg, grad_accum=8)
    return cfg


def rules_for(shape):
    return TRAIN_RULES if shape.kind == "train" else SERVE_RULES


def fake_mode():
    """A fresh ``FakeTensorMode`` for one cell."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    return FakeTensorMode(allow_non_fake_inputs=True)


@dataclasses.dataclass
class Lowered:
    """A cell ready to trace: its step, the step's placed fake arguments,
    the tensors that count as arguments, and the mode they were made in
    (the reference's ``jax.stages.Lowered``)."""

    step: object
    args: tuple
    arg_tensors: list
    mode: object


def lower_cell(cfg, shape, mesh, *, rules=None, opt=None) -> Lowered:
    """The cell's step on placed fake arguments: parameters by
    ``param_logical``, and for a train cell the optimizer state by
    ``state_logical`` (``choose_optimizer``'s, unless ``opt``), for a
    decode cell the cache by ``cache_logical``; the inputs by
    ``input_specs``."""
    cfg = train_overrides(cfg, shape)
    api = model_api(cfg)
    rules = rules or rules_for(shape)
    ctx = ShardCtx(mesh, rules)
    mode = fake_mode()
    with mode:
        pshapes, plogical = api.param_shapes(cfg), api.param_logical(cfg)
        params = api.Model(cfg, device=mesh.device_type)
        distribute_params(params, pshapes, plogical, rules, mesh)
        inputs = api.input_specs(cfg, shape, mesh, rules)
        tensors = [*params.parameters(), *inputs.values()]
        if shape.kind == "train":
            opt = opt or choose_optimizer(cfg)
            ostate = tree_shape_dtypes(
                opt.state_shapes(dict(param_leaves(pshapes))),
                opt.state_logical(dict(param_leaves(plogical))), rules, mesh)
            return Lowered(api.make_train_step(cfg, opt, ctx),
                           (params, ostate, inputs), [*tensors, ostate], mode)
        if shape.kind == "prefill":
            return Lowered(lambda p, b: api.prefill(cfg, p, b, ctx),
                           (params, inputs), tensors, mode)
        cshapes = api.cache_shapes(cfg, shape.global_batch, shape.seq_len)
        cache = tree_shape_dtypes(cshapes, api.cache_logical(cfg), rules, mesh)
        return Lowered(lambda p, c, b: api.decode_step(cfg, p, c, b, ctx),
                       (params, cache, inputs), [*tensors, cache], mode)


def compile_cell(cfg, shape, mesh, *, opt=None):
    """(CostSample, times) of one traced step (a train cell's under
    ``opt``, else ``choose_optimizer``'s). The reference's
    ``default_group`` (a group size for HLO without replica groups) has no
    use here: the trace reads each collective's group."""
    t0 = time.time()
    lowered = lower_cell(cfg, shape, mesh, opt=opt)
    t1 = time.time()
    trace = analysis.Trace()
    with lowered.mode:
        trace.arguments(lowered.arg_tensors)
        with trace:
            out = lowered.step(*lowered.args)
        t2 = time.time()
        if shape.kind == "train":   # the module, updated in place
            out = (list(out[0].parameters()), *out[1:])
        sample = analysis.CostSample.from_trace(trace, out,
                                                compile_seconds=t2 - t1)
    sample.mem["kernels"] = dict(trace.kernels)
    return sample, {"lower_s": t1 - t0, "compile_s": t2 - t1}


def mesh_for(mesh_kind: str):
    """The production mesh of ``mesh_kind``, over a fake world of its size."""
    multi = mesh_kind == "multipod"
    n = 1
    for s in PRODUCTION_SHAPES[multi][0]:
        n *= s
    start_fake_world(n)
    return make_production_mesh(multi_pod=multi)


def run_cell(arch: str, shape_name: str, mesh_kind: str, *, roofline: bool,
             outdir: str, force: bool = False) -> dict:
    cfg, shape = get_config(arch), get_shape(shape_name)
    cell_id = f"{arch}__{shape_name}__{mesh_kind}"
    path = os.path.join(outdir, cell_id + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)

    ok, reason = cell_applicable(cfg, shape)
    record = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "applicable": ok, "reason": reason, "status": "skipped" if not ok else None,
    }
    if ok:
        try:
            mesh = mesh_for(mesh_kind)
            chips = mesh_chip_count(mesh)
            sample, times = compile_cell(cfg, shape, mesh)
            record.update(
                status="ok",
                chips=chips,
                times=times,
                per_device={
                    "flops_scan_once": sample.flops,
                    "bytes_scan_once": sample.bytes_accessed,
                    "wire_bytes_scan_once": sample.wire_bytes,
                },
                memory=sample.mem,
                collectives=sample.collectives,
            )
            print(f"[{cell_id}] memory_analysis: {sample.mem}")
            print(f"[{cell_id}] cost_analysis: flops/dev={sample.flops:.3e} "
                  f"bytes/dev={sample.bytes_accessed:.3e}")
            colls = {k: v["count"] for k, v in sample.collectives.items() if v["count"]}
            print(f"[{cell_id}] collectives: {colls}")

            if roofline and mesh_kind == "singlepod":
                record["roofline"] = roofline_record(cfg, cfg, shape, sample,
                                                     chips)
                print(f"[{cell_id}] roofline terms: "
                      f"{record['roofline']['terms']}")
        except Exception as e:  # record failures — they are bugs to fix
            record.update(status="error", error=f"{type(e).__name__}: {e}",
                          trace=traceback.format_exc()[-4000:])
            print(f"[{cell_id}] ERROR {type(e).__name__}: {e}")

    os.makedirs(outdir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(record, f, indent=1, default=float)
    return record


def roofline_record(cfg, cfg0, shape, sample, chips: int) -> dict:
    """The record's "roofline" entry from the cell's own trace: totals a
    device, terms, MODEL_FLOPS (of ``cfg0``, the published config) and the
    useful ratio. The reference traces each family's ``roofline_units`` at
    the micro batch and scales by the microbatches, since XLA counts a
    scan body once; eager torch runs every layer and microbatch, so the
    cell's trace is the true step already (``delta_total`` over the units
    gives the same FLOPs, ``tests/test_torch_dryrun.py``)."""
    eff = train_overrides(cfg, shape)
    m = eff.grad_accum if (shape.kind == "train" and eff.grad_accum > 1) else 1
    totals = {"flops": sample.flops, "bytes": sample.bytes_accessed,
              "wire": sample.wire_bytes, "nvlink_wire": sample.nvlink_wire_bytes}
    terms = analysis.roofline_terms(totals["flops"], totals["bytes"],
                                    totals["wire"], totals["nvlink_wire"])
    terms["accum_factor"] = m
    mf = analysis.model_flops(cfg0, shape)
    total = totals["flops"] * chips
    return {"per_device": totals, "terms": terms, "model_flops": mf,
            "useful_ratio": mf / total if total else 0.0}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["singlepod", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--roofline", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--outdir", default=os.path.abspath(RESULTS_DIR))
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, each in a process of its own")
    args = ap.parse_args(argv)

    meshes = ["singlepod", "multipod"] if args.mesh == "both" else [args.mesh]
    archs = list(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    cells = [(arch, shape, mesh_kind) for arch in archs for shape in shapes
             for mesh_kind in meshes]
    kw = dict(roofline=args.roofline, outdir=args.outdir, force=args.force)

    if args.jobs > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        with ProcessPoolExecutor(args.jobs, mp_context=multiprocessing.get_context(
                "spawn")) as pool:
            records = list(pool.map(_run_cell_alone, cells, [kw] * len(cells)))
    else:
        try:
            records = [run_cell(*cell, **kw) for cell in cells]
        finally:
            _end_world()
    failures = sum(r.get("status") == "error" for r in records)
    print(f"dry-run complete; failures={failures}")
    raise SystemExit(1 if failures else 0)


def _end_world() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def _run_cell_alone(cell, kw) -> dict:
    """``run_cell`` in a worker process of ``--jobs``, its fake world
    ended after."""
    try:
        return run_cell(*cell, **kw)
    finally:
        _end_world()


if __name__ == "__main__":
    main()
