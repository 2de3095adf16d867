"""The port's dry run (``launch/dryrun.py``, ``launch/perf.py``,
``roofline/``, ``input_specs``, ``roofline_units``, ``tree_shape_dtypes``,
``make_production_mesh``) against the JAX package's.

The traces run in one subprocess (this file run as a script: a fake
process group, whose size changes between cases, must not leak into the
test process), which writes every case's numbers to a JSON file:

* the reference's ``tests/test_dryrun_subprocess.py`` case: smollm-135m
  with 4 layers, ``train_4k`` at B 16 and S 1024, on a (4, 4) fake mesh:
  FLOPs, a gradient all-reduce among the collectives, wire bytes and
  temporaries;
* per-device FLOPs: a (256, 4096) @ (4096, 4096) product, rows over
  "data" and columns over "model" of a (16, 16) fake mesh, counts rank
  0's 2 * 16 * 4096 * 256, not the global product's 256 times as much;
* no kernel under fake tensors: with ``_build.load`` replaced by a
  function that raises, a moe, ssm, hybrid and encdec train, prefill and
  decode cell (reduced) trace on a fake (4, 4) mesh; the kernels' calls
  are counted by the trace, nothing is built or launched;
* ``delta_total`` over ``roofline_units`` equals the whole trace's FLOPs
  (within 1e-9) for a dense, an ssm and a moe config, grad_accum off;
* ``make_production_mesh``'s (16, 16) and (2, 16, 16) meshes;
* the CLIs end to end on reduced configs: ``dryrun.main`` with
  --roofline on the single-pod mesh, ``report``'s tables of its records,
  and ``perf.main`` with a variant on a (4, 4) mesh.

A CPU-only build of torch cannot differentiate (nor copy) fake CUDA
tensors, so the cells trace fake CPU tensors here
(``mesh.fake_device_type``); the wrappers take their kernels' path for a
fake tensor of any device under the trace, and the product above and
the refusals below use fake CUDA tensors. In-process, the analytic parts are held equal to the
reference's for every arch and shape (``model_flops``, ``input_specs``,
``roofline_units``, ``choose_optimizer``, ``train_overrides``,
``VARIANTS``, ``wire_multiplier``, ``delta_total``, ``roofline_terms``
under equal constants, the report's tables), a fake or meta tensor
handed to any kernel wrapper raises, and the reference's fp8 KV-cache
test (``tests/test_perf_variants.py``) runs through perf.py's
``cache_fp8`` and ``ep2d_fp8`` variants against the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TIMEOUT_S = 400
FAMILY_CELLS = ("grok-1-314b", "mamba2-370m", "recurrentgemma-9b",
                "whisper-small")
DELTA_ARCHS = ("smollm-135m", "mamba2-370m", "grok-1-314b")


# --------------------------------------------------------------------------- #
# the subprocess                                                              #
# --------------------------------------------------------------------------- #
def _small_cell(out):
    from repro_torch.configs import get_config, get_shape
    from repro_torch.launch.dryrun import compile_cell
    from repro_torch.launch.mesh import make_fake_mesh, start_fake_world

    start_fake_world(16)
    mesh = make_fake_mesh((4, 4))
    cfg = dataclasses.replace(get_config("smollm-135m"), num_layers=4)
    shape = dataclasses.replace(get_shape("train_4k"), global_batch=16,
                                seq_len=1024)
    sample, _ = compile_cell(cfg, shape, mesh)
    out["small_cell"] = {
        "temp": sample.mem["temp_bytes"], "flops": sample.flops,
        "n_allreduce": sample.collectives["all-reduce"]["count"],
        "wire": sample.wire_bytes, "kernels": sample.mem["kernels"]}


def _per_device_flops(out):
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.dryrun import fake_mode
    from repro_torch.launch.mesh import make_fake_mesh, start_fake_world
    from repro_torch.roofline.analysis import Trace

    start_fake_world(256)
    mesh = make_fake_mesh((16, 16), device_type="cuda")
    with fake_mode():
        a = torch.empty(256 // 16, 4096, device="cuda")
        b = torch.empty(4096, 4096 // 16, device="cuda")
        A = DTensor.from_local(a, mesh, [Shard(0), Replicate()],
                               run_check=False)
        Bt = DTensor.from_local(b, mesh, [Replicate(), Shard(1)],
                                run_check=False)
        trace = Trace()
        with trace:
            C = A @ Bt
        out["per_device_flops"] = {"flops": trace.flops,
                                   "shape": list(C.shape),
                                   "local": list(C.to_local().shape)}


def _no_kernels(out):
    from repro_torch.configs import get_config, get_shape
    from repro_torch.kernels import _build
    from repro_torch.launch.dryrun import compile_cell
    from repro_torch.launch.mesh import make_fake_mesh, start_fake_world

    built = []

    def refuse(name):
        built.append(name)
        raise RuntimeError(f"the dry run built {name}")

    _build.load = refuse
    start_fake_world(16)
    mesh = make_fake_mesh((4, 4))
    out["no_kernels"] = {}
    for arch in FAMILY_CELLS:
        cfg = get_config(arch).reduce_for_smoke()
        for name in ("train_4k", "prefill_32k", "decode_32k"):
            shape = dataclasses.replace(get_shape(name), global_batch=8,
                                        seq_len=64)
            sample, _ = compile_cell(cfg, shape, mesh)
            out["no_kernels"][f"{arch}:{name}"] = {
                "flops": sample.flops, "kernels": sample.mem["kernels"],
                "temp": sample.mem["temp_bytes"]}
    out["built"] = built


def _delta_identity(out):
    from repro_torch.configs import get_config, get_shape
    from repro_torch.launch.dryrun import compile_cell
    from repro_torch.launch.mesh import make_fake_mesh, start_fake_world
    from repro_torch.models.registry import model_api
    from repro_torch.roofline import analysis

    start_fake_world(16)
    mesh = make_fake_mesh((4, 4))
    shape = dataclasses.replace(get_shape("train_4k"), global_batch=8,
                                seq_len=64)
    out["delta"] = {}
    for arch in DELTA_ARCHS:
        cfg = dataclasses.replace(get_config(arch).reduce_for_smoke(),
                                  num_layers=3, grad_accum=0)
        whole, _ = compile_cell(cfg, shape, mesh)
        base, units = model_api(cfg).roofline_units(cfg)
        base_s = compile_cell(dataclasses.replace(base, grad_accum=0), shape,
                              mesh)[0]
        unit_s = [(c, compile_cell(dataclasses.replace(u, grad_accum=0),
                                   shape, mesh)[0]) for c, u in units]
        totals = analysis.delta_total(base_s, unit_s)
        out["delta"][arch] = {"whole": whole.flops,
                              "delta": totals["flops"],
                              "whole_bytes": whole.bytes_accessed,
                              "delta_bytes": totals["bytes"]}


def _production_meshes(out):
    from repro_torch.launch.mesh import make_production_mesh, start_fake_world

    out["meshes"] = {}
    for multi, n in ((False, 256), (True, 512)):
        start_fake_world(n)
        mesh = make_production_mesh(multi_pod=multi)
        out["meshes"][str(multi)] = {"shape": list(mesh.shape),
                                     "names": list(mesh.mesh_dim_names)}


def _clis(out, tmp):
    from repro_torch import configs
    from repro_torch.launch import dryrun, perf
    from repro_torch.roofline import report

    def reduced(arch):
        return dataclasses.replace(configs.get_config(arch).reduce_for_smoke(),
                                   num_layers=2)

    dryrun.get_config = perf.get_config = reduced
    outdir = os.path.join(tmp, "dryrun")
    try:
        dryrun.main(["--arch", "smollm-135m", "--shape", "train_4k",
                     "--mesh", "singlepod", "--roofline", "--outdir", outdir])
    except SystemExit as e:
        out["dryrun_exit"] = e.code
    recs = report.load(outdir)
    out["dryrun_records"] = recs
    out["report"] = {"dryrun": report.dryrun_table(recs),
                     "roofline": report.roofline_table(recs)}
    perf.main(["--arch", "grok-1-314b", "--shape", "decode_32k",
               "--variant", "ep2d_fp8", "--mesh-shape", "4,4",
               "--outdir", os.path.join(tmp, "perf")])
    with open(os.path.join(tmp, "perf",
                           "grok-1-314b__decode_32k__ep2d_fp8__mesh4x4.json")
              ) as f:
        out["perf"] = json.load(f)


def _main(tmp):
    torch.set_num_threads(1)
    out = {}
    for case in (_small_cell, _per_device_flops, _no_kernels,
                 _delta_identity, _production_meshes):
        case(out)
    _clis(out, tmp)
    with open(os.path.join(tmp, "results.json"), "w") as f:
        json.dump(out, f, default=float)


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("dryrun"))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, __file__, tmp], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=TIMEOUT_S)
    path = os.path.join(tmp, "results.json")
    assert proc.returncode == 0 and os.path.exists(path), \
        proc.stderr[-4000:]
    with open(path) as f:
        return json.load(f)


def test_dryrun_small_mesh(traced):
    rec = traced["small_cell"]
    assert rec["flops"] > 0
    assert rec["n_allreduce"] > 0     # DP gradient reduction exists
    assert rec["wire"] > 0
    assert rec["temp"] > 0
    assert rec["kernels"] == {"flash_attention": 8, "flash_attention_bwd": 4}


def test_flops_are_rank_zeros_share(traced):
    rec = traced["per_device_flops"]
    assert rec["shape"] == [256, 4096] and rec["local"] == [16, 256]
    assert rec["flops"] == 2 * 16 * 4096 * 256      # 3.36e7, not 8.59e9


# a layer's calls of each kernel in a train step (forward and gradient:
# the reduced configs run without remat), a prefill and a decode step
A_LAYER = {
    "grok-1-314b": {"train": {"flash_attention": 1, "flash_attention_bwd": 1,
                              "moe_router": 1, "moe_router_bwd": 1},
                    "prefill": {"flash_attention": 1, "moe_router": 1},
                    "decode": {"moe_router": 1}},
    "mamba2-370m": {"train": {"ssd": 1, "ssd_bwd": 1},
                    "prefill": {"ssd": 1}, "decode": {}},
}


@pytest.mark.parametrize("cell", [f"{a}:{s}" for a in FAMILY_CELLS
                                  for s in ("train_4k", "prefill_32k",
                                            "decode_32k")])
def test_cells_trace_without_building_a_kernel(traced, cell):
    from repro_torch.configs import get_config

    assert traced["built"] == []
    rec = traced["no_kernels"][cell]
    assert rec["flops"] > 0
    arch, shape = cell.split(":")
    kind = shape.split("_")[0]
    if arch in A_LAYER:
        layers = get_config(arch).reduce_for_smoke().num_layers
        assert rec["kernels"] == {k: layers * v for k, v in
                                  A_LAYER[arch][kind].items()}
    elif kind != "decode":
        assert rec["kernels"], cell


@pytest.mark.parametrize("arch", DELTA_ARCHS)
def test_delta_units_add_up_to_the_whole_trace(traced, arch):
    rec = traced["delta"][arch]
    assert rec["whole"] > 0
    assert abs(rec["delta"] - rec["whole"]) <= 1e-9 * rec["whole"]


def test_production_meshes(traced):
    assert traced["meshes"] == {
        "False": {"shape": [16, 16], "names": ["data", "model"]},
        "True": {"shape": [2, 16, 16], "names": ["pod", "data", "model"]}}


def test_production_mesh_needs_its_world():
    from repro_torch.launch.mesh import make_production_mesh

    with pytest.raises(RuntimeError, match="256 ranks"):
        make_production_mesh()


def test_dryrun_cli_records_and_report(traced):
    assert traced["dryrun_exit"] == 0
    rec = traced["dryrun_records"]["smollm-135m__train_4k__singlepod"]
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert rec["per_device"]["flops_scan_once"] > 0
    assert rec["memory"]["temp_bytes"] > 0
    roof = rec["roofline"]
    assert roof["terms"]["dominant"] in ("compute_s", "memory_s",
                                         "collective_s")
    assert roof["model_flops"] > 0 and roof["useful_ratio"] > 0
    table = traced["report"]["dryrun"]
    assert len(table) == 3 and table[2].startswith(
        "| smollm-135m | train_4k | singlepod | ok |")
    assert traced["report"]["roofline"][2].startswith(
        "| smollm-135m | train_4k |")


def test_perf_cli_variant_on_a_mesh(traced):
    rec = traced["perf"]
    assert rec["variant"] == "ep2d_fp8" and rec["mesh_shape"] == [4, 4]
    assert rec["per_device"]["flops"] > 0
    assert set(rec["terms"]) >= {"compute_s", "memory_s", "collective_s",
                                 "dominant", "roofline_fraction",
                                 "accum_factor"}


# --------------------------------------------------------------------------- #
# in-process: the analytic parts against the reference                        #
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from repro import configs
    from repro.models.registry import model_api
    from repro.roofline import analysis, report

    # the reference's launch modules set XLA_FLAGS on import; read their
    # pure parts from the source instead
    def module(name):
        path = os.path.join(ROOT, "src", "repro", "launch", f"{name}.py")
        src = open(path).read()
        mod = types.ModuleType(f"ref_{name}")
        mod.__dict__["__file__"] = path
        env = dict(os.environ)
        try:
            exec(compile(src, path, "exec"), mod.__dict__)
        finally:
            os.environ.clear()
            os.environ.update(env)
        return mod

    return types.SimpleNamespace(jax=jax, configs=configs,
                                 model_api=model_api, analysis=analysis,
                                 report=report, dryrun=module("dryrun"),
                                 perf=module("perf"))


def _cells():
    from repro_torch.configs import ARCHS, SHAPES
    return [(a, s) for a in ARCHS for s in SHAPES]


def _fields(cfg) -> dict:
    return {k: v for k, v in dataclasses.asdict(cfg).items()}


@pytest.mark.parametrize("arch,shape", _cells())
def test_analytic_parts_match_the_reference(jx, arch, shape):
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.models.registry import model_api
    from repro_torch.roofline import analysis

    cfg, sh = configs.get_config(arch), configs.get_shape(shape)
    jcfg, jsh = jx.configs.get_config(arch), jx.configs.get_shape(shape)
    assert analysis.model_flops(cfg, sh) == jx.analysis.model_flops(jcfg, jsh)
    got = model_api(cfg).input_specs(cfg, sh)
    want = jx.model_api(jcfg).input_specs(jcfg, jsh)
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
    pbase, punits = model_api(cfg).roofline_units(cfg)
    jbase, junits = jx.model_api(jcfg).roofline_units(jcfg)
    assert _fields(pbase) == _fields(jbase)
    assert [(c, _fields(u)) for c, u in punits] == [
        (c, _fields(u)) for c, u in junits]
    po, jo = dryrun.choose_optimizer(cfg), jx.dryrun.choose_optimizer(jcfg)
    assert type(po).__name__ == type(jo).__name__
    assert getattr(po, "moment_dtype", None) == getattr(jo, "moment_dtype",
                                                        None)
    assert _fields(dryrun.train_overrides(cfg, sh)) == _fields(
        jx.dryrun.train_overrides(jcfg, jsh))
    assert dryrun.rules_for(sh).name == jx.dryrun.rules_for(jsh).name


@pytest.mark.parametrize("arch", sorted(
    __import__("repro_torch.configs", fromlist=["ARCHS"]).ARCHS))
def test_variants_match_the_reference(jx, arch):
    from repro_torch import configs
    from repro_torch.launch import perf

    assert sorted(perf.VARIANTS) == sorted(jx.perf.VARIANTS)
    cfg, jcfg = configs.get_config(arch), jx.configs.get_config(arch)
    for name, fn in perf.VARIANTS.items():
        assert _fields(fn(cfg)) == _fields(jx.perf.VARIANTS[name](jcfg)), name


def test_wire_multiplier_delta_total_and_terms_match_the_reference(
        jx, monkeypatch):
    from repro_torch.roofline import analysis, hw

    assert analysis.COLLECTIVE_OPS == jx.analysis.COLLECTIVE_OPS
    for op in analysis.COLLECTIVE_OPS:
        for n in (0, 1, 2, 4, 16, 256, 512):
            assert analysis.wire_multiplier(op, n) == \
                jx.analysis.wire_multiplier(op, n)
    ref_fields = {f.name for f in dataclasses.fields(jx.analysis.CostSample)}
    assert ref_fields <= {f.name for f in dataclasses.fields(
        analysis.CostSample)}
    nums = [(3.0e12, 2.0e11, 5.0e9), (3.5e12, 2.5e11, 6.0e9),
            (4.25e12, 2.25e11, 5.5e9)]
    mk = [(analysis.CostSample, jx.analysis.CostSample)]
    p = [mk[0][0](flops=f, bytes_accessed=b, wire_bytes=w) for f, b, w in nums]
    j = [mk[0][1](flops=f, bytes_accessed=b, wire_bytes=w) for f, b, w in nums]
    got = analysis.delta_total(p[0], [(12, p[1]), (3, p[2])])
    want = jx.analysis.delta_total(j[0], [(12, j[1]), (3, j[2])])
    assert got == want
    colls = {op: {"count": 1, "result_bytes": 8.0, "wire_bytes": 3.0 * i}
             for i, op in enumerate(analysis.COLLECTIVE_OPS)}
    assert analysis.total_wire_bytes(colls) == \
        jx.analysis.total_wire_bytes(colls)
    from repro.roofline import hw as jhw
    monkeypatch.setattr(hw, "PEAK_FLOPS_BF16", jhw.PEAK_FLOPS_BF16)
    monkeypatch.setattr(hw, "HBM_BW", jhw.HBM_BW)
    monkeypatch.setattr(hw, "HOST_LINK_BW", jhw.ICI_BW_PER_LINK)
    for f, b, w in nums + [(0.0, 0.0, 0.0), (1e9, 1e15, 1e3)]:
        assert analysis.roofline_terms(f, b, w) == \
            jx.analysis.roofline_terms(f, b, w)


def test_report_tables_match_the_reference(jx, tmp_path):
    from repro_torch.roofline import report

    recs = {}
    for i, (arch, shape) in enumerate(_cells()):
        for mesh in ("singlepod", "multipod"):
            r = {"arch": arch, "shape": shape, "mesh": mesh}
            if shape == "long_500k":
                r.update(status="skipped", reason="skipped(full-attention)")
            elif i % 7 == 3:
                r.update(status="error", error="RuntimeError: boom " * 9)
            else:
                r.update(status="ok", memory={
                    "argument_bytes": 1e9 * i, "temp_bytes": 2.5e9 + i},
                    per_device={"flops_scan_once": 1.5e12 * (i + 1)},
                    collectives={"all-reduce": {"count": i % 3},
                                 "all-gather": {"count": 2}},
                    roofline={"terms": {"compute_s": 0.1 * i,
                                        "memory_s": 0.2,
                                        "collective_s": 0.05 * i,
                                        "dominant": "memory_s",
                                        "roofline_fraction": 0.5},
                              "model_flops": 1e15, "useful_ratio": 0.25})
            recs[f"{arch}__{shape}__{mesh}"] = r
            with open(tmp_path / f"{arch}__{shape}__{mesh}.json", "w") as f:
                json.dump(r, f)
    assert report.load(str(tmp_path)) == jx.report.load(str(tmp_path))
    assert report.dryrun_table(recs) == jx.report.dryrun_table(recs)
    assert report.roofline_table(recs) == jx.report.roofline_table(recs)
    assert report.LEVERS == jx.report.LEVERS


def test_tree_shape_dtypes_and_input_specs_place_fake_blocks():
    """On a one-rank fake world, in process: placed fake DTensors of the
    global shapes whose blocks have no storage."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensor

    from repro_torch.configs import get_config, get_shape
    from repro_torch.distributed.sharding import TRAIN_RULES
    from repro_torch.launch.dryrun import fake_mode
    from repro_torch.launch.mesh import make_fake_mesh, start_fake_world
    from repro_torch.models.registry import model_api

    if dist.is_initialized():
        pytest.skip("a process group runs in this process")
    start_fake_world(1)
    try:
        mesh = make_fake_mesh((1, 1))
        cfg = get_config("whisper-small")
        with fake_mode():
            specs = model_api(cfg).input_specs(cfg, get_shape("train_4k"),
                                               mesh, TRAIN_RULES)
        assert set(specs) == {"frames", "tokens", "labels"}
        assert tuple(specs["frames"].shape) == (256, 1500, 768)
        assert specs["tokens"].dtype == torch.int32
        assert all(isinstance(t.to_local(), FakeTensor)
                   for t in specs.values())
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------------- #
# in-process: kernels refuse fake and meta tensors                            #
# --------------------------------------------------------------------------- #
def _wrapper_calls(device):
    from repro_torch.kernels import (decode_attention, flash_attention,
                                     hsv_color, moe_router, rglru, ssd)

    def t(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    i32 = torch.int32
    return {
        "hsv_color_hist": lambda: hsv_color.hsv_color_hist(
            t(2, 4, 4, 3), t(9, 6)),
        "moe_router_tk": lambda: moe_router.moe_router_tk(t(5, 8), 2),
        "moe_router_bwd": lambda: moe_router.moe_router_bwd(
            t(5, 2), t(5, 2, dtype=i32), t(5, 2), 8),
        "moe_router_tokens": lambda: moe_router.moe_router_tokens(
            t(2, 6, dtype=i32), t(16, 4), t(4, 8), 2),
        "ssd_bshp": lambda: ssd.ssd_bshp(t(2, 64, 2, 4), t(2, 64, 2), t(2),
                                         t(2, 64, 1, 4), t(2, 64, 1, 4),
                                         chunk=64),
        "ssd_bwd": lambda: ssd.ssd_bwd(t(2, 64, 2, 4), t(2, 64, 2), t(2),
                                       t(2, 64, 1, 4), t(2, 64, 1, 4), None,
                                       t(2, 64, 2, 4), None, chunk=64),
        "rglru_bsw": lambda: rglru.rglru_bsw(t(2, 6, 8), t(2, 6, 8),
                                             t(2, 6, 8), t(8), None),
        "rglru_bwd": lambda: rglru.rglru_bwd(t(2, 6, 8), t(2, 6, 8),
                                             t(2, 6, 8), t(8), None,
                                             t(2, 6, 8), t(2, 6, 8), None),
        "rglru_tokens": lambda: rglru.rglru_tokens(
            t(2, 6, dtype=i32), t(16, 8), t(16, 8), t(16, 8), t(8)),
        "flash_attention_bshd": lambda: flash_attention.flash_attention_bshd(
            t(2, 8, 4, 16), t(2, 8, 2, 16), t(2, 8, 2, 16)),
        "flash_attention_bwd": lambda: flash_attention._launch_bwd(
            t(8, 8, 16), t(8, 8, 16), t(8, 8, 16), t(8, 8, 16), t(8, 8, 16),
            t(8, 8), lambda x, kv: flash_attention.bhsd_layout(x, 1), 8, 1,
            1, 8, 8, True, 0, 0.25),
        "decode_attention_bshd": lambda: decode_attention.decode_attention_bshd(
            t(2, 4, 16), t(2, 6, 2, 16), t(2, 6, 2, 16),
            torch.tensor([3, 5], dtype=i32, device=device)),
    }


WRAPPERS = sorted(["hsv_color_hist", "moe_router_tk", "moe_router_bwd",
                   "moe_router_tokens", "ssd_bshp", "ssd_bwd", "rglru_bsw",
                   "rglru_bwd", "rglru_tokens", "flash_attention_bshd",
                   "flash_attention_bwd", "decode_attention_bshd"])


@pytest.mark.parametrize("name", WRAPPERS)
@pytest.mark.parametrize("kind", ["fake", "meta"])
def test_wrappers_refuse_fake_and_meta_tensors(name, kind, monkeypatch):
    from repro_torch.kernels import _build
    from repro_torch.launch.dryrun import fake_mode

    def refuse(lib):
        raise AssertionError(f"built {lib}")

    monkeypatch.setattr(_build, "load", refuse)
    if kind == "fake":
        with fake_mode():
            with pytest.raises(RuntimeError, match="fake or meta"):
                _wrapper_calls("cuda")[name]()
    else:
        with pytest.raises((RuntimeError, ValueError), match="meta"):
            _wrapper_calls("meta")[name]()


# --------------------------------------------------------------------------- #
# in-process: the fp8 KV cache variants                                       #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("variant", ["cache_fp8", "ep2d_fp8"])
def test_fp8_cache_decode_matches_the_reference(jx, variant):
    """The reference's ``test_fp8_cache_decode_close_to_bf16`` on llama3-8b
    reduced through perf.py's variant, in both packages on the JAX
    package's weights: the cache in float8_e4m3fn, the fp8 logits near the
    unquantised ones (the reference's bounds) and within TOL_TIGHT of the
    JAX package's fp8 logits."""
    from repro_torch import configs, convert
    from repro_torch.launch import perf
    from repro_torch.models.registry import model_api

    jax, jnp = jx.jax, jx.jax.numpy
    b, s = 2, 32
    jcfg = jx.configs.get_config("llama3-8b").reduce_for_smoke()
    pcfg = configs.get_config("llama3-8b").reduce_for_smoke()
    japi, papi = jx.model_api(jcfg), model_api(pcfg)
    jparams = japi.init_params(jcfg, jax.random.key(0))
    model = convert.model_params(jax.tree.map(np.asarray, jparams), pcfg,
                                 device="cpu")
    toks = (np.arange(b * s, dtype=np.int32).reshape(b, s)
            % pcfg.vocab_size)

    def jrun(c):
        cache, _ = japi.prefill(c, jparams, {"tokens": jnp.asarray(toks)},
                                pad_cache_to=s + 4)
        _, lg = japi.decode_step(c, jparams, cache,
                                 {"token": jnp.asarray(toks[:, -1])})
        return np.asarray(lg, np.float32)

    def prun(c):
        t = torch.from_numpy(toks)
        with torch.inference_mode():
            cache, _ = papi.prefill(c, model, {"tokens": t},
                                    pad_cache_to=s + 4)
            _, lg = papi.decode_step(c, model, cache, {"token": t[:, -1]})
        return lg.float().numpy(), cache

    ref_logits, _ = prun(pcfg)
    fp8_logits, fp8_cache = prun(perf.VARIANTS[variant](pcfg))
    assert fp8_cache["k"].dtype == torch.float8_e4m3fn
    np.testing.assert_allclose(fp8_logits, ref_logits, rtol=0.2, atol=0.5)
    assert (fp8_logits.argmax(-1) == ref_logits.argmax(-1)).mean() >= 0.5
    want = jrun(jx.perf.VARIANTS[variant](jcfg))
    np.testing.assert_allclose(fp8_logits, want, rtol=1e-4, atol=1e-5)


if __name__ == "__main__":
    _main(sys.argv[1])
