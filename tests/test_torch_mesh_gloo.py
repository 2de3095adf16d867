"""The port's sharding on real meshes of 4 gloo processes on the CPU,
held against the JAX package on the same weights and inputs.

The test process draws every case's weights with the JAX package
(``init_params``), writes them for the ranks to load through the port's
converter (``convert.model_params``), and computes the JAX package's
numbers on one device from the same weights and numpy-seeded inputs:
each family's loss, three train steps of its ``build`` (loss, grad_norm
and the change of every parameter), and the decode logits. Each rank
runs the port's sharded path (``ShardCtx`` with ``DTensor`` parameters
and batches, ``launch.train.build(cfg, mesh)``, the sequence-sharded
decode, moe's resident-expert decode) on those weights, and also the
port's single-process path, which narrows a failure down to the mesh.
The bounds are the JAX package's for its own sharded tests: the loss of
a (2, 2) mesh under ``TRAIN_RULES`` to rtol 2e-3, atol 1e-4
(``tests/test_perf_variants.py``), also for the train steps' loss and
grad_norm; ``seq_parallel`` against the loss without it to 1e-4 / 1e-5;
moe's ``ep2d`` decode to 5e-3 / 5e-3; a (1, 4) sequence-sharded decode
to 2e-3 / 2e-3 (``tests/test_dryrun_subprocess.py``). The change of a
parameter leaf over the train steps is held to 2e-3 of the change, in
L2 norm, at a learning rate (1e-2, no warm-up) where the change is far
above the parameters' rounding. (Element by element, AdamW's step of an
element whose gradient nearly cancels over the steps amplifies the
float32 rounding of the gradient: it differs by up to 5e-3 of the leaf's
largest change between two of the three runs, the JAX package's
included.) The compressed sum, batch placement, elastic restore, submesh
carving, a (1, 1) mesh's bit-equal steps and ``train_loop``'s resume on
the mesh need no JAX.

The cases run in one launch of 4 processes (this file run as a script,
one process a rank, a ``FileStore`` under the test's temporary directory:
no port) under a timeout; the JAX numbers are computed while it runs.
Rank 0 writes every case's result to a JSON file, and its arrays to
``.npz`` files, that the tests read.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import traceback

import numpy as np
import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
WORLD = 4
LAUNCH_TIMEOUT_S = 150

LOSS_ARCHS = ("smollm-135m", "llava-next-34b", "mamba2-370m",
              "recurrentgemma-9b", "whisper-small", "grok-1-314b")
TRAIN_ARCHS = ("smollm-135m", "mamba2-370m", "recurrentgemma-9b",
               "whisper-small")
SP_ARCH, DECODE_ARCH, MOE_ARCH = "llama3-8b", "smollm-135m", "arctic-480b"
MOE_TRAIN_ARCH, MOE_TRAIN_STEPS = "grok-1-314b", 2
# heads a (1, 4) mesh's model axis does not divide: the projections run on
# each rank's rows with the whole weight (attention.head_proj, out_proj)
ODD_ARCH, ODD_HEADS = "whisper-small", dict(num_heads=6, num_kv_heads=3)
WEIGHT_ARCHS = sorted(set(LOSS_ARCHS + TRAIN_ARCHS
                          + (SP_ARCH, DECODE_ARCH, MOE_ARCH, MOE_TRAIN_ARCH)))
B, S = 4, 16
SP_SHAPE = (4, 32)
TRAIN_LR, TRAIN_STEPS = 1e-2, 3
DECODE_B, DECODE_S, DECODE_STEPS = 4, 32, 2
MOE_B, MOE_S = 4, 16

LOSS_TOL = dict(rtol=2e-3, atol=1e-4)
SP_TOL = dict(rtol=1e-4, atol=1e-5)
DECODE_TOL = dict(rtol=2e-3, atol=2e-3)
MOE_TOL = dict(rtol=5e-3, atol=5e-3)
DELTA_RTOL = 2e-3   # of a parameter leaf's change over the steps (L2 norms)


def _np_batch(cfg, b, s, seed=0):
    """Tokens and labels (and a vlm's patches, an encdec's frames) from a
    numpy seed; ``cfg`` either package's config."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(b, s + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (b, cfg.num_patches, 1024)).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (b, cfg.num_frames, cfg.d_model)).astype(np.float32)
    return {k: np.ascontiguousarray(v) for k, v in out.items()}


def _decode_tokens(vocab, b, s):
    return (np.arange(b * s).reshape(b, s) % vocab).astype(np.int32)


def _close(got, want, rtol, atol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    ok = bool(np.allclose(got, want, rtol=rtol, atol=atol))
    return {"ok": ok, "max_abs_err": err}


def _deltas_close(got, want):
    """(ok, the worst leaf's error norm over its change's norm): each
    leaf's change within DELTA_RTOL of its own norm. A parameter whose
    update was dropped, or applied on some ranks' blocks only, is off by
    most of its change."""
    ok, worst = sorted(got) == sorted(want), 0.0
    for k in want:
        g, w = np.asarray(got[k], np.float64), np.asarray(want[k], np.float64)
        if g.shape != w.shape:
            return False, float("inf")
        err, norm = float(np.linalg.norm(g - w)), float(np.linalg.norm(w))
        ok &= err <= DELTA_RTOL * norm
        worst = max(worst, err / norm if norm else err)
    return bool(ok), worst


# --------------------------------------------------------------------------- #
# the ranks' side                                                              #
# --------------------------------------------------------------------------- #
def _batch(cfg, b, s, seed=0):
    """``_np_batch`` as plain CPU tensors."""
    import torch

    return {k: torch.from_numpy(v) for k, v in _np_batch(cfg, b, s,
                                                           seed).items()}


def _cfg(arch, **changes):
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch).reduce_for_smoke(), **changes)


def _model(arch, outdir, tag="", **changes):
    """The port's module of ``arch`` reduced (then ``changes``), on the JAX
    package's weights that the test process wrote
    (``convert.model_params``)."""
    from repro_torch import convert

    with np.load(os.path.join(outdir, f"weights_{arch}{tag}.npz")) as f:
        return convert.model_params(dict(f), _cfg(arch, **changes),
                                    device="cpu")


def _place_model(model, cfg, rules, mesh):
    from repro_torch.models.params import distribute_params
    from repro_torch.models.registry import model_api

    api = model_api(cfg)
    return distribute_params(model, api.param_shapes(cfg),
                             api.param_logical(cfg), rules, mesh)


def _loss(cfg, model, batch, ctx):
    """The reference's ``loss_fn`` (for moe: task + AUX_LOSS_COEF * aux)."""
    from repro_torch.distributed.sharding import plain
    from repro_torch.models import moe
    from repro_torch.models.layers import NULL_CTX, softmax_xent
    from repro_torch.models.registry import model_api

    if cfg.family != "moe":
        return float(plain(model_api(cfg).loss_fn(cfg, model, batch, ctx)[0]))
    logits, aux = moe.forward(cfg, model, batch, ctx)
    with ctx.scope():
        task = softmax_xent(logits, batch["labels"])
    if ctx is NULL_CTX:
        return float(task + moe.AUX_LOSS_COEF * aux)
    return float(plain(task) + moe.AUX_LOSS_COEF * plain(aux))


def _case_loss(arch, mesh, outdir):
    from repro_torch.distributed.sharding import TRAIN_RULES, distribute
    from repro_torch.models.layers import NULL_CTX, ShardCtx

    cfg = _cfg(arch)
    model, batch = _model(arch, outdir), _batch(cfg, B, S)
    single = _loss(cfg, model, batch, NULL_CTX)
    _place_model(model, cfg, TRAIN_RULES, mesh)
    placed = {k: distribute(v, "batch" + " ." * (v.dim() - 1), TRAIN_RULES,
                            mesh) for k, v in batch.items()}
    got = _loss(cfg, model, placed, ShardCtx(mesh, TRAIN_RULES))
    sharded = sum(any(p.is_shard() for p in t.placements)
                  for t in model.parameters())
    return dict(_close(got, single, **LOSS_TOL), got=got, single=single,
                sharded_params=sharded)


def _case_moe_train(mesh, outdir):
    """The reference's sharded moe train path (its
    ``test_moe_train_sharded_matches_single_subprocess``): ``loss_fn`` of
    grok-1 reduced on a (2, 2) mesh under TRAIN_RULES (EP over "model")
    against one process's; then MOE_TRAIN_STEPS steps of ``build(cfg,
    mesh)``, whose gradients pass the expert sum's and the aux loss's
    collectives: finite losses and gradient norms, the first step's loss
    (the task loss, as the reference's step reports it) that
    ``loss_fn``'s."""
    from repro_torch.distributed.sharding import TRAIN_RULES, distribute, plain
    from repro_torch.launch.train import build, place
    from repro_torch.models.layers import ShardCtx
    from repro_torch.models.params import stacked
    from repro_torch.models.registry import model_api

    cfg = _cfg(MOE_TRAIN_ARCH)
    api = model_api(cfg)
    model, batch = _model(MOE_TRAIN_ARCH, outdir), _batch(cfg, B, S)
    value, parts = api.loss_fn(cfg, model, batch)
    single, task = float(value), float(parts["loss"])
    _place_model(model, cfg, TRAIN_RULES, mesh)
    placed = {k: distribute(v, "batch .", TRAIN_RULES, mesh)
              for k, v in batch.items()}
    got = float(plain(api.loss_fn(cfg, model, placed,
                                  ShardCtx(mesh, TRAIN_RULES))[0]))
    _, opt, step = build(cfg, mesh, lr=TRAIN_LR, warmup=0)
    model = _model(MOE_TRAIN_ARCH, outdir)
    state = opt.init(stacked(model, api.param_shapes(cfg)))
    model, state = place(cfg, opt, mesh, model, state)
    steps = []
    for i in range(MOE_TRAIN_STEPS):
        model, state, mt = step(model, state, _batch(cfg, B, S, seed=i))
        steps.append([float(mt["loss"]), float(mt["grad_norm"])])
    out = _close(got, single, **LOSS_TOL)
    first = _close(steps[0][0], task, **LOSS_TOL)   # a step reports the task
    out.update(ok=out["ok"] and first["ok"] and bool(np.isfinite(steps).all()),
               got=got, single=single, task=task, steps=steps)
    return out


def _case_odd_heads(mesh, outdir):
    """whisper-small reduced with 6 heads on 3 kv heads on a (1, 4) mesh:
    ``loss_fn`` against one process's, and two steps of ``build(cfg,
    mesh)`` against the same steps in one process (loss, grad_norm)."""
    from repro_torch.distributed.sharding import TRAIN_RULES, distribute, plain
    from repro_torch.launch.train import build, place
    from repro_torch.models.layers import ShardCtx
    from repro_torch.models.params import stacked
    from repro_torch.models.registry import model_api

    cfg = _cfg(ODD_ARCH, **ODD_HEADS)
    api = model_api(cfg)

    def model():
        return _model(ODD_ARCH, outdir, "-odd", **ODD_HEADS)

    batch = _batch(cfg, B, S)
    m = model()
    single = float(api.loss_fn(cfg, m, batch)[0])
    _place_model(m, cfg, TRAIN_RULES, mesh)
    placed = {k: distribute(v, "batch" + " ." * (v.dim() - 1), TRAIN_RULES,
                            mesh) for k, v in batch.items()}
    got = float(plain(api.loss_fn(cfg, m, placed,
                                  ShardCtx(mesh, TRAIN_RULES))[0]))
    runs = []
    for on in (None, mesh):
        _, opt, step = build(cfg, on, lr=TRAIN_LR, warmup=0)
        m = model()
        state = opt.init(stacked(m, api.param_shapes(cfg)))
        m, state = place(cfg, opt, on, m, state)
        steps = []
        for i in range(2):
            m, state, mt = step(m, state, _batch(cfg, B, S, seed=i))
            steps.append([float(mt["loss"]), float(mt["grad_norm"])])
        runs.append(steps)
    out = _close(got, single, **LOSS_TOL)
    same = _close(runs[1], runs[0], **LOSS_TOL)
    out.update(ok=out["ok"] and same["ok"], got=got, single=single,
               steps=runs[1], single_steps=runs[0])
    return out


def _case_seq_parallel(mesh, outdir):
    from repro_torch.distributed.sharding import TRAIN_RULES, distribute
    from repro_torch.models.layers import ShardCtx

    cfg = _cfg(SP_ARCH)
    model, batch = _model(SP_ARCH, outdir), _batch(cfg, *SP_SHAPE)
    _place_model(model, cfg, TRAIN_RULES, mesh)
    batch = {k: distribute(v, "batch .", TRAIN_RULES, mesh)
             for k, v in batch.items()}
    ctx = ShardCtx(mesh, TRAIN_RULES)
    base = _loss(cfg, model, batch, ctx)
    sp = _loss(dataclasses.replace(cfg, seq_parallel=True), model, batch, ctx)
    return dict(_close(sp, base, **SP_TOL), got=sp, base=base)


def _train_run(arch, mesh, outdir):
    """TRAIN_STEPS steps of ``build(cfg, mesh, lr=TRAIN_LR, warmup=0)``
    from the JAX package's weights: ([[loss, grad_norm], ...], the change
    of every stacked parameter leaf)."""
    from repro_torch.distributed.sharding import plain
    from repro_torch.launch.train import build, place
    from repro_torch.models.params import stacked

    cfg = _cfg(arch)
    api, opt, step = build(cfg, mesh, lr=TRAIN_LR, warmup=0)
    shapes = api.param_shapes(cfg)
    model = _model(arch, outdir)
    before = {k: v.clone().numpy() for k, v in stacked(model, shapes).items()}
    state = opt.init(stacked(model, shapes))
    model, state = place(cfg, opt, mesh, model, state)
    metrics = []
    for i in range(TRAIN_STEPS):
        model, state, mt = step(model, state, _batch(cfg, B, S, seed=i))
        metrics.append([float(mt["loss"]), float(mt["grad_norm"])])
    after = {k: plain(v).numpy() for k, v in stacked(model, shapes).items()}
    return metrics, {k: after[k] - before[k] for k in before}


def _case_train_steps(arch, mesh, outdir):
    """The steps on the mesh against the same steps in one process; the
    arrays are the changes of the parameters, each run's."""
    single, d_single = _train_run(arch, None, outdir)
    got, d_got = _train_run(arch, mesh, outdir)
    out = _close(got, single, **LOSS_TOL)
    deltas_ok, worst = _deltas_close(d_got, d_single)
    out.update(ok=out["ok"] and deltas_ok, got=got, single=single,
               deltas_worst=worst,
               arrays={**{f"mesh:{k}": v for k, v in d_got.items()},
                       **{f"single:{k}": v for k, v in d_single.items()}})
    return out


def _case_shard_batch(mesh):
    from repro_torch.data.pipeline import TokenSource, shard_batch
    from repro_torch.distributed.sharding import TRAIN_RULES

    host = TokenSource(257, 16, seed=3).next(8)
    placed = shard_batch(host, mesh, TRAIN_RULES, device="cpu")
    rank = mesh.get_coordinate()[0]          # data coordinate
    ok = True
    for k, v in host.items():
        want = v[rank * 4:(rank + 1) * 4]
        ok &= bool(np.array_equal(placed[k].to_local().numpy(), want))
        ok &= tuple(placed[k].shape) == v.shape
    return {"ok": ok}


def _case_compressed_psum(mesh, rank):
    """Each rank's block summed over "data" by ``compressed_psum`` against
    the reference's formula evaluated in numpy over the ranks' inputs."""
    import torch

    from repro_torch.optim.compression import compressed_psum

    def block(r):
        return np.random.default_rng(100 + r).standard_normal(
            (6, 5)).astype(np.float32) * (r + 1)

    total, n = compressed_psum(torch.from_numpy(block(rank)), mesh, "data")
    coord = mesh.get_coordinate()
    peers = [int(r) for r in mesh.mesh[:, coord[1]]]
    xs = [block(r) for r in peers]
    scales = [np.float32(np.max(np.abs(x)) + np.float32(1e-12))
              / np.float32(127.0) for x in xs]
    gmax = np.float32(max(scales))
    qs = [np.round(x / gmax).astype(np.int32) for x in xs]
    want = sum(qs).astype(np.float32) * gmax
    ok = (np.array_equal(total.numpy(), want) and float(n) == len(peers))
    return {"ok": bool(ok), "max_abs_err":
            float(np.max(np.abs(total.numpy() - want)))}


def _case_decode_seqsharded(mesh, outdir):
    """Dense decode on a (1, 4) mesh, the cache's sequence over "model"."""
    import torch

    from repro_torch.distributed.sharding import SERVE_RULES, distribute, plain
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import ShardCtx

    cfg = _cfg(DECODE_ARCH)
    model, b, s = _model(DECODE_ARCH, outdir), DECODE_B, DECODE_S
    toks = torch.from_numpy(_decode_tokens(cfg.vocab_size, b,
                                           s + DECODE_STEPS))
    cache, _ = tf.prefill(cfg, model, {"tokens": toks[:, :s]},
                          pad_cache_to=s + 4)
    placed = {k: distribute(v.clone(), tf.cache_logical(cfg)[k], SERVE_RULES,
                            mesh) for k, v in cache.items()}
    single = []
    for i in range(DECODE_STEPS):
        cache, lg = tf.decode_step(cfg, model, cache, {"token": toks[:, s + i]})
        single.append(lg.numpy())
    _place_model(model, cfg, SERVE_RULES, mesh)
    ctx = ShardCtx(mesh, SERVE_RULES)
    got = []
    for i in range(DECODE_STEPS):
        placed, lg = tf.decode_step(cfg, model, placed,
                                    {"token": toks[:, s + i]}, ctx)
        got.append(plain(lg).numpy())
    out = _close(got, single, **DECODE_TOL)
    out.update(cache_seq_sharded=str(placed["k"].placements),
               arrays={"mesh": np.stack(got), "single": np.stack(single)})
    return out


def _case_moe_ep2d_decode(mesh, outdir):
    import torch

    from repro_torch.distributed.sharding import SERVE_RULES, distribute, plain
    from repro_torch.models import moe
    from repro_torch.models.layers import ShardCtx

    cfg = _cfg(MOE_ARCH)  # 4 experts, a dense residual
    model = _model(MOE_ARCH, outdir)
    toks = torch.from_numpy(_decode_tokens(cfg.vocab_size, MOE_B, MOE_S))
    cache, _ = moe.prefill(cfg, model, {"tokens": toks},
                           pad_cache_to=MOE_S + 4)
    placed = {k: distribute(v.clone(), moe.cache_logical(cfg)[k], SERVE_RULES,
                            mesh) for k, v in cache.items()}
    _, single = moe.decode_step(cfg, model, cache, {"token": toks[:, -1]})
    cfg2 = dataclasses.replace(cfg, moe_serve_ep2d=True)  # E=4 % data=2 == 0
    _place_model(model, cfg2, SERVE_RULES, mesh)
    _, got = moe.decode_step(cfg2, model, placed, {"token": toks[:, -1]},
                             ShardCtx(mesh, SERVE_RULES))
    got, single = plain(got).numpy(), single.numpy()
    out = _close(got, single, **MOE_TOL)
    out.update(expert_placements=str(model.layers[0]["e_gate"].placements),
               arrays={"mesh": got, "single": single})
    return out


def _case_checkpoint_remesh(mesh, mesh41, outdir):
    """Written on (2, 2), restored onto (4, 1): the same global values in
    the target's placements."""
    import torch

    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.distributed.sharding import TRAIN_RULES, distribute

    w = torch.arange(8 * 4, dtype=torch.float32).reshape(8, 4)
    src = {"w": distribute(w, "d_model_w vocab", TRAIN_RULES, mesh),
           "b": distribute(w[:, 0].to(torch.bfloat16), "batch", TRAIN_RULES,
                           mesh)}
    ck = Checkpointer(os.path.join(outdir, "ckpt"), async_save=False)
    ck.save(1, src)
    torch.distributed.barrier()
    target = {"w": distribute(torch.zeros(8, 4), "batch .", TRAIN_RULES,
                              mesh41),
              "b": distribute(torch.zeros(8, dtype=torch.bfloat16), "batch",
                              TRAIN_RULES, mesh41)}
    got = ck.restore(1, target)
    ck.close()
    ok = (got["w"].placements == target["w"].placements
          and got["w"].full_tensor().equal(w)
          and got["b"].full_tensor().equal(w[:, 0].to(torch.bfloat16))
          and got["w"].to_local().shape == (2, 4))
    return {"ok": bool(ok), "placements": str(got["w"].placements)}


def _case_one_rank_bit_equal(mesh11, rank, outdir):
    """On a (1, 1) mesh (rank 0's), TRAIN_STEPS dense train steps through
    ``build(cfg, mesh)`` are bit-equal to the same steps unsharded: the
    DTensor path runs the same operations on the whole tensors."""
    import torch

    from repro_torch.distributed.sharding import plain
    from repro_torch.launch.train import build, place
    from repro_torch.models.params import stacked

    if rank != 0:
        return {"ok": True}
    cfg = _cfg(DECODE_ARCH)
    runs = []
    for m in (None, mesh11):
        api, opt, step = build(cfg, m, lr=TRAIN_LR, warmup=0)
        model = _model(DECODE_ARCH, outdir)
        state = opt.init(stacked(model, api.param_shapes(cfg)))
        model, state = place(cfg, opt, m, model, state)
        metrics = []
        for i in range(TRAIN_STEPS):
            model, state, mt = step(model, state, _batch(cfg, B, S, seed=i))
            metrics.append(torch.stack([plain(mt["loss"]),
                                        plain(mt["grad_norm"])]))
        runs.append((metrics, {k: plain(v) for k, v in stacked(
            model, api.param_shapes(cfg)).items()}))
    (m0, p0), (m1, p1) = runs
    ok = all(a.equal(b) for a, b in zip(m0, m1))
    return {"ok": ok and all(p0[k].equal(p1[k]) for k in p0)}


def _case_resume(mesh, outdir):
    """``train_loop`` on the mesh with checkpoints, stopped after 4 steps
    and run again to 6: it resumes from step 4 (the optimizer's count a
    scalar again) and ends on the loss of 6 steps without a stop."""
    import torch

    from repro_torch.launch.train import train_loop

    cfg, ckpt = _cfg(DECODE_ARCH), os.path.join(outdir, "resume")
    kw = dict(batch=B, seq=S, mesh=mesh, device="cpu", log_every=100)
    train_loop(cfg, steps=4, ckpt_dir=ckpt, ckpt_every=2, **kw)
    torch.distributed.barrier()   # rank 0's checkpoint is on disk
    again = train_loop(cfg, steps=6, ckpt_dir=ckpt, ckpt_every=2, **kw)
    whole = train_loop(cfg, steps=6, **kw)
    out = _close(again["final_loss"], whole["final_loss"], rtol=1e-4,
                 atol=1e-5)
    out["ok"] &= len(again["losses"]) == 2
    return out


def _case_split_mesh(mesh):
    """``split_mesh_data_axis`` over a (4, 1) mesh: DeviceMeshes over the
    slices of the rank tensor."""
    from repro_torch.distributed.meshes import cost_shares, split_mesh_data_axis

    subs = split_mesh_data_axis(mesh, cost_shares({"a": 3.0, "b": 1.0}))
    return {"ok": sorted(subs) == ["a", "b"]
            and subs["a"].mesh.tolist() == [[0], [1], [2]]
            and subs["b"].mesh.tolist() == [[3]]
            and subs["a"].mesh_dim_names == ("data", "model")}


def _run(rank, world, init, outdir):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    torch.set_num_threads(1)
    store = dist.FileStore(init, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    results = {}

    def case(name, fn, *args):
        try:
            results[name] = fn(*args)
        except Exception:
            results[name] = {"ok": False, "error": traceback.format_exc()}
        arrays = results[name].pop("arrays", None)
        if arrays is not None and rank == 0:
            np.savez(os.path.join(outdir, f"{name}.npz"), **arrays)

    try:
        names = ("data", "model")
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=names)
        mesh14 = init_device_mesh("cpu", (1, 4), mesh_dim_names=names)
        mesh41 = init_device_mesh("cpu", (4, 1), mesh_dim_names=names)
        mesh11 = DeviceMesh("cpu", [[0]], mesh_dim_names=names)
        for arch in LOSS_ARCHS:
            case(f"loss:{arch}", _case_loss, arch, mesh, outdir)
        case("seq_parallel", _case_seq_parallel, mesh, outdir)
        case("moe_train", _case_moe_train, mesh, outdir)
        case("odd_heads", _case_odd_heads, mesh14, outdir)
        for arch in TRAIN_ARCHS:
            case(f"train_steps:{arch}", _case_train_steps, arch, mesh, outdir)
        case("shard_batch", _case_shard_batch, mesh)
        case("compressed_psum", _case_compressed_psum, mesh, rank)
        case("decode_seqsharded", _case_decode_seqsharded, mesh14, outdir)
        case("one_rank_bit_equal", _case_one_rank_bit_equal, mesh11, rank,
             outdir)
        case("moe_ep2d_decode", _case_moe_ep2d_decode, mesh, outdir)
        case("checkpoint_remesh", _case_checkpoint_remesh, mesh, mesh41,
             outdir)
        case("split_mesh", _case_split_mesh, mesh41)
        case("resume", _case_resume, mesh, outdir)
        # a case is ok only where it is ok on every rank
        flags = torch.tensor([float(r.get("ok", False)) for r in
                              results.values()])
        dist.all_reduce(flags, op=dist.ReduceOp.MIN)
        for r, f in zip(results.values(), flags.tolist()):
            r["ok_all_ranks"] = bool(f)
    finally:
        if rank == 0:
            with open(os.path.join(outdir, "results.json"), "w") as f:
                json.dump(results, f)
        dist.destroy_process_group()


# --------------------------------------------------------------------------- #
# the tests' side                                                              #
# --------------------------------------------------------------------------- #
def _start(tmp):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    init = os.path.join(tmp, "store")
    return [subprocess.Popen(
        [sys.executable, __file__, str(r), str(WORLD), init, tmp],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(WORLD)]


def _wait(tmp, procs):
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=LAUNCH_TIMEOUT_S)
            errs.append(err)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    path = os.path.join(tmp, "results.json")
    assert os.path.exists(path), "\n".join(e[-2000:] for e in errs if e)
    with open(path) as f:
        return json.load(f)


def _write_weights(jax, tmp):
    """The JAX package's weights of every case's arch (reduced), drawn from
    ``jax.random.key(0)`` and written as numpy leaves under the port's
    dotted names; returns {arch: (JAX config, JAX parameters)}."""
    from repro import configs
    from repro.models.registry import model_api
    from repro_torch.models.params import param_leaves

    out = {}
    for arch in WEIGHT_ARCHS:
        cfg = configs.get_config(arch).reduce_for_smoke()
        params = model_api(cfg).init_params(cfg, jax.random.key(0))
        np.savez(os.path.join(tmp, f"weights_{arch}.npz"),
                 **{k: np.asarray(v) for k, v in param_leaves(params)})
        out[arch] = (cfg, params)
    cfg = dataclasses.replace(configs.get_config(ODD_ARCH).reduce_for_smoke(),
                              **ODD_HEADS)
    params = model_api(cfg).init_params(cfg, jax.random.key(0))
    np.savez(os.path.join(tmp, f"weights_{ODD_ARCH}-odd.npz"),
             **{k: np.asarray(v) for k, v in param_leaves(params)})
    out["odd_heads"] = (cfg, params)
    return out


def _jax_numbers(jax, weights):
    """The JAX package's numbers on one device for every case, from the
    same weights and inputs as the ranks'."""
    from repro.launch.train import build
    from repro.models import moe
    from repro.models import transformer as tf
    from repro.models.registry import model_api
    from repro_torch.models.params import param_leaves

    jnp = jax.numpy

    def loss(arch, b, s):
        cfg, params = weights[arch]
        batch = {k: jnp.asarray(v) for k, v in _np_batch(cfg, b, s).items()}
        return float(jax.jit(lambda p, x: model_api(cfg).loss_fn(
            cfg, p, x)[0])(params, batch))

    out = {f"loss:{a}": loss(a, B, S) for a in LOSS_ARCHS}
    cfg, params = weights["odd_heads"]
    batch = {k: jnp.asarray(v) for k, v in _np_batch(cfg, B, S).items()}
    out["odd_heads"] = float(jax.jit(lambda p, x: model_api(cfg).loss_fn(
        cfg, p, x)[0])(params, batch))
    cfg, params = weights[MOE_TRAIN_ARCH]
    batch = {k: jnp.asarray(v) for k, v in _np_batch(cfg, B, S).items()}
    value, parts = jax.jit(lambda p, x: model_api(cfg).loss_fn(cfg, p, x))(
        params, batch)
    out["moe_train"] = (float(value), float(parts["loss"]))
    out["seq_parallel"] = loss(SP_ARCH, *SP_SHAPE)
    for arch in TRAIN_ARCHS:
        cfg, params = weights[arch]
        _, opt, _, step = build(cfg, None, lr=TRAIN_LR, warmup=0)
        before = {k: np.array(v) for k, v in param_leaves(params)}
        params = jax.tree.map(jnp.copy, params)   # the step donates them
        state, metrics = opt.init(params), []
        for i in range(TRAIN_STEPS):
            batch = {k: jnp.asarray(v)
                     for k, v in _np_batch(cfg, B, S, seed=i).items()}
            params, state, mt = step(params, state, batch)
            metrics.append([float(mt["loss"]), float(mt["grad_norm"])])
        out[f"train_steps:{arch}"] = (metrics, {
            k: np.asarray(v) - before[k] for k, v in param_leaves(params)})
    cfg, params = weights[DECODE_ARCH]
    toks = jnp.asarray(_decode_tokens(cfg.vocab_size, DECODE_B,
                                      DECODE_S + DECODE_STEPS))
    cache, _ = tf.prefill(cfg, params, {"tokens": toks[:, :DECODE_S]},
                          pad_cache_to=DECODE_S + 4)
    logits = []
    for i in range(DECODE_STEPS):
        cache, lg = tf.decode_step(cfg, params, cache,
                                   {"token": toks[:, DECODE_S + i]})
        logits.append(np.asarray(lg))
    out["decode_seqsharded"] = np.stack(logits)
    cfg, params = weights[MOE_ARCH]
    toks = jnp.asarray(_decode_tokens(cfg.vocab_size, MOE_B, MOE_S))
    cache, _ = moe.prefill(cfg, params, {"tokens": toks},
                           pad_cache_to=MOE_S + 4)
    _, lg = moe.decode_step(cfg, params, cache, {"token": toks[:, -1]})
    out["moe_ep2d_decode"] = np.asarray(lg)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"ranks": the ranks' results, "jax": the JAX numbers, "dir": where
    the ranks' arrays are}."""
    jax = pytest.importorskip("jax")
    tmp = str(tmp_path_factory.mktemp("mesh"))
    weights = _write_weights(jax, tmp)
    procs = _start(tmp)
    try:
        want = _jax_numbers(jax, weights)
    finally:
        ranks = _wait(tmp, procs)
    return {"ranks": ranks, "jax": want, "dir": tmp}


@pytest.fixture(scope="module")
def results(runs):
    return runs["ranks"]


def _check(results, name):
    r = results[name]
    assert r.get("ok") and r.get("ok_all_ranks"), r


def _arrays(runs, name):
    with np.load(os.path.join(runs["dir"], f"{name}.npz")) as f:
        return dict(f)


def _assert_close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), **tol,
                               err_msg=what)


@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_loss_on_2x2_train_mesh(runs, arch):
    """Every family's reduced float32 loss on a (2, 2) mesh under
    TRAIN_RULES (FSDP x TP) equals the JAX package's loss on the same
    weights and batch, and the port's single-process loss; moe's is the
    reference's loss_fn: the task loss plus the aux loss."""
    name = f"loss:{arch}"
    _check(runs["ranks"], name)
    r = runs["ranks"][name]
    assert r["sharded_params"] > 0
    _assert_close(r["got"], runs["jax"][name], LOSS_TOL, name)


def test_seq_parallel_loss(runs):
    """``seq_parallel`` on the mesh against the loss without it (the
    reference's bound), and that loss against the JAX package's."""
    _check(runs["ranks"], "seq_parallel")
    _assert_close(runs["ranks"]["seq_parallel"]["base"],
                  runs["jax"]["seq_parallel"], LOSS_TOL, "seq_parallel")


def test_moe_train_sharded_matches_single(runs):
    """grok-1 reduced's ``loss_fn`` on a (2, 2) mesh (EP) against one
    process's and the JAX package's, to the reference's bound; two steps
    of ``build(cfg, mesh)`` train it, the first step's loss the same."""
    _check(runs["ranks"], "moe_train")
    r, (want, task) = runs["ranks"]["moe_train"], runs["jax"]["moe_train"]
    _assert_close(r["got"], want, LOSS_TOL, "moe loss_fn on the mesh")
    _assert_close(r["steps"][0][0], task, LOSS_TOL, "moe first step")


def test_heads_the_model_axis_does_not_divide(runs):
    """whisper-small reduced with 6 heads on 3 kv heads on a (1, 4) mesh
    (every projection on each rank's rows with the whole weight): its
    loss against the JAX package's and one process's, and two train steps
    against one process's."""
    _check(runs["ranks"], "odd_heads")
    _assert_close(runs["ranks"]["odd_heads"]["got"], runs["jax"]["odd_heads"],
                  LOSS_TOL, "odd heads")


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_build_train_steps_on_mesh(runs, arch):
    """TRAIN_STEPS train steps through ``build(cfg, mesh)`` against the
    JAX package's ``build`` on the same weights and batches: loss and
    grad_norm each step, and the change of every parameter leaf (a
    parameter the update missed, or updated on one rank's block only,
    changes by none or part of the JAX change). The port's
    single-process steps are held to the same bounds on the ranks."""
    name = f"train_steps:{arch}"
    _check(runs["ranks"], name)
    metrics, deltas = runs["jax"][name]
    _assert_close(runs["ranks"][name]["got"], metrics, LOSS_TOL, name)
    got = {k.split(":", 1)[1]: v for k, v in _arrays(runs, name).items()
           if k.startswith("mesh:")}
    ok, worst = _deltas_close(got, deltas)
    assert ok, f"{name}: a parameter's change is off by {worst} of its leaf's"


def test_shard_batch_local_blocks(results):
    _check(results, "shard_batch")


def test_compressed_psum_exact(results):
    _check(results, "compressed_psum")


def test_decode_seqsharded_1x4(runs):
    """Two decode steps on a (1, 4) mesh with the cache's sequence
    sharded over "model", against the JAX package's decode."""
    _check(runs["ranks"], "decode_seqsharded")
    assert "Shard(dim=2)" in runs["ranks"]["decode_seqsharded"][
        "cache_seq_sharded"]
    _assert_close(_arrays(runs, "decode_seqsharded")["mesh"],
                  runs["jax"]["decode_seqsharded"], DECODE_TOL, "decode")


def test_moe_ep2d_decode(runs):
    """moe's resident-expert decode on a (2, 2) mesh against the JAX
    package's decode."""
    _check(runs["ranks"], "moe_ep2d_decode")
    _assert_close(_arrays(runs, "moe_ep2d_decode")["mesh"],
                  runs["jax"]["moe_ep2d_decode"], MOE_TOL, "moe decode")


def test_checkpoint_restores_onto_another_mesh(results):
    _check(results, "checkpoint_remesh")


def test_one_rank_mesh_train_steps_bit_equal(results):
    _check(results, "one_rank_bit_equal")


def test_split_mesh_data_axis_device_meshes(results):
    _check(results, "split_mesh")


def test_train_loop_resumes_on_mesh(results):
    _check(results, "resume")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_train_step_on_1x1_nccl_mesh_bit_equal(card):
    """A reduced dense train step on a (1, 1) NCCL mesh on the card is
    bit-equal to the same step unsharded: loss, grad_norm and every
    parameter."""
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import plain
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import build, place
    from repro_torch.models.params import stacked
    from repro_torch.models.registry import model_api

    cfg = get_config("smollm-135m").reduce_for_smoke()
    api = model_api(cfg)
    with tempfile.TemporaryDirectory() as tmp:
        store = dist.FileStore(os.path.join(tmp, "store"), 1)
        dist.init_process_group("nccl", store=store, rank=0, world_size=1)
        try:
            mesh = make_host_mesh(device="cuda")
            runs = []
            for m in (None, mesh):
                _, opt, step = build(cfg, m)
                model = api.init_params(
                    cfg, torch.Generator("cuda").manual_seed(0), device="cuda")
                state = opt.init(stacked(model, api.param_shapes(cfg)))
                model, state = place(cfg, opt, m, model, state)
                batch = {k: v.cuda() for k, v in _batch(cfg, B, S).items()}
                model, state, mt = step(model, state, batch)
                runs.append(({k: plain(v) for k, v in mt.items()},
                             {k: plain(v) for k, v in
                              stacked(model, api.param_shapes(cfg)).items()}))
        finally:
            dist.destroy_process_group()
    (m0, p0), (m1, p1) = runs
    for k in m0:
        assert m0[k].equal(m1[k]), k
    for k in p0:
        assert p0[k].equal(p1[k]), k


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(ROOT, "src"))
    _run(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
