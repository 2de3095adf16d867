"""Fault-tolerant training driver.

Port of ``repro.launch.train``: params and optimizer state on one device,
or placed on a mesh -> the family's ``make_train_step`` -> step loop with
async checkpoints, auto-resume, watchdog, heartbeat, and deterministic
failure injection for tests. Attention's, the RG-LRU's and the SSD scan's
forward and gradient run the hand-written kernels on the card
(``kernels.flash_attention``, ``kernels.rglru``, ``kernels.ssd``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --steps 50 --batch 8 --seq 128 --smoke --ckpt-dir /tmp/ckpt

--smoke uses the reduced config; --device cpu runs the plain versions of
the kernels (the default, cuda, raises at once without a card). --mesh
trains on a ("data", "model") mesh over the launched world, under
``TRAIN_RULES`` (FSDP x TP), one card a rank:

  torchrun --standalone --nproc-per-node 1 -m repro_torch.launch.train --mesh \
      --arch smollm-135m --steps 50 --batch 8 --seq 128

The dense, vlm, ssm, encdec and hybrid families train; moe raises at
``build`` (ROADMAP.md, queue 1, item 2b). ``train_loop`` feeds tokens
only, as the reference's does: an encdec model's frames come through
``build``'s step directly.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Optional

import torch

from repro_torch.checkpoint import Checkpointer, latest_step
from repro_torch.configs import get_config
from repro_torch.data.pipeline import (
    Prefetcher, TokenSource, place_batch, shard_batch,
)
from repro_torch.distributed.fault_tolerance import (
    FailureInjector, Heartbeat, StepWatchdog,
)
from repro_torch.distributed.sharding import TRAIN_RULES, tree_distribute
from repro_torch.kernels.launch import require_device
from repro_torch.models.layers import ShardCtx
from repro_torch.models.params import (
    distribute_params, param_leaves, set_param, stacked,
)
from repro_torch.models.registry import model_api
from repro_torch.optim import AdamW, cosine_schedule

# what training a family without make_train_step waits for
_WAITS = {
    "moe": "the router weights' gradient kernel and FSDP over several "
           "cards (one layer at published width, with the step's copies "
           "of weights, gradients and AdamW state, outgrows a card; "
           "ROADMAP.md, queue 1, item 2b)",
}


def build(cfg, mesh=None, *, lr=3e-4, warmup=20, total=1000):
    """(api, optimizer, train_step). The reference's ``build`` also
    returns its sharding context and jits the step; here, with a mesh, the
    step runs sharded under ``TRAIN_RULES`` on parameters and optimizer
    state that ``place`` put on the mesh, and places a batch of plain
    tensors with batch sharding (``shard_batch``'s placement); its
    metrics are plain tensors."""
    api = model_api(cfg)
    if not hasattr(api, "make_train_step"):
        raise NotImplementedError(
            f"training the {cfg.family} family waits for "
            f"{_WAITS[cfg.family]}")
    opt = AdamW(schedule=cosine_schedule(lr, warmup, total))
    if mesh is None:
        return api, opt, api.make_train_step(cfg, opt)
    step = api.make_train_step(cfg, opt, ShardCtx(mesh, TRAIN_RULES))

    def sharded_step(params, opt_state, batch):
        return step(params, opt_state, place_batch(batch, mesh, TRAIN_RULES))

    return api, opt, sharded_step


def place(cfg, opt, mesh, params, opt_state):
    """(params, opt_state) on ``mesh`` under ``TRAIN_RULES``, once before
    the steps of ``build(cfg, mesh)``: the module's parameters by
    ``param_logical`` (in place), the optimizer state by
    ``state_logical``. With no mesh, both as they are."""
    if mesh is None:
        return params, opt_state
    api = model_api(cfg)
    shapes, logical = api.param_shapes(cfg), api.param_logical(cfg)
    distribute_params(params, shapes, logical, TRAIN_RULES, mesh)
    state_logical = opt.state_logical(dict(param_leaves(logical)))
    return params, tree_distribute(opt_state, state_logical, TRAIN_RULES,
                                   mesh)


def _restore(api, cfg, ckpt, dev):
    """(step, params, opt_state, source state) of the newest checkpoint."""
    step, (flat, opt_state, src_state) = ckpt.restore_latest(device=dev)
    params = api.Model(cfg, device=dev)
    with torch.no_grad():
        for name, _ in param_leaves(api.param_shapes(cfg)):
            set_param(params, name, flat[name])
    return step, params, opt_state, src_state


def train_loop(
    cfg,
    *,
    steps: int,
    batch: int,
    seq: int,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 20,
    mesh=None,
    injector: Optional[FailureInjector] = None,
    log_every: int = 10,
    seed: int = 0,
    device="cuda",
) -> dict:
    """The reference's loop. Weights are drawn from
    ``torch.Generator(device).manual_seed(seed)`` (torch's numbers, not
    ``jax.random``'s); a checkpoint holds (the stacked parameters, the
    optimizer state, the source's step), and a resume restores all three.
    Returns the losses, the straggler count and the parameter module.
    With ``mesh`` the step runs sharded (``build``) and a checkpoint holds
    the global tensors, written by rank 0."""
    dev = require_device(device)
    api, opt, step_fn = build(cfg, mesh)
    shapes = api.param_shapes(cfg)
    source = TokenSource(cfg.vocab_size, seq, seed=seed)

    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
    start_step = 0
    params = opt_state = None
    if ckpt is not None and latest_step(ckpt_dir) is not None:
        start_step, params, opt_state, src_state = _restore(api, cfg, ckpt,
                                                            dev)
        source.restore(src_state)
        print(f"[train] resumed from step {start_step}")
    if params is None:
        params = api.init_params(cfg, torch.Generator(dev).manual_seed(seed),
                                 device=dev)
        opt_state = opt.init(stacked(params, shapes))
    params, opt_state = place(cfg, opt, mesh, params, opt_state)

    watchdog = StepWatchdog()
    hb = Heartbeat(os.path.join(ckpt_dir, "heartbeat")) if ckpt_dir else None
    pf = Prefetcher(lambda: source.next(batch), depth=2)
    losses = []
    try:
        for step in range(start_step + 1, steps + 1):
            if injector is not None:
                injector.check(step)
            t0 = time.perf_counter()
            hbatch = pf.next()
            dbatch = shard_batch(hbatch, mesh,
                                 None if mesh is None else TRAIN_RULES,
                                 device=dev)
            params, opt_state, metrics = step_fn(params, opt_state, dbatch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            ev = watchdog.observe(dt)
            losses.append(loss)
            if hb is not None:
                hb.beat(step)
            if step % log_every == 0 or step == steps:
                print(f"[train] step={step} loss={loss:.4f} dt={dt*1e3:.1f}ms"
                      + (f" STRAGGLER(>{ev.threshold*1e3:.0f}ms)" if ev else ""))
            if ckpt is not None and (step % ckpt_every == 0 or step == steps):
                # source state = batches CONSUMED (one per step), not the
                # prefetcher's read-ahead position — exact replay on resume
                ckpt.save(step, (stacked(params, shapes), opt_state,
                                 {"step": step}))
    finally:
        pf.stop()
        if ckpt is not None:
            ckpt.close()  # drain + join the writer (leaked-thread guard)
    return {
        "final_loss": losses[-1] if losses else float("nan"),
        "losses": losses,
        "stragglers": len(watchdog.events),
        "params": params,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--mesh", action="store_true",
                    help="train on a (data, model) mesh over the launched "
                         "world (torchrun)")
    ap.add_argument("--resume", action="store_true",
                    help="(auto when --ckpt-dir has checkpoints)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    mesh = None
    if args.mesh:
        from repro_torch.launch.mesh import make_host_mesh

        require_device(args.device)
        mesh = make_host_mesh(device=args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduce_for_smoke()
    try:
        out = train_loop(
            cfg, steps=args.steps, batch=args.batch, seq=args.seq,
            ckpt_dir=args.ckpt_dir, device=args.device, mesh=mesh,
        )
        print(f"[train] done: final_loss={out['final_loss']:.4f} "
              f"stragglers={out['stragglers']}")
    finally:
        if mesh is not None:
            import torch.distributed as dist

            dist.destroy_process_group()


if __name__ == "__main__":
    main()
