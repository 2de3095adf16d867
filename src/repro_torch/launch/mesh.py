"""Mesh construction over the launched world.

Port of ``repro.launch.mesh``. ``make_host_mesh`` is a FUNCTION (never a
module-level constant) so importing this module touches no process
group: it builds a ("data", "model") ``DeviceMesh`` over the ranks of the
world the caller launched (``torchrun --nproc-per-node N ...``, or a
process group the caller made). ``make_production_mesh``, the
reference's 256- and 512-chip meshes, needs a fake process group of that
many ranks, which is the dry run's work (slice 17, ROADMAP.md).
"""
from __future__ import annotations

import os

import torch


def make_production_mesh(*, multi_pod: bool = False):
    raise NotImplementedError(
        "the production mesh (16x16, or 2x16x16 with multi_pod) needs a "
        "fake process group of 256 or 512 ranks: the dry run's work, slice "
        "17 (ROADMAP.md)")


def make_host_mesh(*, model_parallel: int = 1, device="cuda"):
    """A (world / model_parallel, model_parallel) mesh named ("data",
    "model") over the launched world, on ``device``'s type ("cuda": one
    card a rank, the rank's local index; "cpu": gloo). Starts the default
    process group from torchrun's environment if none is running."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    device_type = torch.device(device).type
    if not dist.is_initialized() and "WORLD_SIZE" not in os.environ:
        raise RuntimeError(
            "make_host_mesh needs a launched world: a process group, or "
            "torchrun's environment (torchrun --nproc-per-node N ...)")
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_host_mesh on cuda: no CUDA device")
        rank = dist.get_rank() if dist.is_initialized() else int(
            os.environ.get("LOCAL_RANK", 0))
        torch.cuda.set_device(rank % torch.cuda.device_count())
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo")
    n = dist.get_world_size()
    assert n % model_parallel == 0, (n, model_parallel)
    return init_device_mesh(device_type, (n // model_parallel, model_parallel),
                            mesh_dim_names=("data", "model"))


def mesh_chip_count(mesh) -> int:
    return int(mesh.size())
