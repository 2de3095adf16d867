"""Mesh construction over the launched world.

Port of ``repro.launch.mesh``. The functions build meshes (never a
module-level constant), so importing this module touches no process
group. ``make_host_mesh`` builds a ("data", "model") ``DeviceMesh`` over
the ranks of the world the caller launched (``torchrun --nproc-per-node
N ...``, or a process group the caller made); ``make_production_mesh``
the reference's 256- and 512-chip meshes over a fake process group of
that many ranks, which the dry run starts (``start_fake_world``).
"""
from __future__ import annotations

import os

import torch

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def start_fake_world(size: int) -> None:
    """A process group of ``size`` ranks, this process being rank 0, whose
    collectives move nothing (torch's "fake" backend): the dry run's
    stand-in for a cluster. A fake group of another size is replaced; a
    real one raises."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a real process group is running")
        if dist.get_world_size() == size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), world_size=size,
                            rank=0)


def fake_device_type() -> str:
    """The device of the dry run's fake tensors: "cuda" where torch has a
    card, else "cpu" (a CPU-only build of torch cannot differentiate fake
    CUDA tensors; the kernels' accounting is the card's either way)."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def make_fake_mesh(shape, axes=("data", "model"), device_type=None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` (on
    ``fake_device_type()`` unless ``device_type``) over the running process
    group, which must have exactly that many ranks (the dry run's fake
    one, ``start_fake_world``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized() or dist.get_world_size() != n:
        have = dist.get_world_size() if dist.is_initialized() else "none"
        raise RuntimeError(
            f"a {tuple(shape)} mesh needs a process group of {n} ranks "
            f"(start_fake_world({n})); the running one has {have}")
    return init_device_mesh(device_type or fake_device_type(), tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 (256 chips a pod); ``multi_pod`` adds a leading 2-pod axis
    (512), over a running process group of that many ranks."""
    return make_fake_mesh(*PRODUCTION_SHAPES[multi_pod])


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
