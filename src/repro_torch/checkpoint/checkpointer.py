"""Fault-tolerant checkpointing: async and atomic.

Port of ``repro.checkpoint.checkpointer``, with the same layout on disk:
``<dir>/step_<N>/`` containing ``manifest.json`` (the tree's leaf names,
shapes, dtypes) + ``arrays.npz`` (``arr_0`` ... in the order
``jax.tree.flatten`` would walk the same tree: a dict's keys sorted, a
tuple's items in order). Writes go to ``step_<N>.tmp`` and are renamed
only when complete — a crash mid-save can never corrupt the latest
checkpoint (restart discovery simply ignores ``*.tmp``). Saves run on a
background thread (training continues); ``wait()`` joins before the next
save or shutdown.

Two differences from the reference. The manifest stores the tree as its
leaves' key paths (``names``: a list of dict keys and sequence indices
each) instead of a JAX treedef; a sequence comes back as a tuple. numpy
has no bfloat16, so a bfloat16 tensor is stored as its uint16 bits with
``"bfloat16"`` in ``dtypes``, and comes back bit for bit. ``restore``
returns tensors: on the CPU, or cast to a target leaf's dtype and put on
its device.

On a mesh: ``save`` writes a ``DTensor`` leaf's global tensor (every
rank gathers it, rank 0 writes; the layout on disk is the same), and
``restore`` places each leaf on its target leaf's mesh and placements —
elastic re-mesh: a checkpoint written on one mesh restores onto another.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Optional

import numpy as np
import torch

BF16 = "bfloat16"


def _flatten(tree, path=()):
    """(key path, leaf) pairs of a tree of dicts, tuples and lists, in
    ``jax.tree.flatten``'s order; None holds no leaf."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _flatten(tree[key], path + (key,))
    elif isinstance(tree, (tuple, list)):
        for i, item in enumerate(tree):
            yield from _flatten(item, path + (i,))
    elif tree is not None:
        yield path, tree


def _unflatten(names, leaves):
    """The tree that ``_flatten`` walked: an int key path component makes a
    tuple, a str one a dict."""
    if len(names) == 1 and not names[0]:
        return leaves[0]
    groups: dict = {}
    for name, leaf in zip(names, leaves):
        groups.setdefault(name[0], ([], []))
        groups[name[0]][0].append(name[1:])
        groups[name[0]][1].append(leaf)
    built = {k: _unflatten(*v) for k, v in groups.items()}
    if all(isinstance(k, int) for k in built):
        return tuple(built[i] for i in sorted(built))
    return built


def _writer() -> bool:
    """Whether this process writes checkpoints: rank 0 of a running
    process group, or a process with none."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def _to_host(x) -> np.ndarray:
    """A snapshot of one leaf in host memory (a copy: the caller may go on
    updating the tensor in place); bfloat16 as its uint16 bits. A
    ``DTensor`` leaf's global tensor (a collective: every rank calls)."""
    from repro_torch.distributed.sharding import plain

    if isinstance(x, torch.Tensor):
        t = plain(x.detach()).to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.array(x)


def _from_host(a: np.ndarray, dtype: str) -> torch.Tensor:
    a = np.ascontiguousarray(a).reshape(a.shape)   # a 0-d leaf stays 0-d
    if dtype == BF16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                steps.append(int(name.split("_", 1)[1]))
            except ValueError:
                continue
    return max(steps) if steps else None


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3, async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        os.makedirs(directory, exist_ok=True)
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[Future] = None
        self._lock = threading.Lock()

    # ------------------------------ save ------------------------------ #
    def save(self, step: int, tree: Any) -> None:
        # snapshot to host memory synchronously (cheap), write async
        pairs = list(_flatten(tree))
        names = [name for name, _ in pairs]
        leaves = [leaf for _, leaf in pairs]
        host = [_to_host(x) for x in leaves]
        dtypes = [BF16 if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16
                  else str(a.dtype) for x, a in zip(leaves, host)]
        manifest = {
            "step": step,
            "names": [list(n) for n in names],
            "num_leaves": len(host),
            "dtypes": dtypes,
            "shapes": [list(a.shape) for a in host],
        }
        if not _writer():
            return
        if self.async_save:
            self.wait()
            self._pending = self._pool.submit(self._write, step, host, manifest)
        else:
            self._write(step, host, manifest)

    def _write(self, step: int, host, manifest) -> None:
        final = os.path.join(self.directory, f"step_{step}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), *host)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc()

    def _gc(self) -> None:
        with self._lock:
            steps = sorted(
                int(n.split("_", 1)[1])
                for n in os.listdir(self.directory)
                if n.startswith("step_") and not n.endswith(".tmp")
            )
            for s in steps[: -self.keep] if self.keep else []:
                shutil.rmtree(os.path.join(self.directory, f"step_{s}"), ignore_errors=True)

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def close(self) -> None:
        """Drain pending saves and join the writer thread (non-daemon —
        leaving it alive trips the test session's leaked-thread guard)."""
        self.wait()
        self._pool.shutdown(wait=True)

    # ----------------------------- restore ---------------------------- #
    def restore(self, step: int, target: Any = None, *, device=None) -> Any:
        """Restore step as a tree of tensors on the CPU (or ``device``).
        ``target``: a tree of the same structure whose tensor leaves (real
        or on the meta device) give each leaf's dtype and, unless
        ``device`` is given, its device (a meta leaf's is the CPU); a
        ``DTensor`` leaf also its mesh and placements, and the leaf comes
        back a ``DTensor`` placed so."""
        from repro_torch.distributed.sharding import from_global, is_dtensor

        path = os.path.join(self.directory, f"step_{step}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as data:
            host = [_from_host(data[f"arr_{i}"], manifest["dtypes"][i])
                    for i in range(manifest["num_leaves"])]
        names = [tuple(n) for n in manifest["names"]]
        if target is None:
            if device is not None:
                host = [t.to(device) for t in host]
            return _unflatten(names, host)
        loaded = dict(zip(names, host))
        want = list(_flatten(target))
        if sorted(map(str, loaded)) != sorted(str(n) for n, _ in want):
            raise ValueError(f"checkpoint step {step}: its leaves differ from "
                             "the target's")
        placed = []
        for name, t in want:
            a = loaded[name]
            if is_dtensor(t):
                dev = device if device is not None else t.to_local().device
                a = from_global(a.to(device=dev, dtype=t.dtype),
                                t.placements, t.device_mesh)
            elif isinstance(t, torch.Tensor):
                dev = device if device is not None else (
                    "cpu" if t.device.type == "meta" else t.device)
                a = a.to(device=dev, dtype=t.dtype)
            elif device is not None:
                a = a.to(device)
            placed.append(a)
        return _unflatten([n for n, _ in want], placed)

    def restore_latest(self, target: Any = None, *, device=None):
        step = latest_step(self.directory)
        if step is None:
            return None, None
        return step, self.restore(step, target, device=device)
