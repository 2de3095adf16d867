"""Data pipeline: deterministic synthetic sources + threaded prefetch.

Port of ``repro.data.pipeline``. The pipeline shape matches a production
layout: Source (resumable iterator, seeded) -> Batcher -> Prefetcher
(background thread, bounded queue — the host-side analogue of Hydro's
EddyPull) -> device placement. ``TokenSource`` is the JAX package's numpy
code, so the same seed and step give bit-equal arrays. ``shard_batch``
moves a host batch to the device, and with a mesh places it with batch
sharding (each rank keeps its block of the batch as a ``DTensor``).
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator

import numpy as np
import torch

from repro_torch.kernels.launch import require_device


class TokenSource:
    """Deterministic synthetic LM tokens with a learnable structure.

    Tokens follow a noisy periodic pattern so a real model can reduce loss
    on it (used by examples/train_lm.py to show learning).
    """

    def __init__(self, vocab_size: int, seq_len: int, *, seed: int = 0, period: int = 17):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.seed = seed
        self.period = period
        self._step = 0

    def state(self) -> Dict:
        return {"step": self._step}

    def restore(self, state: Dict) -> None:
        self._step = int(state["step"])

    def next(self, batch: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, self._step))
        self._step += 1
        base = rng.integers(0, self.period, size=(batch, 1))
        pos = np.arange(self.seq_len + 1)[None, :]
        toks = ((base + pos) * 31 % self.period) % self.vocab_size
        noise = rng.integers(0, self.vocab_size, size=toks.shape)
        mask = rng.random(toks.shape) < 0.05
        toks = np.where(mask, noise, toks).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class Prefetcher:
    """Background-thread prefetch with a bounded queue (backpressure)."""

    def __init__(self, fn: Callable[[], Dict], *, depth: int = 2):
        self.fn = fn
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            try:
                item = self.fn()
            except Exception as e:  # surface producer errors to the consumer
                self.q.put(e)
                return
            while not self._stop.is_set():
                try:
                    self.q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def next(self):
        item = self.q.get()
        if isinstance(item, Exception):
            raise item
        return item

    def stop(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass


def shard_batch(batch: Dict[str, np.ndarray], mesh=None, rules=None,
                logical=None, *, device="cuda") -> Dict[str, torch.Tensor]:
    """Place a host batch on ``device`` (each array as a tensor of its own
    dtype). With a mesh and rules, each becomes a ``DTensor`` placed by
    its logical dims (``logical[k]``, by default "batch" then replicated
    dims); every rank passes the same host batch and keeps its block."""
    dev = require_device(device)
    out = {k: torch.from_numpy(np.asarray(v)).to(dev)
           for k, v in batch.items()}
    if mesh is None or rules is None:
        return out
    return place_batch(out, mesh, rules, logical)


def place_batch(batch: Dict[str, torch.Tensor], mesh, rules,
                logical=None) -> Dict[str, torch.Tensor]:
    """Each plain tensor of ``batch`` (the same global value on every
    rank) as a ``DTensor`` placed by its logical dims, ``logical[k]`` or
    by default "batch" then replicated dims; a ``DTensor`` as it is."""
    from repro_torch.distributed.sharding import distribute, is_dtensor

    logical = logical or {}
    return {k: v if is_dtensor(v) else distribute(
        v, logical.get(k, "batch" + " ." * (v.dim() - 1)), rules, mesh)
        for k, v in batch.items()}


def data_iterator(source: TokenSource, batch_size: int, *, prefetch: int = 2) -> Iterator[Dict]:
    pf = Prefetcher(lambda: source.next(batch_size), depth=prefetch)
    try:
        while True:
            yield pf.next()
    finally:
        pf.stop()
