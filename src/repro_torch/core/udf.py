"""UDF wrapper: the bridge between Hydro and jitted JAX models (§5.1).

The paper's "batch-agnostic parallelization" problem (variable input dims
defeat batching; third-party single-image APIs underutilize the GPU) maps to
TPU/XLA as the RECOMPILATION problem: every new shape compiles a new
executable. The wrapper therefore (a) canonicalizes spatial dims upstream
(data/video.crop_to_canonical) and (b) buckets row counts to powers of two,
so each worker holds a handful of executables that serve any batch.

GACU lazy activation (§5.1): ``ensure_ready`` is only called when the first
batch is routed to a worker — context allocation is greedy, executable
compilation + weight residency is conservative.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Sequence

import numpy as np


def bucket_rows(n: int, *, minimum: int = 1) -> int:
    b = max(minimum, 1)
    while b < n:
        b *= 2
    return b


def pad_rows(v: np.ndarray, target: int) -> np.ndarray:
    """Pad ``v`` to ``target`` rows by repeating its first row (edge fill).

    Single ``np.empty`` allocation + two fills — the old
    ``np.concatenate([v, np.repeat(v[:1], ...)])`` allocated the repeat
    block AND the concatenation result on every bucketed launch.  No-copy
    fast path when ``v`` is already at ``target`` rows."""
    rows = v.shape[0]
    if rows == target:
        return v
    if rows > target:
        raise ValueError(f"cannot pad {rows} rows down to {target}")
    out = np.empty((target,) + v.shape[1:], v.dtype)
    out[:rows] = v
    out[rows:] = v[:1]  # broadcast edge fill, no intermediate repeat copy
    return out


@dataclass
class UDF:
    """A (possibly expensive) ML function over batch columns.

    fn: maps dict[col -> np.ndarray (rows, ...)] -> np.ndarray (rows, ...).
    cost_model: simulated seconds for `rows` rows (SimClock benchmarks);
    proxy_cost: data-aware load units for a batch (paper: input size).
    """

    name: str
    fn: Callable[[Dict[str, np.ndarray]], np.ndarray]
    columns: Sequence[str]
    resource: str = "cpu"                       # e.g. "cpu", "tpu:0"
    bucket: bool = True
    warm_fn: Optional[Callable[[], None]] = None  # lazy init (GACU)
    cost_model: Optional[Callable[[int], float]] = None
    proxy_cost: Optional[Callable[[Dict[str, np.ndarray]], float]] = None
    # canonical cross-process identity (kernel + config + cost-model
    # version, see core/statstore.canonical_fingerprint) keying the
    # persistent statistics store; None falls back to udf:<name>
    fingerprint: Optional[str] = None
    # Graceful degradation (core/faults.py): a reference/interpret-mode
    # implementation of ``fn``; ``degrade()`` flips evaluation onto it
    # when the compiled path fails repeatedly. None == nothing to fall
    # back to (degrade-mode fault handling then quarantines instead).
    fallback_fn: Optional[Callable[[Dict[str, np.ndarray]], np.ndarray]] = None
    degraded: bool = field(default=False, repr=False)
    _ready: bool = field(default=False, repr=False)
    # output dtype + trailing shape, learned from the first evaluation so
    # zero-row calls don't have to launch the kernel just for metadata
    _out_spec: Optional[tuple] = field(default=None, repr=False)

    def ensure_ready(self) -> None:
        if not self._ready:
            if self.warm_fn is not None:
                # A warm_fn may return a sample output (the library's
                # one-row probes do); learn the output spec from it so the
                # zero-row path never needs its own probe launch.
                probe = self.warm_fn()
                if probe is not None and self._out_spec is None:
                    probe = np.asarray(probe)
                    self._out_spec = (
                        probe.dtype, probe.shape[1:] if probe.ndim else ()
                    )
            self._ready = True

    @property
    def out_spec(self) -> Optional[tuple]:
        """(dtype, trailing shape) learned from the first evaluation, or
        None before any launch — the worker's corruption check compares
        subsequent outputs against it."""
        return self._out_spec

    def degrade(self) -> bool:
        """Switch evaluation to ``fallback_fn`` (the reference path).

        Returns True if a fallback exists and the switch happened; False
        when there is nothing to degrade to (caller falls through to
        quarantine). Sticky for the UDF's lifetime — a degraded
        executable does not get retried."""
        if self.fallback_fn is None or self.degraded:
            return False
        self.degraded = True
        return True

    def _active_fn(self) -> Callable[[Dict[str, np.ndarray]], np.ndarray]:
        if self.degraded and self.fallback_fn is not None:
            return self.fallback_fn
        return self.fn

    def proxy(self, data: Dict[str, np.ndarray]) -> float:
        if self.proxy_cost is not None:
            return float(self.proxy_cost(data))
        first = data[self.columns[0]]
        return float(np.asarray(first).size)  # default: input size

    def __call__(self, data: Dict[str, np.ndarray]) -> np.ndarray:
        self.ensure_ready()
        fn = self._active_fn()
        cols = {c: np.asarray(data[c]) for c in self.columns}
        rows = len(next(iter(cols.values())))
        if rows == 0:
            if self._out_spec is None:
                # Probe with ONE synthesized row, never genuinely empty
                # arrays: bucketing kernels assert on zero-sized grids, and
                # ``v[:1]`` of an empty column is still empty. The learned
                # dtype/trailing shape is cached so this costs one launch
                # per UDF lifetime, not one per empty batch.
                probe_cols = {
                    c: np.zeros((1,) + v.shape[1:], v.dtype)
                    for c, v in cols.items()
                }
                probe = fn(probe_cols)
                if probe is None:
                    # cache a sentinel so fn(None) doesn't re-probe forever
                    self._out_spec = (np.dtype(np.float64), ())
                else:
                    probe = np.asarray(probe)
                    self._out_spec = (probe.dtype, probe.shape[1:]
                                      if probe.ndim else ())
            dtype, trailing = self._out_spec
            return np.zeros((0,) + tuple(trailing), dtype)
        if not self.bucket:
            out = np.asarray(fn(cols))
        else:
            b = bucket_rows(rows)
            if b != rows:
                cols = {c: pad_rows(v, b) for c, v in cols.items()}
            out = np.asarray(fn(cols))[:rows]
        if out.ndim:
            self._out_spec = (out.dtype, out.shape[1:])
        return out


@dataclass
class Predicate:
    """UDF output -> boolean row mask, e.g. DogBreedClassifier(...) == 'great dane'."""

    name: str
    udf: UDF
    compare: Callable[[np.ndarray], np.ndarray]
    cacheable: bool = True

    @property
    def resource(self) -> str:
        return self.udf.resource

    def evaluate_outputs(self, data: Dict[str, np.ndarray]) -> np.ndarray:
        return self.udf(data)

    def mask_from_outputs(self, outputs: np.ndarray) -> np.ndarray:
        return np.asarray(self.compare(outputs), bool)


def timed(fn, *args, **kw):
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    return out, time.perf_counter() - t0
