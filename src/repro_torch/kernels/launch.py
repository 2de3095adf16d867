"""Kernel-launch layer of the PyTorch port (Hydro §3.3).

The counterpart of parts (b) and (c) of ``repro.kernels.launch``; the JAX
package's compat shim (its part (a)) has no counterpart here.

(b) **Launch wrapper** — ``kernel_call(fn, name=, rows=)`` wraps one kernel
    launch the way ``pallas_call`` does in the JAX package: with no hooks
    and no watchdog it calls ``fn`` and returns, adding no synchronisation.

(c) **Per-launch timing hooks** — registered hooks receive a
    ``LaunchEvent`` (kernel name, backend, rows, seconds) after each
    launch; ``connect_stats_board`` feeds them into
    ``StatsBoard.record_eval`` so kernel UDFs report cost-per-row like
    every other predicate. GLOBAL hooks (``add_launch_hook(fn)``) observe
    every launch in the process; TOKEN hooks (``add_launch_hook(fn,
    token=...)``) fire only for launches made on threads tagged with the
    same token via ``set_launch_context`` / ``launch_context`` — how
    concurrent executors keep per-executor attribution.

Timing on the card. Each launching thread gets a CUDA stream of its own,
made on first use (``thread_stream``). A predicate runs its host-to-device
copy, the kernel and the device-to-host copy on that stream, and a timed
launch waits on that stream only. A device-wide ``torch.cuda.synchronize()``
would charge one predicate's launch with the kernels that other worker
threads launched meanwhile, and skew the cost estimates routing ranks on.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass
from typing import Callable, List

import torch

__all__ = [
    "LaunchEvent", "add_launch_hook", "clear_launch_context",
    "connect_stats_board", "current_launch_context",
    "current_launch_watchdog", "kernel_call", "launch_context",
    "launch_hooks", "remove_launch_hook", "require_device",
    "set_launch_context", "set_launch_watchdog", "stats_board_hook",
    "thread_stream",
]


# --------------------------------------------------------------------------- #
# devices and per-thread streams                                              #
# --------------------------------------------------------------------------- #
def require_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises for a card that is absent.

    Entry points call this when they are built, so ``device="cuda"`` on a
    host without a card fails at once instead of carrying on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch sees no CUDA device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}: expected cpu or cuda")
    return dev


_STREAMS = threading.local()  # per thread: {device index -> torch.cuda.Stream}


def _stream_for(dev: torch.device) -> "torch.cuda.Stream":
    streams = getattr(_STREAMS, "by_index", None)
    if streams is None:
        streams = _STREAMS.by_index = {}
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    stream = streams.get(index)
    if stream is None:
        stream = streams[index] = torch.cuda.Stream(device=index)
    return stream


def thread_stream(device):
    """Context that makes this thread's own stream current on ``device``.

    A no-op for the CPU. Work enqueued inside runs on the stream, so the
    tensors it allocates belong to that stream too."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return nullcontext()
    return torch.cuda.stream(_stream_for(dev))


def _launch_device(args) -> torch.device:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device("cpu")


# --------------------------------------------------------------------------- #
# (b) launch wrapper                                                          #
# --------------------------------------------------------------------------- #
def kernel_call(fn: Callable, *, name: str, rows: int) -> Callable:
    """The single timed launch path for the port's kernels.

    ``fn`` is the kernel's wrapper (it launches the kernel for CUDA
    tensors and runs the plain version for CPU tensors); ``rows`` is the
    row count reported to timing hooks. The backend of the event is
    ``"cuda"`` when the first tensor argument lies on a card and ``"cpu"``
    otherwise — the latter plays the part of the JAX package's
    ``"interpret"``."""

    def call(*args):
        hooks = _snapshot_hooks()
        wd = _WATCHDOG
        if not hooks and wd is None:
            return fn(*args)
        dev = _launch_device(args)
        # The watchdog brackets the launch AND the wait on it: a CUDA
        # launch returns at once, so a hung kernel shows only in the wait.
        token = wd.begin(name) if wd is not None else None
        t0 = time.perf_counter()
        try:
            out = fn(*args)
            if hooks and dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()
        finally:
            if wd is not None:
                wd.end(token)
        if not hooks:
            return out
        event = LaunchEvent(
            name=name, backend=dev.type, rows=rows,
            seconds=time.perf_counter() - t0,
        )
        for hook in hooks:
            hook(event)
        return out

    return call


# --------------------------------------------------------------------------- #
# (c) per-launch timing hooks                                                 #
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class LaunchEvent:
    """One kernel launch: what ran, where, over how many rows, how long."""

    name: str
    backend: str  # "cuda" | "cpu"
    rows: int
    seconds: float


_HOOKS: List[Callable[[LaunchEvent], None]] = []
_TOKEN_HOOKS: dict = {}  # launch-context token -> [hooks]
_HOOKS_LOCK = threading.Lock()

# Process-global launch watchdog (core/faults.LaunchWatchdog or None).
# Kernel launches are process-wide resources, so unlike the timing hooks
# this seam is NOT token-scoped: any in-flight launch past its deadline is
# worth flagging regardless of which executor issued it.
_WATCHDOG = None


def set_launch_watchdog(wd):
    """Install the process-global launch watchdog; returns the previous
    one (restore it when done — tests use try/finally)."""
    global _WATCHDOG
    prev = _WATCHDOG
    _WATCHDOG = wd
    return prev


def current_launch_watchdog():
    return _WATCHDOG


# Thread-affine launch context: a worker/eddy thread tags itself with its
# executor's token; token-scoped hooks fire only for launches made on
# matching threads (per-executor attribution).
_TLS = threading.local()


def set_launch_context(token) -> None:
    """Tag the CURRENT thread's launches with ``token`` (None = untagged)."""
    _TLS.token = token


def clear_launch_context() -> None:
    _TLS.token = None


def current_launch_context():
    return getattr(_TLS, "token", None)


@contextmanager
def launch_context(token):
    """Scoped ``set_launch_context`` that restores the previous tag."""
    prev = current_launch_context()
    set_launch_context(token)
    try:
        yield
    finally:
        set_launch_context(prev)


def _snapshot_hooks() -> List[Callable[[LaunchEvent], None]]:
    if not _HOOKS and not _TOKEN_HOOKS:  # fast path: no lock, no overhead
        return []
    token = current_launch_context()
    with _HOOKS_LOCK:
        hooks = list(_HOOKS)
        if token is not None:
            hooks.extend(_TOKEN_HOOKS.get(token, ()))
        return hooks


def add_launch_hook(fn: Callable[[LaunchEvent], None], *, token=None):
    """Register a hook; with ``token``, only launches from threads tagged
    with the same launch context (``set_launch_context``) are observed."""
    with _HOOKS_LOCK:
        if token is None:
            _HOOKS.append(fn)
        else:
            _TOKEN_HOOKS.setdefault(token, []).append(fn)
    return fn


def remove_launch_hook(fn: Callable[[LaunchEvent], None]) -> None:
    with _HOOKS_LOCK:
        if fn in _HOOKS:
            _HOOKS.remove(fn)
        for token, hooks in list(_TOKEN_HOOKS.items()):
            if fn in hooks:
                hooks.remove(fn)
            if not hooks:
                del _TOKEN_HOOKS[token]


@contextmanager
def launch_hooks(*fns: Callable[[LaunchEvent], None]):
    for fn in fns:
        add_launch_hook(fn)
    try:
        yield
    finally:
        for fn in fns:
            remove_launch_hook(fn)


def stats_board_hook(board) -> Callable[[LaunchEvent], None]:
    """Hook feeding launches into ``StatsBoard.record_eval``.

    Kernels are compute UDFs, not filters, so rows_in == rows_out; what the
    board learns is the cost-per-row EMA the routing policies consume.
    Entry creation goes through ``board.ensure_kernel``, which is
    thread-safe, uses the board's ``cost_alpha``, and namespaces the entry
    ``kernel:<name>`` if a declared routing predicate already owns the
    kernel's launch name."""

    def hook(event: LaunchEvent) -> None:
        board.ensure_kernel(event.name).record_eval(
            event.rows, event.rows, event.seconds
        )

    return hook


def connect_stats_board(board, *, token=None) -> Callable[[LaunchEvent], None]:
    """Register (and return, for later removal) a stats-board hook.

    With ``token``, the hook is thread-affine: only launches from threads
    tagged with that launch context reach ``board``."""
    return add_launch_hook(stats_board_hook(board), token=token)
