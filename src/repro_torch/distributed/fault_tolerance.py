"""Fault tolerance for the training loop (DESIGN.md §5).

Mechanisms (all exercised by tests):
  * crash/restart — the train driver resumes from the newest atomic
    checkpoint (checkpoint/checkpointer.py); a FailureInjector can kill the
    step loop deterministically to prove it.
  * straggler mitigation — StepWatchdog tracks a robust step-time envelope
    (median + k*MAD); slow steps emit straggler events that the driver
    reacts to (re-dispatch / rebalance hook). This is Hydro's data-aware
    load-balancing idea applied at pod scale: the proxy signal is step
    latency instead of input size.
  * elastic rescale — checkpoints restore onto a different mesh
    (Checkpointer.restore with target shardings); ``plan_rescale`` computes
    the new mesh shape when a pod drops out.
"""
from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional


class FailureInjector:
    """Deterministic failure schedule for tests: fail at given steps."""

    def __init__(self, fail_at: Optional[List[int]] = None):
        self.fail_at = set(fail_at or [])
        self.failures = 0

    def check(self, step: int) -> None:
        if step in self.fail_at:
            self.fail_at.discard(step)
            self.failures += 1
            raise RuntimeError(f"injected failure at step {step}")


@dataclass
class StragglerEvent:
    step: int
    seconds: float
    threshold: float


@dataclass
class StepWatchdog:
    """Robust step-time envelope: flag steps slower than median + k*MAD."""

    k: float = 5.0
    window: int = 50
    min_samples: int = 5
    times: List[float] = field(default_factory=list)
    events: List[StragglerEvent] = field(default_factory=list)
    on_straggler: Optional[Callable[[StragglerEvent], None]] = None
    _step: int = 0

    def observe(self, seconds: float) -> Optional[StragglerEvent]:
        self._step += 1
        ev = None
        if len(self.times) >= self.min_samples:
            med = statistics.median(self.times)
            mad = statistics.median(abs(t - med) for t in self.times) or med * 0.05
            threshold = med + self.k * max(mad, 1e-9)
            if seconds > threshold:
                ev = StragglerEvent(self._step, seconds, threshold)
                self.events.append(ev)
                if self.on_straggler is not None:
                    self.on_straggler(ev)
        self.times.append(seconds)
        if len(self.times) > self.window:
            self.times.pop(0)
        return ev


def plan_rescale(total_chips: int, failed_chips: int, *, model_parallel: int):
    """New (data, model) mesh shape after losing ``failed_chips``.

    Keeps model_parallel fixed (weights layout unchanged) and shrinks the
    data axis to the largest multiple that fits — the elastic-scaling
    policy: DP shrinks, TP layout survives, checkpoint reshards on restore.
    """
    remaining = total_chips - failed_chips
    data = remaining // model_parallel
    if data < 1:
        raise ValueError("not enough chips for the model-parallel layout")
    return (data, model_parallel)


class Heartbeat:
    """Liveness file for external supervisors (touched every step)."""

    def __init__(self, path: str):
        self.path = path

    def beat(self, step: int) -> None:
        with open(self.path, "w") as f:
            f.write(f"{step} {time.time()}\n")
