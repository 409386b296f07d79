"""Fault-tolerance primitives: preemption handling, straggler watchdog,
restart bookkeeping (port of ``repro.runtime.fault_tolerance``, unchanged
in behaviour).

On a real cluster the watchdog feeds the control plane (drain and re-mesh
from the last checkpoint); here it exposes the same interface and is
exercised by unit tests and the train loop.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import List, Optional


class PreemptionGuard:
    """SIGTERM/SIGINT -> set a flag; the train loop checkpoints and exits
    cleanly instead of dying mid-step."""

    def __init__(self, install: bool = True):
        self.preempted = False
        self._prev = {}
        if install:
            for sig in (signal.SIGTERM,):
                try:
                    self._prev[sig] = signal.signal(sig, self._handler)
                except ValueError:       # not main thread (tests)
                    pass

    def _handler(self, signum, frame):
        self.preempted = True

    def uninstall(self):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)


@dataclasses.dataclass
class StragglerWatchdog:
    """EMA step-time monitor. A step slower than ``threshold`` x EMA is a
    straggler event; ``trip_after`` consecutive events trips the watchdog
    (real deployment: triggers elastic re-mesh from checkpoint)."""
    threshold: float = 2.5
    momentum: float = 0.9
    trip_after: int = 3
    warmup_steps: int = 5

    ema: float = 0.0
    steps: int = 0
    consecutive: int = 0
    events: List[int] = dataclasses.field(default_factory=list)
    tripped: bool = False

    def observe(self, step_time: float) -> bool:
        """Returns True if this step is flagged as a straggler."""
        self.steps += 1
        if self.steps <= self.warmup_steps:
            self.ema = step_time if self.ema == 0.0 else \
                self.momentum * self.ema + (1 - self.momentum) * step_time
            return False
        flagged = step_time > self.threshold * self.ema
        if flagged:
            self.events.append(self.steps)
            self.consecutive += 1
            if self.consecutive >= self.trip_after:
                self.tripped = True
        else:
            self.consecutive = 0
            self.ema = self.momentum * self.ema + \
                (1 - self.momentum) * step_time
        return flagged


@dataclasses.dataclass
class RestartPolicy:
    """Bounded-retry restart bookkeeping for the outer supervisor."""
    max_restarts: int = 10
    window_s: float = 3600.0
    restarts: List[float] = dataclasses.field(default_factory=list)

    def should_restart(self, now: Optional[float] = None) -> bool:
        now = now if now is not None else time.time()
        self.restarts = [t for t in self.restarts if now - t < self.window_s]
        if len(self.restarts) >= self.max_restarts:
            return False
        self.restarts.append(now)
        return True
