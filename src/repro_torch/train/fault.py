"""Fault tolerance for the training loop.

A copy of the reference's `train/fault.py` (plain Python):

- `StepGuard`: per-step deadline monitor. A straggling or hung step raises
  `StragglerTimeout` so the driver can skip the batch, snapshot, or
  restart, instead of hanging.
- `FailureInjector`: deterministic fault injection for tests (fail at step
  k once, slow step): checkpoint/restart then resumes with the same losses.
- `run_with_recovery`: restart-on-exception wrapper around a step closure
  with bounded retries and checkpoint-based state restore.

The query path's counterpart is `core/fault.py` (per-call watchdog,
`FaultPlan` injection, failover chains and breakers).
"""
from __future__ import annotations

import dataclasses
import threading
import time


class StragglerTimeout(RuntimeError):
    pass


class InjectedFailure(RuntimeError):
    pass


class StepGuard:
    """Watchdog: `with StepGuard(deadline_s): step()` raises on overrun."""

    def __init__(self, deadline_s: float, on_timeout=None):
        self.deadline_s = deadline_s
        self.on_timeout = on_timeout
        self._timer: threading.Timer | None = None
        self.fired = False

    def _fire(self):
        self.fired = True
        if self.on_timeout:
            self.on_timeout()

    def __enter__(self):
        self._timer = threading.Timer(self.deadline_s, self._fire)
        self._timer.daemon = True
        self._timer.start()
        return self

    def __exit__(self, *exc):
        self._timer.cancel()
        if self.fired and exc[0] is None:
            raise StragglerTimeout(
                f"step exceeded {self.deadline_s}s deadline")
        return False


@dataclasses.dataclass
class FailureInjector:
    fail_at_steps: tuple = ()
    slow_at_steps: tuple = ()
    slow_s: float = 0.0
    _failed: set = dataclasses.field(default_factory=set)

    def check(self, step: int) -> None:
        if step in self.slow_at_steps:
            time.sleep(self.slow_s)
        if step in self.fail_at_steps and step not in self._failed:
            self._failed.add(step)  # fail once, succeed on retry
            raise InjectedFailure(f"injected failure at step {step}")


def run_with_recovery(step_fn, restore_fn, *, max_restarts: int = 3,
                      on_restart=None):
    """Run `step_fn()` (which loops steps); on an injected failure or a
    straggler, restore from the checkpoint via `restore_fn()` and re-enter,
    up to max_restarts."""
    restarts = 0
    while True:
        try:
            return step_fn()
        except (InjectedFailure, StragglerTimeout) as e:
            restarts += 1
            if restarts > max_restarts:
                raise
            if on_restart:
                on_restart(restarts, e)
            restore_fn()
