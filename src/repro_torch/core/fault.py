"""Query deadlines and the failure types the serving loop tells apart.

A query given a `QueryDeadline` stops admitting driver blocks once the
budget is spent and returns its current answer marked partial
(`ExecStats.partial`, `deadline_expired`, `score_bound`).

The exception classes name the failures that the multi-tenant serving loop
(`serve/spatial.py`) retries from a fresh cursor (`TRANSIENT`); any other
exception retires the request with its error.
"""
from __future__ import annotations

import dataclasses
import time


class InjectedFault(RuntimeError):
    """A failure planted on purpose, to exercise recovery."""


class CorruptionDetected(RuntimeError):
    """An op result failed its structural validator."""


class OpTimeout(RuntimeError):
    """An op launch overran its deadline."""


class FallbackExhausted(RuntimeError):
    """Every backend of an op failed. The serving layer treats this as
    transient and retries with backoff."""


# exception types the serving layer retries with backoff; anything else is
# treated as a permanent per-request failure (a real bug, a bad query)
TRANSIENT = (InjectedFault, CorruptionDetected, OpTimeout, FallbackExhausted)


@dataclasses.dataclass
class QueryDeadline:
    """Per-query execution budget: wall-clock seconds, driver blocks, or
    both. The clock starts at construction (for served requests: at
    submission). ``max_blocks`` is the deterministic form tests use."""
    seconds: float | None = None
    max_blocks: int | None = None
    start: float = dataclasses.field(default_factory=time.monotonic)

    def expired(self, blocks: int = 0) -> bool:
        if self.max_blocks is not None and blocks >= self.max_blocks:
            return True
        return (self.seconds is not None
                and time.monotonic() - self.start >= self.seconds)
