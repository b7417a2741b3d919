"""Query deadlines: the anytime-answer budget of `StreakEngine.execute`.

A query given a `QueryDeadline` stops admitting driver blocks once the
budget is spent and returns its current answer marked partial
(`ExecStats.partial`, `deadline_expired`, `score_bound`).
"""
from __future__ import annotations

import dataclasses
import time


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
