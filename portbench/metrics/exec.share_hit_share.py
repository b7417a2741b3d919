"""Share-cache hits over lookups in the window, all kinds, in %: the
program's `share.hit:<kind>` and `share.miss:<kind>` counters."""
from portbench.program_spans import METRICS

read = METRICS["exec.share_hit_share"][-1]
