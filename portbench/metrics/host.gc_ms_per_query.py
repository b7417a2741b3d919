"""ms of garbage collection (the program's `host.gc` spans) per query
completed in the window; 0 where spans were recorded and none collected."""
from portbench.program_spans import METRICS

read = METRICS["host.gc_ms_per_query"][-1]
