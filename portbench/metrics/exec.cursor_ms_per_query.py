"""Self ms of the program's `exec.cursor` spans (a query's admission:
`QueryCursor.__init__` with its Bloom `prepare`, `cardinality_all` and
root-path probes, the plan aside) per query completed in the window."""
from portbench.program_spans import METRICS

read = METRICS["exec.cursor_ms_per_query"][-1]
