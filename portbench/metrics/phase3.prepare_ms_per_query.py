"""Self ms of the program's `phase3.prepare` spans (Phase 3's driven
entities, boxes and key bounds) per query completed in the window."""
from portbench.program_spans import METRICS

read = METRICS["phase3.prepare_ms_per_query"][-1]
