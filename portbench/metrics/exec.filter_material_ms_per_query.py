"""Self ms of the program's `exec.filter_material` spans (V* to SIP
intervals, `TreeShard.filter_material`) per query completed in the
window."""
from portbench.program_spans import METRICS

read = METRICS["exec.filter_material_ms_per_query"][-1]
