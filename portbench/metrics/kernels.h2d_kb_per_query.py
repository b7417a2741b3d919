"""KB copied (`h2d.copy:<op>`) or read in place (`h2d.mapped:<op>`) from
host to device per query completed in the window: the program's counters."""
from portbench.program_spans import METRICS

read = METRICS["kernels.h2d_kb_per_query"][-1]
