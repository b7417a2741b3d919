"""Self ms of the program's `serve.step` spans (the serve loop's step less
every span inside it) per query completed in the window."""
from portbench.program_spans import METRICS

read = METRICS["serve.residual_ms_per_query"][-1]
