"""The device's idle time in the window with no program span open, over all
of its idle time, in %: root spans against the device trace's gaps."""
from portbench.program_spans import METRICS

read = METRICS["host.unspanned_idle_share"][-1]
