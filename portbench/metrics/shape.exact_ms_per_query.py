"""Self ms of the program's `shape.exact` spans (a selection's MBR
prefilter and exact test over the stored points) per query completed in
the window."""
from portbench import program_spans


def read(w):
    return program_spans._self_ms(w, "shape.exact")
