"""Side lookups of the query shapes' selections in the window that found
the side's entities and boxes already built, over all lookups, in %: the
program's `shape.side_hit:<shape>` and `shape.side_built:<shape>`
counters. None where the program counts no lookup."""
from portbench import program_spans


def read(w):
    hits = program_spans._counted(w, "shape.side_hit:")
    built = program_spans._counted(w, "shape.side_built:")
    return 100.0 * hits / (hits + built) if hits + built else None
