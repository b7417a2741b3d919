"""Rows the query shapes' selections returned (the program's
`shape.rows:<shape>` counters) per query completed in the window."""
from portbench import program_spans


def read(w):
    rows = program_spans._counted(w, "shape.rows:")
    if not w.completed or not any(
            k.startswith("shape.rows:") for k in w.program_counts or {}):
        return None
    return rows / w.completed
