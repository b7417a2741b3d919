"""Entities sent to the exact test over the entities with a geometry, of
the query shapes' selections in the window, in %: the SIP and MBR pruning
(the program's `shape.kept:<shape>` and `shape.entities:<shape>`
counters)."""
from portbench import program_spans


def read(w):
    ents = program_spans._counted(w, "shape.entities:")
    kept = program_spans._counted(w, "shape.kept:")
    return 100.0 * kept / ents if ents else None
