"""Self ms of the program's `shape.*` spans (`core/shapes.py`: the
selection, its side, SIP material, exact test and rows) per query
completed in the window; None where the program records no such span."""
from portbench import program_spans


def read(w):
    got = [program_spans._self_ms(w, n) for n in w.program_names or []
           if n.startswith("shape.")]
    got = [v for v in got if v is not None]
    return sum(got) if got else None
