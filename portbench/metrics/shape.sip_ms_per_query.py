"""Self ms of Phases 1-2 inside the query shapes: the program's
`sip.select`, `sip.descend`, `sip.node_select` and `shape.material`
spans, per query completed in the window; None where the program records
no `shape.*` span. (A cell that mixes selections with top-k joins would
count the joins' `sip.*` spans too: none does.)"""
from portbench import program_spans

SIP = ("sip.select", "sip.descend", "sip.node_select", "shape.material")


def read(w):
    if not any(n.startswith("shape.") for n in w.program_names or []):
        return None
    got = [program_spans._self_ms(w, n) for n in SIP]
    got = [v for v in got if v is not None]
    return sum(got) if got else None
