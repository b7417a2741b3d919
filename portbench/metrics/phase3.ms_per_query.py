"""Self ms of Phase 3: `QueryCursor._phase3` and the fused batcher's flush,
less the refinement they call, per query completed in the window."""


def read(w):
    if not w.layer_s or "phase3" not in w.layer_s or not w.completed:
        return None
    return w.layer_s["phase3"] * 1e3 / w.completed
