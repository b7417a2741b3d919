"""Self ms of refinement and top-k: `StreakEngine._emit_pairs`
(`spatial_join.refine`), per query completed in the window."""


def read(w):
    if not w.layer_s or "refine" not in w.layer_s or not w.completed:
        return None
    return w.layer_s["refine"] * 1e3 / w.completed
