"""Self ms of APS and driven retrieval: `aps.choose`,
`StreakEngine._driven_splan` / `_driven_nplan`, per query completed in the
window."""


def read(w):
    if not w.layer_s or "driven" not in w.layer_s or not w.completed:
        return None
    return w.layer_s["driven"] * 1e3 / w.completed
