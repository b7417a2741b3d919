"""Wall ms of `SpatialServeEngine.step` less the layer timers inside it,
per query completed in the window."""


def read(w):
    if not w.layer_s or "serve" not in w.layer_s or not w.completed:
        return None
    return w.layer_s["serve"] * 1e3 / w.completed
