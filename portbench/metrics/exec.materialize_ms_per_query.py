"""Self ms of `QueryCursor._materialize` (driver-block materialisation),
per query completed in the window."""


def read(w):
    if not w.layer_s or "driver_blocks" not in w.layer_s or not w.completed:
        return None
    return w.layer_s["driver_blocks"] * 1e3 / w.completed
