"""Serve-loop steps (`ServeStats.steps`) in the window per query
completed in it."""


def read(w):
    if w.serve_steps is None or not w.completed:
        return None
    return w.serve_steps / w.completed
