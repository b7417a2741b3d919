"""Queries completed in the window over the window's seconds."""


def read(w):
    return w.completed / w.seconds
