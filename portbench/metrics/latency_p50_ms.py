"""Median, over every query completed in the window, of completion time
minus submission time, in ms."""
import numpy as np


def read(w):
    return float(np.percentile(w.latencies_ms, 50)) if w.latencies_ms \
        else None
