"""1 - (the union of the device's kernel and copy spans) / (the traced
window's wall time), in %."""


def read(w):
    if not w.spans or not w.trace_window_us:
        return None
    lo, hi = w.trace_window_us
    busy, end = 0.0, lo
    for start, stop, _ in w.spans:
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    return 100.0 * (1.0 - busy / (hi - lo))
