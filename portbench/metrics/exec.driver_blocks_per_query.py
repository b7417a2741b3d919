"""Driver blocks (`ExecStats.driver_blocks`) per query completed in the
window."""


def read(w):
    if not w.exec_stats:
        return None
    return sum(s.driver_blocks for s in w.exec_stats) / len(w.exec_stats)
