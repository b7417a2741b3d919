"""The six STREAK kernels' summed bound (portbench/bounds.py: the least
time the work their calls need could take on the card) over their summed
device time in the trace, in %.

The profiler drops some kernel spans. A kernel's bound is scaled by the
share of its launches whose span the trace holds, so bound and time cover
the same launches (on average); a kernel with no span adds to neither."""
KERNELS = ("fused_topk_join", "distance_join", "bucketed_min_core",
           "tree_descend", "bloom_probe", "merge_join_ranks")


def read(w):
    if not w.spans or not w.bounds or not w.launches:
        return None
    bound = busy = 0.0
    for k in KERNELS:
        times = [(b - a) / 1e3 for a, b, name in w.spans if k in name]
        launched = w.launches.get(k, 0)
        if not times or not launched:
            continue
        total, _ = w.bounds.get(k, (0.0, 0))
        bound += total * min(1.0, len(times) / launched)
        busy += sum(times)
    return 100.0 * bound / busy if busy > 0 and bound > 0 else None
