"""Launches of the six STREAK kernels whose span the profiler's trace holds,
over their launches counted by `ops.LAUNCHES`, in %: what the trace-based
kernel metrics stand on."""
KERNELS = ("fused_topk_join", "distance_join", "bucketed_min_core",
           "tree_descend", "bloom_probe", "merge_join_ranks")


def read(w):
    if w.spans is None or not w.launches:
        return None
    launched = sum(w.launches.get(k, 0) for k in KERNELS)
    seen = sum(1 for _, _, name in w.spans
               if any(k in name for k in KERNELS))
    return 100.0 * seen / launched if launched and seen else None
