"""Launches of the six STREAK kernels (`ops.LAUNCHES`) in the window per
query completed in it."""
KERNELS = ("fused_topk_join", "distance_join", "bucketed_min_core",
           "tree_descend", "bloom_probe", "merge_join_ranks")


def read(w):
    if w.launches is None or not w.completed:
        return None
    return sum(w.launches.get(k, 0) for k in KERNELS) / w.completed
