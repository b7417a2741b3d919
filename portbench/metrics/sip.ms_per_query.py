"""Self ms of Phases 1-2: `shard.sip_select`, the pooled
`SQuadTree.candidate_nodes` and `node_select.select_batch`, per query
completed in the window."""


def read(w):
    if not w.layer_s or "sip" not in w.layer_s or not w.completed:
        return None
    return w.layer_s["sip"] * 1e3 / w.completed
