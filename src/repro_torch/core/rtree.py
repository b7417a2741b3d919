"""STR-packed R-tree + synchronous traversal distance join [Brinkhoff '93].

This is the comparison spatial-join algorithm from the paper's §5.2.1
(Sowell et al.'s iterated-join study): both inputs get an R-tree, the trees
are descended synchronously, and candidate pairs are emitted at the leaves.
It has neither identifier encoding, characteristic sets, nor SIP — exactly
the ablation STREAK is measured against (Fig. 8). Host numpy: the baseline
is the paper's CPU comparison, so no kernel runs here.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import geometry


@dataclasses.dataclass
class RTree:
    # level 0 = leaves; node_mbr stacked per level
    level_mbrs: list           # [ (n_l, 4) ] per level, level 0 first
    level_children: list       # [ (n_l,) offsets into level below ] CSR
    obj_index: np.ndarray      # leaf order -> original object row
    fanout: int

    @property
    def height(self) -> int:
        return len(self.level_mbrs)

    def nbytes(self) -> int:
        return sum(m.nbytes for m in self.level_mbrs) + self.obj_index.nbytes


def build_str(boxes: np.ndarray, fanout: int = 16) -> RTree:
    """Sort-Tile-Recursive bulk load."""
    boxes = np.asarray(boxes, dtype=np.float64)
    n = len(boxes)
    cx = (boxes[:, 0] + boxes[:, 2]) * 0.5
    cy = (boxes[:, 1] + boxes[:, 3]) * 0.5
    n_slices = max(1, int(np.ceil(np.sqrt(n / fanout))))
    order_x = np.argsort(cx, kind="stable")
    slice_size = int(np.ceil(n / n_slices))
    order = np.empty(n, dtype=np.int64)
    for s in range(n_slices):
        sl = order_x[s * slice_size:(s + 1) * slice_size]
        order[s * slice_size:s * slice_size + len(sl)] = sl[np.argsort(cy[sl],
                                                                       kind="stable")]
    leaf_boxes = boxes[order]
    level_mbrs = [leaf_boxes]
    level_children = [np.arange(n + 1, dtype=np.int64)]  # unused at leaves
    cur = leaf_boxes
    while len(cur) > 1:
        m = len(cur)
        n_parents = int(np.ceil(m / fanout))
        offs = np.minimum(np.arange(n_parents + 1, dtype=np.int64) * fanout, m)
        parent = np.empty((n_parents, 4))
        for p in range(n_parents):
            seg = cur[offs[p]:offs[p + 1]]
            parent[p] = geometry.union_boxes(seg)
        level_mbrs.append(parent)
        level_children.append(offs)
        cur = parent
    return RTree(level_mbrs, level_children, order, fanout)


@dataclasses.dataclass
class SyncJoinStats:
    node_pairs_visited: int = 0
    candidates: int = 0


def _expand(counts: np.ndarray, starts: np.ndarray) -> np.ndarray:
    """Concatenated aranges [starts[i], starts[i]+counts[i])."""
    nz = counts > 0
    s, c = starts[nz], counts[nz]
    total = int(c.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    out = np.ones(total, dtype=np.int64)
    out[0] = s[0]
    if len(s) > 1:
        pos = np.cumsum(c)[:-1]
        out[pos] = s[1:] - (s[:-1] + c[:-1] - 1)
    return np.cumsum(out)


def sync_distance_join(ta: RTree, tb: RTree, dist: float,
                       stats: SyncJoinStats | None = None
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Synchronous traversal: candidate object pairs within `dist`.

    All surviving node pairs sit at a common (level_a, level_b) so each
    expansion step is one vectorized MBR distance test. Returns
    (rows_a, rows_b) into the ORIGINAL box arrays.
    """
    stats = stats if stats is not None else SyncJoinStats()
    la, lb = ta.height - 1, tb.height - 1
    pa = np.zeros(1, dtype=np.int64)
    pb = np.zeros(1, dtype=np.int64)
    while True:
        d = geometry.box_min_dist(ta.level_mbrs[la][pa], tb.level_mbrs[lb][pb])
        keep = d <= dist
        stats.node_pairs_visited += len(pa)
        pa, pb = pa[keep], pb[keep]
        if len(pa) == 0:
            return np.empty(0, np.int64), np.empty(0, np.int64)
        if la == 0 and lb == 0:
            stats.candidates += len(pa)
            return ta.obj_index[pa], tb.obj_index[pb]
        if la >= lb and la > 0:  # descend the coarser side
            offs = ta.level_children[la]
            cnt = offs[pa + 1] - offs[pa]
            new_a = _expand(cnt, offs[pa])
            new_b = np.repeat(pb, cnt)
            pa, pb, la = new_a, new_b, la - 1
        else:
            offs = tb.level_children[lb]
            cnt = offs[pb + 1] - offs[pb]
            new_b = _expand(cnt, offs[pb])
            new_a = np.repeat(pa, cnt)
            pa, pb, lb = new_a, new_b, lb - 1
