"""Graph substrate: generators, CSR neighbor sampling, spatial graphs.

A copy of the reference's `data/graphs.py` (numpy only, the same seeds and
draws, so its graphs and sampled blocks are the reference's bit for bit),
built on the port's own `core.squadtree.radius_join`:

- `random_power_law_graph`: degree-skewed synthetic graphs (Reddit-like).
- `NeighborSampler`: layered uniform sampling over CSR (GraphSAGE
  `minibatch_lg` regime) producing fixed-size padded blocks.
- `spatial_graph` / `grid_mesh_edges`: cutoff graphs + GraphCast grid<->mesh
  edges built with the STREAK Z-order radius join: the paper's distance
  join as graph construction.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core import squadtree


def random_power_law_graph(n: int, avg_degree: int, seed: int = 0,
                           alpha: float = 1.8):
    """Edge list (2, E) with power-law out-degrees, deduplicated."""
    rng = np.random.default_rng(seed)
    deg = np.minimum(rng.zipf(alpha, size=n) * avg_degree // 2, n - 1)
    deg = np.maximum(deg, 1)
    src = np.repeat(np.arange(n), deg)
    dst = rng.integers(0, n, size=len(src))
    keep = src != dst
    edges = np.stack([src[keep], dst[keep]]).astype(np.int32)
    key = edges[0].astype(np.int64) * n + edges[1]
    _, idx = np.unique(key, return_index=True)
    return edges[:, idx]


def to_csr(edges: np.ndarray, n: int):
    """(2, E) -> (indptr, indices) over dst-grouped incoming edges."""
    order = np.argsort(edges[1], kind="stable")
    src, dst = edges[0][order], edges[1][order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, dst + 1, 1)
    return np.cumsum(indptr), src


@dataclasses.dataclass
class SampledBlock:
    nodes: np.ndarray      # (n_pad,) global node ids (padded with -1)
    feats: np.ndarray      # (n_pad, F)
    edges: np.ndarray      # (2, e_pad) LOCAL indices into `nodes`
    labels: np.ndarray     # (n_pad,)
    mask: np.ndarray       # (n_pad,) True for real seed nodes


class NeighborSampler:
    """Layered uniform neighbor sampling (GraphSAGE) with fixed padding."""

    def __init__(self, edges: np.ndarray, n: int, feats: np.ndarray,
                 labels: np.ndarray, fanouts: tuple, seed: int = 0):
        self.indptr, self.indices = to_csr(edges, n)
        self.n = n
        self.feats = feats
        self.labels = labels
        self.fanouts = fanouts
        self.rng = np.random.default_rng(seed)

    def _sample_neighbors(self, nodes: np.ndarray, fanout: int) -> np.ndarray:
        """(len(nodes), fanout) sampled in-neighbors (self-pad when none)."""
        starts = self.indptr[nodes]
        counts = self.indptr[nodes + 1] - starts
        pick = self.rng.integers(0, np.maximum(counts, 1)[:, None],
                                 size=(len(nodes), fanout))
        idx = starts[:, None] + pick % np.maximum(counts, 1)[:, None]
        neigh = self.indices[np.minimum(idx, len(self.indices) - 1)]
        neigh = np.where(counts[:, None] > 0, neigh, nodes[:, None])
        return neigh

    def sample(self, seeds: np.ndarray) -> SampledBlock:
        b = len(seeds)
        layers = [seeds]
        edge_src, edge_dst = [], []
        frontier = seeds
        for fanout in self.fanouts:
            neigh = self._sample_neighbors(frontier, fanout)   # (f_n, fanout)
            edge_src.append(neigh.reshape(-1))
            edge_dst.append(np.repeat(frontier, fanout))
            frontier = neigh.reshape(-1)
            layers.append(frontier)
        all_nodes = np.concatenate(layers)
        uniq = np.unique(all_nodes)
        # local relabeling
        src = np.concatenate(edge_src)
        dst = np.concatenate(edge_dst)
        src_l = np.searchsorted(uniq, src)
        dst_l = np.searchsorted(uniq, dst)
        # fixed padded sizes (shapes stable from block to block)
        e_pad = sum(b * int(np.prod(self.fanouts[:i + 1]))
                    for i in range(len(self.fanouts)))
        n_pad = max(b + e_pad, len(uniq))
        nodes = np.full(n_pad, -1, dtype=np.int64)
        nodes[: len(uniq)] = uniq
        feats = np.zeros((n_pad, self.feats.shape[1]), self.feats.dtype)
        feats[: len(uniq)] = self.feats[uniq]
        labels = np.zeros(n_pad, dtype=np.int32)
        labels[: len(uniq)] = self.labels[uniq]
        edges = np.zeros((2, e_pad), dtype=np.int32)
        edges[0, : len(src_l)] = src_l
        edges[1, : len(dst_l)] = dst_l
        mask = np.zeros(n_pad, dtype=bool)
        mask[np.searchsorted(uniq, seeds)] = True
        return SampledBlock(nodes, feats, edges, labels, mask)


def spatial_graph(positions: np.ndarray, cutoff: float,
                  include_self: bool = False) -> np.ndarray:
    """Cutoff graph via the STREAK Z-order radius join. positions (N, d<=3):
    the join runs on the first two dims; 3-d distances are refined exactly."""
    p2 = positions[:, :2]
    i, j = squadtree.radius_join(p2, p2, cutoff, include_self=include_self)
    if positions.shape[1] > 2:
        d = np.sqrt(((positions[i] - positions[j]) ** 2).sum(-1))
        keep = d <= cutoff
        i, j = i[keep], j[keep]
    return np.stack([i, j]).astype(np.int32)


def grid_mesh_edges(grid_xy: np.ndarray, mesh_xy: np.ndarray,
                    radius: float) -> np.ndarray:
    """GraphCast grid->mesh bipartite edges via the radius join."""
    i, j = squadtree.radius_join(grid_xy, mesh_xy, radius)
    return np.stack([i, j]).astype(np.int32)
