"""Shard views of the S-QuadTree store for the per-block Phases 1–2.

This slice of the port runs unsharded stores only: `shard_views` and
`whole_view` give the executor one view of the store's tree, and
`sip_select` runs Phases 1+2 over the views. Morton-prefix sharding
(`ShardedQuadStore`, `shard_store`) is a later slice of the port.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import node_select
from .squadtree import SQuadTree
from .store import QuadStore


@dataclasses.dataclass
class TreeShard:
    """One shard's tree. Every store of this slice is unsharded, so the one
    view covers the whole id space and its SIP filter material passes
    through untouched; clipping the I-Range intervals to a shard's id range
    comes with the sharded store."""
    tree: SQuadTree

    def filter_material(self, v_star: np.ndarray
                        ) -> tuple[np.ndarray, np.ndarray]:
        return self.tree.filter_material(v_star)


def shard_views(store: QuadStore) -> list[TreeShard]:
    """The store's shard list: a single view, as every store of this slice
    is unsharded."""
    return [TreeShard(store.tree)]


def whole_view(store: QuadStore) -> list[TreeShard]:
    """Single global-tree view (the SIP-disabled path: with no interval
    filtering, per-shard retrieval would replicate the driven side)."""
    return [TreeShard(store.tree)]


def sip_select(shards: list[TreeShard], box_sets, dist_norm,
               driven_cs: np.ndarray, prepared, probe_backend,
               descend_backend, cs_paths, params, card_all: list,
               device: torch.device) -> list[list[np.ndarray]]:
    """Phases 1+2 across shards: candidate masks then the per-shard V*
    selection DP. Returns per-BLOCK lists of per-shard V* arrays (the
    shape `QueryCursor._vstars` stores)."""
    driven_cs = np.asarray(driven_cs, dtype=np.int64)
    if cs_paths is None:
        cs_paths = [None] * len(shards)
    masks = [sh.tree.candidate_nodes(
                 box_sets, dist_norm, driven_cs, prepared=prepared,
                 probe_backend=probe_backend, descend_backend=descend_backend,
                 cs_path=cs_paths[si], device=device)
             for si, sh in enumerate(shards)]
    per_shard = [node_select.select_batch(sh.tree, masks[si], driven_cs,
                                          params, card_all[si])
                 for si, sh in enumerate(shards)]
    n_blocks = len(masks[0]) if len(shards) else 0
    return [[per_shard[si][b] for si in range(len(shards))]
            for b in range(n_blocks)]
