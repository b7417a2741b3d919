"""Optimal filter-node selection: Algorithm 1 / Theorem 3.1.

Given the candidate node set V (Phase 1) the DP picks V* ⊆ V that covers every
join-relevant object while minimizing

    cost(a)  = alpha_io * |CS(a)|  +  alpha_cpu * |E-list(a)|
    xi(a)    = alpha_merge * |E-list(a)|            (merge cost contribution)

with the hierarchical merge term mu(a) = sum_{j in gamma(a)} xi*(j) charged
whenever more than one selected branch contributes an E-list. Nodes are laid
out parents-before-children during the build, so one reverse sweep is the
bottom-up order — O(N), matching the theorem's linearity claim.

Decisions are stored per node (EMPTY / SELF / CHILDREN) and V* is
reconstructed by a root walk, keeping the DP allocation-free.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .. import tracing
from .squadtree import SQuadTree

EMPTY, SELF, CHILDREN = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class SelectParams:
    alpha_io: float = 1.0
    alpha_cpu: float = 0.05
    alpha_merge: float = 0.01


def _elist_all(tree: SQuadTree) -> np.ndarray:
    """All-node E-list sizes, memoized on the tree (query-invariant — the
    serving layer's pooled select runs every engine step, and re-walking the
    CSR for a static vector was its dominant per-step setup cost)."""
    el = getattr(tree, "_elist_all_cache", None)
    if el is None:
        el = tree.elist_size(np.arange(tree.n_nodes)).astype(np.float64)
        el.setflags(write=False)
        tree._elist_all_cache = el
    return el


def node_costs_base(tree: SQuadTree, driven_cs: np.ndarray,
                    params: SelectParams,
                    card_all: np.ndarray | None = None
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Block-invariant (base_cost, xi) per node; cost(a) = base where a ∈ V.

    Multi-query form: `driven_cs` may be a list of per-block CS arrays (or
    `card_all` a precomputed ``(B, N)`` stack) — `base` then carries one
    cost row per block; `xi` stays CS-independent.
    """
    if card_all is None:
        if isinstance(driven_cs, (list, tuple)):
            card_all = np.stack([tree.cs_stats.cardinality_all(c)
                                 for c in driven_cs])
        else:
            card_all = tree.cs_stats.cardinality_all(driven_cs)
    el = _elist_all(tree)
    base = params.alpha_io * card_all + params.alpha_cpu * el
    xi = params.alpha_merge * el
    return base, xi


@tracing.spanned("sip.node_select")
def select_batch(tree: SQuadTree, in_v: np.ndarray, driven_cs: np.ndarray,
                 params: SelectParams = SelectParams(),
                 card_all: np.ndarray | None = None) -> list[np.ndarray]:
    """V* for a batch of candidate masks at once.

    `in_v` is ``(B, n_nodes)`` — one Phase-1 mask per driver block. The DP
    recurrences run over all B blocks per level (the per-node cost/xi
    material is block-invariant, so it is computed once), the per-level
    node sets come from the tree's level buckets instead of an O(N) rescan,
    and V* is reconstructed by a vectorized top-down per-level sweep.
    Returns a list of B sorted node-index arrays, equal to the reference's
    `select_batch` (and its looped oracle) per block.

    Multi-query form: pass `driven_cs` as a list of per-block CS arrays, or
    `card_all` as a precomputed ``(B, N)`` stack — each block's DP then runs
    under its own query's cost row (the serving layer's cross-query batch).
    """
    in_v = np.atleast_2d(np.asarray(in_v, dtype=bool))
    n_b, n = in_v.shape
    assert n == tree.n_nodes
    base, xi = node_costs_base(tree, driven_cs, params, card_all)

    children = tree.node_children
    # The DP state of node `a` can only be non-trivial when subtree(a)
    # intersects some block's V (nonempty needs in_v at `a` or a live
    # descendant), so the whole sweep runs over a *compact* ancestor
    # closure of the union candidate set — everything outside keeps its
    # zero/EMPTY state implicitly, exactly as in the looped oracle.
    relevant = in_v.any(axis=0)                     # (N,)
    parent = tree.node_parent
    for lvl in range(tree.n_levels - 1, 0, -1):
        nodes = tree.level_nodes(lvl)
        rel = nodes[relevant[nodes]]
        if len(rel):
            relevant[parent[rel]] = True
    ridx = np.flatnonzero(relevant)                 # sorted node ids
    n_r = len(ridx)
    if n_r == 0:
        return [np.empty(0, dtype=np.int64) for _ in range(n_b)]
    rank = np.full(n, -1, dtype=np.int64)
    rank[ridx] = np.arange(n_r)

    in_v_r = in_v[:, ridx]                          # (B, R)
    base_r = base[:, ridx] if base.ndim == 2 else base[ridx][None]
    cost = np.where(in_v_r, base_r, 0.0)
    xi_r = xi[ridx]
    sigma = np.zeros((n_b, n_r))                    # sigma*(a)
    xistar = np.zeros((n_b, n_r))                   # xi*(a)
    nonempty = np.zeros((n_b, n_r), dtype=bool)
    decision = np.full((n_b, n_r), EMPTY, dtype=np.int8)

    # per-level compact node sets + remapped children, reused top-down
    lvl_local, lvl_kid_rank, lvl_kid_valid = [], [], []
    for lvl in range(tree.n_levels):
        nodes = tree.level_nodes(lvl)
        nodes = nodes[relevant[nodes]]
        kids = children[nodes]                      # (m, 4)
        kid_rank = rank[np.where(kids >= 0, kids, 0)]
        # a child outside the closure can never be nonempty: drop it
        valid = (kids >= 0) & (kid_rank >= 0)
        lvl_local.append(rank[nodes])
        lvl_kid_rank.append(np.where(valid, kid_rank, 0))
        lvl_kid_valid.append(valid)

    # bottom-up: one vectorized sweep per level bucket, deepest first (the
    # recurrences only reference children, which live one level down)
    for lvl in range(tree.n_levels - 1, -1, -1):
        local = lvl_local[lvl]
        if len(local) == 0:
            continue
        valid, kid_idx = lvl_kid_valid[lvl], lvl_kid_rank[lvl]
        live = valid[None] & nonempty[:, kid_idx]   # (B, m, 4)
        n_live = live.sum(axis=2)
        xi_children = np.where(live, xistar[:, kid_idx], 0.0).sum(axis=2)
        mu = np.where(n_live > 1, xi_children, 0.0)
        sig_children = np.where(live, sigma[:, kid_idx], 0.0).sum(axis=2) + mu
        v = in_v_r[:, local]
        # SELF when: in V and (no live children or cost <= children cost)
        take_self = v & ((n_live == 0) | (cost[:, local] <= sig_children))
        take_kids = (~take_self) & (n_live > 0)
        decision[:, local] = np.where(take_self, SELF,
                                      np.where(take_kids, CHILDREN, EMPTY))
        sigma[:, local] = np.where(take_self, cost[:, local],
                                   np.where(take_kids, sig_children, 0.0))
        xistar[:, local] = np.where(take_self, xi_r[None, local],
                                    np.where(take_kids, xi_children, 0.0))
        nonempty[:, local] = take_self | take_kids

    # top-down reconstruction: propagate reachability level by level
    selected = np.zeros((n_b, n_r), dtype=bool)
    reach = np.zeros((n_b, n_r), dtype=bool)
    if rank[0] >= 0:
        reach[:, rank[0]] = True
    for lvl in range(tree.n_levels):
        local = lvl_local[lvl]
        if len(local) == 0:
            continue
        r = reach[:, local]
        dec = decision[:, local]
        selected[:, local] = r & (dec == SELF)
        expand = r & (dec == CHILDREN)              # (B, m)
        if not expand.any():
            continue
        valid, kid_idx = lvl_kid_valid[lvl], lvl_kid_rank[lvl]
        vi, qi = np.nonzero(valid)
        kn = kid_idx[vi, qi]
        reach[:, kn] = expand[:, vi] & nonempty[:, kn]
    return [ridx[np.flatnonzero(selected[b])] for b in range(n_b)]


def select(tree: SQuadTree, in_v: np.ndarray, driven_cs: np.ndarray,
           params: SelectParams = SelectParams(),
           card_all: np.ndarray | None = None) -> np.ndarray:
    """Compute V* (node indices). Empty when V is empty.

    Single-block entry point over `select_batch` (B = 1)."""
    in_v = np.asarray(in_v, dtype=bool)
    if not in_v.any():
        return np.empty(0, dtype=np.int64)
    return select_batch(tree, in_v[None], driven_cs, params, card_all)[0]
