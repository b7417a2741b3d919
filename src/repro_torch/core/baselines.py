"""Baseline engines the paper compares against (§4, §5).

- FullScanEngine ("PostgreSQL-like"): full joins of both sub-queries, a
  spatial-index nested-loop filter (cell-list, gist-style), full scoring,
  sort, LIMIT k. No top-k early termination — its runtime is k-independent,
  reproducing the paper's Fig. 12 observation.
- SyncRTreeEngine: the STREAK block pipeline with the S-QuadTree spatial join
  swapped for synchronous R-tree traversal [Brinkhoff '93] and CS/SIP
  disabled — the paper's run-time switch used for Fig. 8.
- Fixed-plan engines: APS disabled, always-N or always-S (Fig. 9 / 12).

Every engine runs its kernels on its device: CUDA unless the caller names
another one, and it raises without CUDA. The full scan's relational joins
rank on the host (numpy), so the oracle does not lean on the rank kernel;
its exact-geometry refinement and pair distances run the refinement kernel
(`bucketed_min_core`) on the device, as STREAK's do.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from . import rtree, spatial_join
from .executor import ExecConfig, StreakEngine
from .fault import QueryDeadline
from .join import Relation, join, scan_pattern
from .planner import plan_query
from .query import Query
from .store import QuadStore

# the full scan's rank route: host numpy, the reference's default off a TPU
ORACLE_RANK = "numpy"


@dataclasses.dataclass
class BaselineStats:
    rows_joined: int = 0
    pairs_checked: int = 0
    candidates: int = 0


class FullScanEngine:
    """Evaluate everything, sort at the end (no early termination).

    Also the brute-force differential oracle for every non-top-k query
    shape (core/shapes.py): range / within-distance selections, per-driver
    kNN, and the non-top-k spatial join skip all index pruning here — full
    cartesian candidate sets, per-entity python predicate loops — but score
    with the same exact-geometry primitives, so results are bit-identical
    to the engine when (and only when) the engine's pruning is lossless.
    """

    def __init__(self, store: QuadStore,
                 device: torch.device | str | None = None):
        self.store = store
        self.device = resolve_device(device, "FullScanEngine")

    def _plan(self, q: Query):
        return plan_query(self.store, q, rank_backend=ORACLE_RANK)

    def _full_side(self, side) -> Relation:
        store = self.store
        if not side.all_ordered:
            return Relation({side.entity_var:
                             np.unique(store.tree.obj_ids)})
        rel = scan_pattern(store, side.all_ordered[0])
        for tp in side.all_ordered[1:]:
            rel = join(rel, scan_pattern(store, tp), backend=ORACLE_RANK)
        return rel

    def execute(self, q: Query) -> tuple[np.ndarray, Relation, BaselineStats]:
        store = self.store
        stats = BaselineStats()
        if q.spatial is not None and q.shape() != "topk":
            return self._execute_shape(q, stats)
        plan = self._plan(q)
        driver, driven = plan.driver, plan.driven
        full_side = self._full_side

        drv = full_side(driver)
        dvn = full_side(driven)
        stats.rows_joined = drv.n + dvn.n

        ua = np.unique(drv[driver.entity_var])
        ub = np.unique(dvn[driven.entity_var])
        ba, bb = store.spatial_box_of(ua), store.spatial_box_of(ub)
        ok_a, ok_b = ~np.isnan(ba[:, 0]), ~np.isnan(bb[:, 0])
        ua, ba = ua[ok_a], ba[ok_a]
        ub, bb = ub[ok_b], bb[ok_b]
        # gist-style filter: cell-list candidate pairs on MBR centroids
        from .squadtree import radius_join
        ca = (ba[:, :2] + ba[:, 2:]) * 0.5
        cb = (bb[:, :2] + bb[:, 2:]) * 0.5
        diag_a = np.sqrt(((ba[:, 2:] - ba[:, :2]) ** 2).sum(1))
        diag_b = np.sqrt(((bb[:, 2:] - bb[:, :2]) ** 2).sum(1))
        slack = float(diag_a.max(initial=0.0) + diag_b.max(initial=0.0)) / 2.0
        pi, pj = radius_join(ca, cb, plan.dist_norm + slack)
        stats.pairs_checked = len(pi)
        keep = spatial_join.refine(
            pi, pj, store.geom_pool,
            store.geom_rows(ua[pi]), store.geom_rows(ub[pj]),
            plan.dist_world, plan.metric, device=self.device)
        pi, pj = pi[keep], pj[keep]
        stats.candidates = len(pi)
        pair_rel = Relation({driver.entity_var: ua[pi],
                             driven.entity_var: ub[pj]})
        out = join(join(drv, pair_rel, backend=ORACLE_RANK), dvn,
                   backend=ORACLE_RANK)
        # full scoring + sort + LIMIT k
        keys = np.zeros(out.n)
        for side in (driver, driven):
            for tp, var, w in side.quant_terms:
                kw = w if plan.descending else -w
                keys += kw * store.values_of(out[var])
        valid = ~np.isnan(keys)
        out, keys = out.take(np.flatnonzero(valid)), keys[valid]
        order = np.argsort(-keys, kind="stable")[: plan.k]
        scores = keys[order] if plan.descending else -keys[order]
        return scores, out.take(order), stats

    # -- non-top-k shape oracles (core/shapes.py differential targets) ----
    def _execute_shape(self, q: Query, stats: BaselineStats):
        from . import shapes
        store = self.store
        plan = self._plan(q)
        shape = plan.shape
        pool = store.geom_pool

        def ents_of(rel, var):
            return shapes._ents_boxes(store, rel, var)[0]

        def geom_slices(ents):
            rows = store.geom_rows(ents)
            off = pool.offsets
            return [pool.points[off[r]:off[r + 1]].astype(np.float64)
                    for r in rows]

        drv = self._full_side(plan.driver)
        stats.rows_joined += drv.n
        a_ents = ents_of(drv, plan.driver.entity_var)

        if shape == "range":
            xmin, ymin, xmax, ymax = (float(v) for v in q.spatial.window)
            hit = np.array(
                [bool(((g[:, 0] >= xmin) & (g[:, 0] <= xmax)
                       & (g[:, 1] >= ymin) & (g[:, 1] <= ymax)).any())
                 for g in geom_slices(a_ents)], dtype=bool) \
                if len(a_ents) else np.zeros(0, dtype=bool)
            qual = a_ents[hit]
            stats.candidates = len(qual)
            scores, rows = shapes._select_rows(
                drv, plan.driver.entity_var, qual, np.zeros(len(qual)))
            return scores, rows, stats

        if shape == "within":
            from . import geometry
            c = np.asarray(q.spatial.center, dtype=np.float64)
            dist_fn = (geometry.haversine_km if plan.metric == "haversine"
                       else geometry.euclid_dist)
            d = np.array([float(dist_fn(g, c[None, :]).min())
                          for g in geom_slices(a_ents)], dtype=np.float64) \
                if len(a_ents) else np.zeros(0)
            ok = d <= float(plan.dist_world)
            qual, dq = a_ents[ok], d[ok]
            stats.candidates = len(qual)
            scores, rows = shapes._select_rows(
                drv, plan.driver.entity_var, qual, dq)
            return scores, rows, stats

        # binary shapes: full cartesian candidate pairs, exact distances
        # (na x nb pairs go through host-built refinement tiles: keep the
        # stores small enough for that)
        dvn = self._full_side(plan.driven)
        stats.rows_joined += dvn.n
        b_ents = ents_of(dvn, plan.driven.entity_var)
        na, nb = len(a_ents), len(b_ents)
        pi = np.repeat(np.arange(na, dtype=np.int64), nb)
        pj = np.tile(np.arange(nb, dtype=np.int64), na)
        stats.pairs_checked = len(pi)
        d = spatial_join.exact_pair_distance(
            pool, store.geom_rows(a_ents)[pi], store.geom_rows(b_ents)[pj],
            plan.metric, device=self.device)

        if shape == "join":
            ok = d <= float(plan.dist_world)
            pi, pj, d = pi[ok], pj[ok], d[ok]
        else:   # knn: k smallest per driver by (distance, driven entity)
            k = int(q.spatial.knn)
            order = np.lexsort((b_ents[pj], d, pi))
            pi, pj, d = pi[order], pj[order], d[order]
            first = np.r_[True, pi[1:] != pi[:-1]] if len(pi) \
                else np.zeros(0, dtype=bool)
            grp = np.flatnonzero(first)
            width = np.diff(np.r_[grp, len(pi)])
            rank = np.arange(len(pi), dtype=np.int64) - np.repeat(grp, width)
            sel = rank < k
            pi, pj, d = pi[sel], pj[sel], d[sel]
        stats.candidates = len(pi)
        scores, rows = shapes._assemble_pairs(
            self, plan, drv, dvn, a_ents[pi], b_ents[pj], d)
        return scores, rows, stats


class SyncRTreeEngine(StreakEngine):
    """STREAK with the spatial join swapped for sync R-tree traversal.

    CS pruning and SIP are disabled (an R-tree has neither); the driven side
    is always the full driven sub-query (S-Plan shape without SIP). Candidate
    counts are recorded for the Fig. 8 comparison. The traversal is host
    numpy; driven retrieval and refinement run their kernels on the device.
    """

    def __init__(self, store: QuadStore, config: ExecConfig | None = None,
                 fanout: int = 16, device: torch.device | str | None = None):
        cfg = config or ExecConfig()
        # reuse the full pipeline; only the Phase-3 MBR join differs
        cfg = dataclasses.replace(cfg, use_sip=False, force_plan="S",
                                  mbr_join_fn=self._rtree_join)
        super().__init__(store, cfg, device=resolve_device(
            device, "SyncRTreeEngine"))
        self.fanout = fanout
        self._sync_stats = rtree.SyncJoinStats()

    def _rtree_join(self, driver_boxes, driven_boxes, dist_norm,
                    backend="numpy", stats=None):
        ta = rtree.build_str(driver_boxes, self.fanout)
        tb = rtree.build_str(driven_boxes, self.fanout)
        i, j = rtree.sync_distance_join(ta, tb, dist_norm, self._sync_stats)
        if stats is not None:
            stats.candidates += len(i)
            stats.pairs_tested += self._sync_stats.node_pairs_visited
        return i, j

    def execute(self, q: Query, deadline: QueryDeadline | None = None):
        self._sync_stats = rtree.SyncJoinStats()
        return super().execute(q, deadline)


def fixed_plan_engine(store: QuadStore, plan: str,
                      config: ExecConfig | None = None,
                      device: torch.device | str | None = None
                      ) -> StreakEngine:
    cfg = config or ExecConfig()
    return StreakEngine(store, dataclasses.replace(cfg, force_plan=plan),
                        device=resolve_device(device, "fixed_plan_engine"))
