"""Geographica-shaped query execution: range / within-distance / kNN /
non-top-k spatial join.

The paper's engine runs one query shape — the top-k distance join. The
standard geospatial-RDF benchmarks (Geographica / Geographica 2) mix four
more, and this module executes them on the SAME machinery the top-k cursor
uses: `plan_query` splits the sides, SIP Phases 1-2 run through
`shard.sip_select` (batched frontier or fused descent, Bloom probes,
I-Range/E-list material), Phase 3 goes through `mbr_distance_join` (any
backend) and the bucketed exact-geometry kernel (`exact_pair_distance`),
and relational assembly reuses the merge-join core. Every kernel runs on
the engine's device. All backends give the same rows and scores. Each
shape has a brute-force oracle in `core/baselines.py` (`FullScanEngine`)
that must be bit-identical — the differential fuzzer
(tests/test_torch_fuzz_queries.py) holds every backend and shard count
to it.

Shape semantics (geometries are the exact point sets in the CSR pool):

- **range** — unary. A binding qualifies iff its entity's geometry has at
  least one point inside the CLOSED world window. Scores are all 0.0.
- **within** — unary. Qualifies iff min distance from the geometry to the
  world center point is <= ``dist``; the score is that distance.
- **knn** — binary, directional. Per driver (?a) entity, the ``knn``
  nearest distinct driven (?b) entities by exact min geometry distance
  (ties on distance break toward the smaller driven entity id). Fewer
  than k candidates ⟹ a SHORT list, never padding, never an error.
- **join** — binary, no ranking. Every (?a, ?b) entity pair with exact
  distance <= ``dist``; the score is the pair distance.

Selections return ALL qualifying rows (`Query.k` is ignored; Geographica
selections are not top-k), in a canonical deterministic order so every
backend and device returns them bit-identically: entity column(s) first,
then the pair distance, then the remaining columns lexicographically by
name.
"""
from __future__ import annotations

import numpy as np

from . import shard as shard_mod, spatial_join
from .fault import QueryDeadline
from .join import Relation, join
from .planner import QueryPlan, plan_query
from .query import Query

COVER_NORM = float(np.sqrt(2.0))    # normalized-space diameter bound


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------

def _side_rel(engine, side, plan: QueryPlan) -> Relation:
    """Fully-joined relation of one side; a pattern-less side means "every
    spatial entity"."""
    if not side.all_ordered:
        return Relation({side.entity_var:
                         np.unique(engine.store.tree.obj_ids)})
    return engine._driven_full(side, plan.join_impl, plan.rank_backend)


def _ents_boxes(store, rel: Relation, var: str
                ) -> tuple[np.ndarray, np.ndarray]:
    """Sorted unique entities of `rel[var]` that have geometry, plus their
    normalized MBRs."""
    if rel.n == 0 or var not in rel:
        return np.empty(0, np.int64), np.zeros((0, 4))
    ents = np.unique(rel[var])
    boxes = store.spatial_box_of(ents)
    ok = ~np.isnan(boxes[:, 0])
    return ents[ok], boxes[ok]


class _Sip:
    """Per-query SIP state (Phases 1-2 across shard views), reusable across
    driver chunks / kNN rounds — the same prepared Bloom keys, root-path
    masks, and per-shard CS cardinalities the top-k cursor precomputes.
    Probes and the descent run on the engine's device."""

    def __init__(self, engine, plan: QueryPlan):
        cfg = engine.config
        self.engine = engine
        self.plan = plan
        self.enabled = bool(cfg.use_sip) and engine.store.tree is not None
        self.shards = (shard_mod.shard_views(engine.store) if self.enabled
                       else shard_mod.whole_view(engine.store))
        if not self.enabled:
            return
        tree = engine.store.tree
        self.prepared = tree.bloom_self.prepare(plan.driven_cs)
        self.card_all = [sh.tree.cs_stats.cardinality_all(plan.driven_cs)
                         for sh in self.shards]
        self.cs_path = (
            [sh.tree.cs_path_mask(plan.driven_cs, prepared=self.prepared,
                                  probe_backend=plan.probe_backend,
                                  device=engine.device)
             for sh in self.shards]
            if plan.descend_backend != "numpy" else None)

    def filter(self, box_sets: list, dist_norm: float, ents: np.ndarray,
               stats) -> list[np.ndarray]:
        """One batched Phases-1-2 call over `box_sets` (one entry per driver
        chunk), then per-chunk boolean masks over the sorted unique entity
        array `ents` — an entity survives a chunk iff ANY shard's I-Range /
        E-list material covers it (shard materials partition the id space,
        so the union is exact)."""
        if not self.enabled:
            return [np.ones(len(ents), dtype=bool) for _ in box_sets]
        plan, cfg = self.plan, self.engine.config
        v_stars = shard_mod.sip_select(
            self.shards, box_sets, dist_norm, plan.driven_cs, self.prepared,
            plan.probe_backend, plan.descend_backend, self.cs_path,
            cfg.select_params, self.card_all, self.engine.device)
        masks = []
        for v_star in v_stars:
            stats.v_star_sizes.append(sum(len(v) for v in v_star))
            keep = np.zeros(len(ents), dtype=bool)
            for si, sh in enumerate(self.shards):
                if len(v_star[si]) == 0:
                    continue
                intervals, explicit = sh.filter_material(v_star[si])
                keep |= _material_mask(ents, intervals, explicit)
            masks.append(keep)
        return masks


def _material_mask(ents: np.ndarray, intervals: np.ndarray,
                   explicit: np.ndarray) -> np.ndarray:
    """SIP membership of sorted ids in I-Range intervals / E-list ids —
    the array-side twin of `join.filter_in_ranges`."""
    keep = np.zeros(len(ents), dtype=bool)
    if len(ents) == 0:
        return keep
    if len(intervals):
        iv = intervals[np.argsort(intervals[:, 0])]
        starts = iv[:, 0]
        ends = np.maximum.accumulate(iv[:, 1])
        pos = np.searchsorted(starts, ents, "right") - 1
        ok = pos >= 0
        keep[ok] = ents[ok] <= ends[np.clip(pos[ok], 0, len(ends) - 1)]
    if len(explicit):
        pos = np.clip(np.searchsorted(explicit, ents), 0, len(explicit) - 1)
        keep |= explicit[pos] == ents
    return keep


def _canonical_order(rows: Relation, primary: list[str],
                     scores: np.ndarray | None = None) -> np.ndarray:
    """Deterministic output permutation: `primary` columns (major first),
    then the score, then every remaining column by name."""
    keys: list[np.ndarray] = []
    for c in primary:
        if c in rows:
            keys.append(rows[c])
    if scores is not None:
        keys.append(scores)
    for c in sorted(rows.keys()):
        if c not in primary:
            keys.append(rows[c])
    if not keys or len(keys[0]) == 0:
        return np.empty(0, dtype=np.int64)
    return np.lexsort(tuple(reversed(keys)))


def _pair_scores(rows: Relation, a_var: str, b_var: str,
                 pa: np.ndarray, pb: np.ndarray,
                 d: np.ndarray) -> np.ndarray:
    """Per-row distance lookup: (pa, pb, d) lists unique qualifying entity
    pairs; every (a_var, b_var) value pair in `rows` is one of them.

    Entity ids are dictionary hashes (~2^62), so keying on raw
    ``a * span + b`` would wrap int64 and collide; compress both columns
    to dense ranks first."""
    if rows.n == 0:
        return np.empty(0, dtype=np.float64)
    ua, ub = np.unique(pa), np.unique(pb)
    span = np.int64(len(ub) + 1)
    key = np.searchsorted(ua, pa) * span + np.searchsorted(ub, pb)
    order = np.argsort(key)
    rk = (np.searchsorted(ua, rows[a_var]) * span
          + np.searchsorted(ub, rows[b_var]))
    pos = np.searchsorted(key[order], rk)
    return d[order[np.clip(pos, 0, len(order) - 1)]]


def _assemble_pairs(engine, plan: QueryPlan, drv_rel: Relation,
                    dvn_rel: Relation, a_ents: np.ndarray,
                    b_ents: np.ndarray, d: np.ndarray
                    ) -> tuple[np.ndarray, Relation]:
    """Join qualifying (a, b) entity pairs back through both sides' full
    relations and order canonically with per-row pair distances. Shared
    with the FullScan oracles (`engine` is then the `FullScanEngine`):
    output assembly is plumbing, the candidate generation it consumes is
    what the differential tests exercise."""
    a_var = plan.driver.entity_var
    b_var = plan.driven.entity_var
    pair_rel = Relation({a_var: a_ents, b_var: b_ents})
    out = join(drv_rel, pair_rel, impl=plan.join_impl,
               backend=plan.rank_backend, device=engine.device)
    out = join(out, dvn_rel, impl=plan.join_impl, backend=plan.rank_backend,
               device=engine.device)
    scores = _pair_scores(out, a_var, b_var, a_ents, b_ents, d)
    order = _canonical_order(out, [a_var], scores)
    return scores[order], out.take(order)


def _chunks(n: int, size: int) -> list[np.ndarray]:
    size = max(int(size), 1)
    return [np.arange(s, min(s + size, n), dtype=np.int64)
            for s in range(0, n, size)] or []


# ---------------------------------------------------------------------------
# shape executors
# ---------------------------------------------------------------------------

def execute_shape(engine, q: Query, deadline: QueryDeadline | None = None):
    """Execute a non-top-k shape on a `StreakEngine`. Returns
    (scores, rows, ExecStats) with the canonical deterministic ordering."""
    from .executor import ExecStats   # lazy: executor imports this module
    cfg = engine.config
    plan = plan_query(engine.store, q, force_driver=cfg.force_driver,
                      policy=cfg.policy)
    stats = ExecStats()
    if plan.shape == "range":
        scores, rows = _exec_range(engine, q, plan, stats)
    elif plan.shape == "within":
        scores, rows = _exec_within(engine, q, plan, stats)
    elif plan.shape == "knn":
        scores, rows = _exec_knn(engine, q, plan, stats, deadline)
    elif plan.shape == "join":
        scores, rows = _exec_join(engine, q, plan, stats, deadline)
    else:
        raise ValueError(f"not a shape query: {plan.shape!r}")
    return scores, rows, stats


def _select_rows(rel: Relation, var: str, keep_ents: np.ndarray,
                 ent_scores: np.ndarray) -> tuple[np.ndarray, Relation]:
    """Filter a selection's relation to qualifying entities and order
    canonically; per-row scores follow the entity's score."""
    if rel.n == 0 or len(keep_ents) == 0:
        empty = rel.take(np.empty(0, dtype=np.int64))
        return np.empty(0, dtype=np.float64), empty
    pos = np.searchsorted(keep_ents, rel[var])
    ok = (pos < len(keep_ents)) & \
        (keep_ents[np.clip(pos, 0, len(keep_ents) - 1)] == rel[var])
    out = rel.take(np.flatnonzero(ok))
    scores = ent_scores[np.clip(pos[ok], 0, len(keep_ents) - 1)]
    order = _canonical_order(out, [var], scores)
    return scores[order], out.take(order)


def _exec_range(engine, q: Query, plan: QueryPlan, stats):
    store = engine.store
    rel = _side_rel(engine, plan.driver, plan)
    stats.driven_rows_scanned += rel.n
    ents, boxes = _ents_boxes(store, rel, plan.driver.entity_var)
    win = np.asarray(q.spatial.window, dtype=np.float64)
    ext = store.tree.extent
    win_norm = ext.normalize(win[None, :])[0]
    sip = _Sip(engine, plan)
    stats.driver_blocks += 1
    stats.plan_s += 1
    stats.plan_log.append("S")
    keep = sip.filter([win_norm[None, :]], 0.0, ents, stats)[0]
    # MBR prefilter in normalized space (conservative), exact point-in-
    # window test on the pool only for survivors
    from .geometry import boxes_intersect
    keep &= boxes_intersect(boxes, win_norm[None, :])
    stats.driven_rows_after_sip += int(keep.sum())
    cand = np.flatnonzero(keep)
    hit = spatial_join.pool_points_in_box(
        store.geom_pool, store.geom_rows(ents[cand]), win)
    qual = ents[cand[hit]]
    scores, rows = _select_rows(rel, plan.driver.entity_var, qual,
                                np.zeros(len(qual)))
    stats.results_considered += rows.n
    return scores, rows


def _exec_within(engine, q: Query, plan: QueryPlan, stats):
    store = engine.store
    rel = _side_rel(engine, plan.driver, plan)
    stats.driven_rows_scanned += rel.n
    ents, boxes = _ents_boxes(store, rel, plan.driver.entity_var)
    ext = store.tree.extent
    c = np.asarray(q.spatial.center, dtype=np.float64)
    c_box = ext.normalize(np.array([[c[0], c[1], c[0], c[1]]]))
    sip = _Sip(engine, plan)
    stats.driver_blocks += 1
    stats.plan_s += 1
    stats.plan_log.append("S")
    keep = sip.filter([c_box], plan.dist_norm, ents, stats)[0]
    from .geometry import box_min_dist
    keep &= box_min_dist(boxes, c_box[0][None, :]) <= plan.dist_norm
    stats.driven_rows_after_sip += int(keep.sum())
    cand = np.flatnonzero(keep)
    d = spatial_join.pool_point_min_dist(
        store.geom_pool, store.geom_rows(ents[cand]), c, plan.metric)
    ok = d <= float(plan.dist_world)
    qual, dq = ents[cand[ok]], d[ok]
    scores, rows = _select_rows(rel, plan.driver.entity_var, qual, dq)
    stats.results_considered += rows.n
    return scores, rows


def _exec_join(engine, q: Query, plan: QueryPlan, stats,
               deadline: QueryDeadline | None = None):
    store = engine.store
    cfg = engine.config
    drv_rel = _side_rel(engine, plan.driver, plan)
    dvn_rel = _side_rel(engine, plan.driven, plan)
    stats.driven_rows_scanned += dvn_rel.n
    a_ents, a_boxes = _ents_boxes(store, drv_rel, plan.driver.entity_var)
    b_ents, b_boxes = _ents_boxes(store, dvn_rel, plan.driven.entity_var)
    rows_a_all = store.geom_rows(a_ents)
    rows_b_all = store.geom_rows(b_ents)
    sip = _Sip(engine, plan)
    chunks = _chunks(len(a_ents), cfg.block)
    pa, pb, pd = [], [], []
    if chunks and len(b_ents):
        masks = sip.filter([a_boxes[c] for c in chunks], plan.dist_norm,
                           b_ents, stats)
        for c, keep in zip(chunks, masks):
            if deadline is not None \
                    and deadline.expired(stats.driver_blocks):
                stats.deadline_expired = True
                stats.partial = True
                break
            stats.driver_blocks += 1
            stats.plan_s += 1
            stats.plan_log.append("S")
            cand = np.flatnonzero(keep)
            stats.driven_rows_after_sip += len(cand)
            if len(cand) == 0:
                continue
            pi, pj = spatial_join.mbr_distance_join(
                a_boxes[c], b_boxes[cand], plan.dist_norm,
                plan.join_backend, stats.join, device=engine.device)
            if len(pi) == 0:
                continue
            gi, gj = c[pi], cand[pj]
            d = spatial_join.exact_pair_distance(
                store.geom_pool, rows_a_all[gi], rows_b_all[gj],
                plan.metric, device=engine.device)
            ok = d <= float(plan.dist_world)
            stats.join.refined += int(ok.sum())
            pa.append(gi[ok])
            pb.append(gj[ok])
            pd.append(d[ok])
    if pa:
        ia = np.concatenate(pa)
        ib = np.concatenate(pb)
        dd = np.concatenate(pd)
    else:
        ia = ib = np.empty(0, dtype=np.int64)
        dd = np.empty(0, dtype=np.float64)
    scores, rows = _assemble_pairs(engine, plan, drv_rel, dvn_rel,
                                   a_ents[ia], b_ents[ib], dd)
    stats.results_considered += rows.n
    return scores, rows


def _exec_knn(engine, q: Query, plan: QueryPlan, stats,
              deadline: QueryDeadline | None = None):
    """Per-driver-entity k nearest driven entities, by certified radius
    doubling: a round's MBR join at world radius r finds EVERY pair with
    exact distance <= r (the conservative anisotropic normalization rule,
    see `Extent.denormalize_distance`), so a driver whose k-th nearest
    found candidate lies within r is final. Radii grow geometrically until
    the normalized radius covers the unit square (COVER_NORM), at which
    point the candidate set is complete and every remaining driver —
    including those with fewer than k reachable candidates — certifies
    with a possibly SHORT list."""
    store = engine.store
    k = int(q.spatial.knn)
    if k <= 0:
        raise ValueError(f"knn must be positive, got {k}")
    drv_rel = _side_rel(engine, plan.driver, plan)
    dvn_rel = _side_rel(engine, plan.driven, plan)
    stats.driven_rows_scanned += dvn_rel.n
    a_ents, a_boxes = _ents_boxes(store, drv_rel, plan.driver.entity_var)
    b_ents, b_boxes = _ents_boxes(store, dvn_rel, plan.driven.entity_var)
    rows_a_all = store.geom_rows(a_ents)
    rows_b_all = store.geom_rows(b_ents)
    sip = _Sip(engine, plan)
    ext = store.tree.extent

    res_a: list[np.ndarray] = []
    res_b: list[np.ndarray] = []
    res_d: list[np.ndarray] = []
    unc = np.arange(len(a_ents), dtype=np.int64)
    if len(b_ents) == 0:
        unc = unc[:0]       # nothing reachable: every driver is (empty) done
    r = float(q.spatial.dist) if q.spatial.dist > 0 \
        else min(ext.width, ext.height) / 1024.0
    while len(unc):
        rn = ext.denormalize_distance(r)
        final = rn >= COVER_NORM
        if deadline is not None and deadline.expired(stats.driver_blocks):
            stats.deadline_expired = True
            stats.partial = True
            break
        stats.driver_blocks += 1
        stats.plan_s += 1
        stats.plan_log.append("S")
        keep = sip.filter([a_boxes[unc]], rn, b_ents, stats)[0]
        cand = np.flatnonzero(keep)
        stats.driven_rows_after_sip += len(cand)
        done_rounds = np.zeros(len(unc), dtype=bool)
        if len(cand):
            pi, pj = spatial_join.mbr_distance_join(
                a_boxes[unc], b_boxes[cand], rn, plan.join_backend,
                stats.join, device=engine.device)
            if len(pi):
                gi = unc[pi]                 # global driver index
                gj = cand[pj]                # global driven index
                d = spatial_join.exact_pair_distance(
                    store.geom_pool, rows_a_all[gi], rows_b_all[gj],
                    plan.metric, device=engine.device)
                within = d <= r
                # per-driver certified-candidate counts (complete up to r)
                cnt = np.zeros(len(unc), dtype=np.int64)
                np.add.at(cnt, pi, within.astype(np.int64))
                done_rounds = cnt >= k
                if final:
                    done_rounds[:] = True
                take_pair = done_rounds[pi] & (within | final)
                if take_pair.any():
                    ti = pi[take_pair]
                    td = d[take_pair]
                    tj = gj[take_pair]
                    # k smallest per driver by (distance, driven entity)
                    order = np.lexsort((b_ents[tj], td, ti))
                    ti, td, tj = ti[order], td[order], tj[order]
                    first = np.r_[True, ti[1:] != ti[:-1]]
                    grp = np.flatnonzero(first)
                    width = np.diff(np.r_[grp, len(ti)])
                    rank = (np.arange(len(ti), dtype=np.int64)
                            - np.repeat(grp, width))
                    sel = rank < k
                    res_a.append(unc[ti[sel]])
                    res_b.append(tj[sel])
                    res_d.append(td[sel])
        elif final:
            done_rounds = np.ones(len(unc), dtype=bool)
        if final:
            break
        unc = unc[~done_rounds]
        r *= 4.0
    ia = np.concatenate(res_a) if res_a else np.empty(0, np.int64)
    ib = np.concatenate(res_b) if res_b else np.empty(0, np.int64)
    dd = np.concatenate(res_d) if res_d else np.empty(0, np.float64)
    scores, rows = _assemble_pairs(engine, plan, drv_rel, dvn_rel,
                                   a_ents[ia], b_ents[ib], dd)
    stats.results_considered += rows.n
    return scores, rows


# ---------------------------------------------------------------------------
# cursor adapter
# ---------------------------------------------------------------------------

class ShapeCursor:
    """Cursor-protocol adapter for the non-top-k shapes: the whole shape
    executes in the first `step()`, which finishes the cursor, so
    `StreakEngine.execute` drives it like a `QueryCursor`. The serving
    loop admits the shapes the same way: the whole shape runs inside the
    slot's first `begin_block()` (crash-isolated by the serve loop like
    any per-slot phase), and the call returns None, which retires the slot
    with the results."""

    def __init__(self, engine, q: Query,
                 deadline: QueryDeadline | None = None):
        from .executor import ExecStats
        self.engine = engine
        self.q = q
        self.deadline = deadline
        self.done = False
        self.stats = ExecStats()
        self._scores = np.empty(0, dtype=np.float64)
        self._rows = Relation()

    def _run(self) -> None:
        if not self.done:
            self._scores, self._rows, self.stats = execute_shape(
                self.engine, self.q, deadline=self.deadline)
            self.done = True

    def step(self) -> None:
        self._run()

    def begin_block(self):
        self._run()
        return None

    def finish_block(self, v_stars=None, batcher=None) -> None:
        raise RuntimeError("ShapeCursor.begin_block always returns None")

    def results(self):
        return self._scores, self._rows, self.stats
