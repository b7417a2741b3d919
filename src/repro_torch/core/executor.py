"""STREAK block-wise query execution (paper Figure 5).

Driver bindings are retrieved in score-key order (blocks), each block is
SIP-filtered against the S-QuadTree (Phases 1+2), routed through the APS
decision (N-Plan vs S-Plan) for driven retrieval, spatially joined (Phase 3),
refined, scored, and pushed into the shared top-k state. Early termination
fires when the best possible remaining score key cannot beat theta.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from . import aps, node_select, shard as shard_mod, spatial_join
from .. import tracing
from ..device import resolve_device
from .fault import QueryDeadline
from .join import Relation, filter_in_ranges, join, scan_pattern
from .planner import QueryPlan, SidePlan, plan_query
from .policy import BackendPolicy
from .query import Query, Var
from .spatial_join import JoinStats
from .store import DirectedNumericScan, QuadStore
from .topk import TopK


_SHARE_COUNTERS = {kind: (f"share.hit:{kind}", f"share.miss:{kind}")
                   for kind in ("mat", "splan", "nblk", "mbr", "refine")}


def _shared(sc: dict, key: tuple, kind: str) -> bool:
    """Whether the share cache `sc` holds `key`: one lookup, counted in
    `tracing.COUNTS` as a hit or a miss of `kind`."""
    hit = key in sc
    tracing.count(_SHARE_COUNTERS[kind][0 if hit else 1])
    return hit


@dataclasses.dataclass
class ExecConfig:
    """Engine configuration. Backend selection lives on ``policy``
    (core/policy.BackendPolicy), one frozen value resolved once in
    ``__post_init__``."""
    block: int = 1024
    use_sip: bool = True
    force_plan: str | None = None       # "N" | "S" | None (adaptive)
    force_driver: str | None = None     # "a" | "b" | None
    fused_batch_cols: int = 4096        # driven columns per fused-kernel call
    refine_chunk: int = 1024            # candidate pairs refined per θ check
    sip_lookahead: int = 8              # driver blocks per batched SIP call
    # override of the Phase-3 MBR join (the baselines): called as
    # fn(driver_boxes, driven_boxes, dist_norm, backend, stats) -> (i, j)
    mbr_join_fn: Callable | None = None
    select_params: node_select.SelectParams = dataclasses.field(
        default_factory=node_select.SelectParams)
    cost_params: aps.CostParams = dataclasses.field(
        default_factory=aps.CostParams)
    policy: BackendPolicy | None = None  # backend selection; None = all-auto

    def __post_init__(self) -> None:
        base = self.policy if self.policy is not None else BackendPolicy()
        self.policy = base.resolve()


@dataclasses.dataclass
class ExecStats:
    driver_blocks: int = 0
    plan_n: int = 0
    plan_s: int = 0
    driven_rows_scanned: int = 0
    driven_rows_after_sip: int = 0
    results_considered: int = 0
    early_terminated: bool = False
    # anytime-results contract (the `deadline` argument of execute):
    # `partial` marks a deadline-truncated answer; `score_bound` is the certified key-space
    # bound — no result outside the returned set has a key above it (for a
    # complete run it is simply the final θ)
    partial: bool = False
    deadline_expired: bool = False
    score_bound: float | None = None
    v_star_sizes: list = dataclasses.field(default_factory=list)
    join: JoinStats = dataclasses.field(default_factory=JoinStats)
    plan_log: list = dataclasses.field(default_factory=list)


class StreakEngine:
    def __init__(self, store: QuadStore, config: ExecConfig | None = None,
                 device: torch.device | str | None = None):
        self.store = store
        self.config = config or ExecConfig()
        self.device = resolve_device(device)
        self._scan_cache: dict = {}
        # one tuner per engine: survivor statistics carry across queries,
        # which is exactly the serving workload the autotuner targets
        self.kcap_tuner = (spatial_join.KcapTuner()
                           if self.config.policy.kcap == "auto" else None)
        # cross-tenant work sharing (serve mode): a serving layer sets
        # this to a dict, and per-block sub-results that are PURE functions
        # of (side signature, block) or (side signature, SIP intervals) —
        # driver-block materialization, S-Plan filtered retrieval, N-Plan
        # per-block joins — are memoized so concurrent tenants running the
        # same query shape (e.g. different k) compute them once.
        # θ-dependent work (guards, APS key_needed, N-Plan truncation,
        # TopK) stays per-tenant, so shared results are bit-identical.
        self.share_cache: dict | None = None

    @staticmethod
    def _side_sig(side: SidePlan, plan: QueryPlan) -> tuple:
        """Hashable identity of everything a side's block materialization /
        driven retrieval depends on (patterns fix the primary scan; the
        ranking direction fixes its block order)."""
        return (tuple((tp.g, tp.s, tp.p, tp.o) for tp in side.all_ordered),
                side.entity_var, plan.descending, plan.join_impl,
                plan.rank_backend)

    # ------------------------------------------------------------------
    def _cached_scan(self, tp) -> Relation:
        key = (tp.g, tp.s, tp.p, tp.o)
        if key not in self._scan_cache:
            self._scan_cache[key] = scan_pattern(self.store, tp)
        return self._scan_cache[key]

    def _join_chain(self, base: Relation, patterns: list,
                    impl: str | None = None,
                    backend: str | None = None) -> Relation:
        """Join `base` with each pattern's scan in turn; rank kernels run
        on the engine's device."""
        rel = base
        for tp in patterns:
            if rel.n == 0:
                # empty stays empty, but the schema must stay complete —
                # downstream consumers (and the brute-force oracles) expect
                # every pattern's variables as (empty) columns
                scan = self._cached_scan(tp)
                cols = {c: rel[c] for c in rel.keys()}
                for c in scan.keys():
                    if c not in cols:
                        cols[c] = np.empty(0, dtype=np.int64)
                rel = Relation(cols)
                continue
            rel = join(rel, self._cached_scan(tp), impl=impl, backend=backend,
                       device=self.device)
        return rel

    def _block_relation(self, side: SidePlan, b: int) -> tuple[Relation, np.ndarray]:
        """Relation for one primary-scan block + its score-key values."""
        vals, subj, obj, facts = side.scan.get_block(b)
        tp = side.primary[0]
        rel = Relation()
        if isinstance(tp.s, Var):
            rel[tp.s.name] = subj
        if isinstance(tp.o, Var):
            rel[tp.o.name] = obj
        if isinstance(tp.g, Var):
            rel[tp.g.name] = facts
        return rel, vals

    # score-key weight of a term: flips sign for ascending ranking
    @staticmethod
    def _kw(weight: float, descending: bool) -> float:
        return weight if descending else -weight

    def _side_bound(self, side: SidePlan, descending: bool,
                    exclude_primary: bool) -> float:
        """Best possible score-key contribution from this side's quant terms."""
        total = 0.0
        for tp, var, w in side.quant_terms:
            if exclude_primary and side.primary is not None and tp is side.primary[0]:
                continue
            scan = DirectedNumericScan(self.store.numeric[int(tp.p)], descending)
            kw = self._kw(w, descending)
            v_best = scan.ni.block_max[0] if kw > 0 else scan.ni.block_min[-1]
            total += kw * float(v_best)
        return total

    def _score_key(self, rel: Relation, plan: QueryPlan) -> np.ndarray:
        """Score key per row = sum_i kw_i * value(?v_i)."""
        out = np.zeros(rel.n)
        for side in (plan.driver, plan.driven):
            for tp, var, w in side.quant_terms:
                kw = self._kw(w, plan.descending)
                out += kw * self.store.values_of(rel[var])
        return out

    def _entity_key_bound(self, rel: Relation, ents: np.ndarray,
                          side: SidePlan, plan: QueryPlan) -> np.ndarray:
        """Per-entity upper bound on this side's score-key contribution.

        Any result row pairing entities (e_i, e_j) joins one `rel` row per
        side, so max-over-rows per entity bounds the pair's score key from
        above — the soundness condition for the fused kernel's θ pruning.
        Rows whose contribution is NaN (entity lacks a value) can never
        score and count as -inf; an entity with only such rows gets -inf.
        """
        contrib = np.zeros(rel.n)
        for tp, var, w in side.quant_terms:
            kw = self._kw(w, plan.descending)
            contrib += kw * self.store.values_of(rel[var])
        contrib = np.where(np.isnan(contrib), -np.inf, contrib)
        out = np.full(len(ents), -np.inf)
        ent_col = rel[side.entity_var]
        pos = np.searchsorted(ents, ent_col)        # ents is sorted unique
        ok = (pos < len(ents)) & \
            (ents[np.minimum(pos, len(ents) - 1)] == ent_col)
        np.maximum.at(out, pos[ok], contrib[ok])
        return out

    def _emit_pairs(self, pi: np.ndarray, pj: np.ndarray,
                    uniq_ents: np.ndarray, dvn_ents: np.ndarray,
                    drv_rel: Relation, dvn_rel: Relation,
                    driver: SidePlan, driven: SidePlan, plan: QueryPlan,
                    topk: TopK, stats: ExecStats,
                    ds: np.ndarray | None = None,
                    vs: np.ndarray | None = None,
                    rid: int | None = None) -> None:
        """θ-aware refinement: order pairs by key bound, refine in chunks.

        Candidate pairs are sorted by descending score-key bound
        ``ds[i] + vs[j]`` (an upper bound on any result row the pair can
        produce, see `_entity_key_bound`), refined chunk-wise against the
        exact geometry pool, and survivors are scored and pushed into the
        top-k *between* chunks — so once the best remaining bound cannot
        beat θ, the whole tail of candidate pairs is skipped without ever
        touching its geometry (the paper's early termination applied to the
        refinement stage itself). One `refine.emit` span, on behalf of
        request `rid` (None: the open span's).
        """
        with tracing.span("refine.emit", rid):
            if len(pi) == 0:
                return
            store = self.store
            if ds is None:
                ds = self._entity_key_bound(drv_rel, uniq_ents, driver, plan)
            if vs is None:
                vs = self._entity_key_bound(dvn_rel, dvn_ents, driven, plan)
            bounds = ds[pi] + vs[pj]
            order = np.argsort(-bounds, kind="stable")
            pi, pj, bounds = pi[order], pj[order], bounds[order]
            # resolve pool rows once per unique entity, gather per pair
            rows_a = store.geom_rows(uniq_ents)[pi]
            rows_b = store.geom_rows(dvn_ents)[pj]
            chunk = max(int(self.config.refine_chunk), 1)
            for start in range(0, len(pi), chunk):
                # bounds are sorted: bounds[start] caps every remaining pair
                if topk.full and bounds[start] <= topk.theta:
                    stats.join.refine_skipped += len(pi) - start
                    break
                end = min(start + chunk, len(pi))
                # exact-geometry chunk verdicts are pure in (pool rows,
                # distance, metric); same-shape tenants chunk identically
                # (same pairs, same bound order), so serve mode shares them
                sc = self.share_cache
                rkey = None
                if sc is not None:
                    rkey = ("refine", plan.metric, float(plan.dist_world),
                            rows_a[start:end].tobytes(),
                            rows_b[start:end].tobytes())
                if rkey is not None and _shared(sc, rkey, "refine"):
                    keep = sc[rkey]
                else:
                    with tracing.span("refine.exact"):
                        keep = spatial_join.refine(
                            pi[start:end], pj[start:end], store.geom_pool,
                            rows_a[start:end], rows_b[start:end],
                            plan.dist_world, plan.metric, stats.join,
                            device=self.device)
                    if rkey is not None:
                        sc[rkey] = keep
                ci, cj = pi[start:end][keep], pj[start:end][keep]
                if len(ci) == 0:
                    continue
                pair_rel = Relation({driver.entity_var: uniq_ents[ci],
                                     driven.entity_var: dvn_ents[cj]})
                out = join(drv_rel, pair_rel, impl=plan.join_impl,
                           backend=plan.rank_backend, device=self.device)
                out = join(out, dvn_rel, impl=plan.join_impl,
                           backend=plan.rank_backend, device=self.device)
                if out.n == 0:
                    continue
                keys = self._score_key(out, plan)
                valid = ~np.isnan(keys)
                out, keys = out.take(np.flatnonzero(valid)), keys[valid]
                stats.results_considered += out.n
                topk.push(keys, out)

    # ------------------------------------------------------------------
    @tracing.spanned("exec.execute")
    def execute(self, q: Query, deadline: QueryDeadline | None = None
                ) -> tuple[np.ndarray, Relation, ExecStats]:
        cur = self.cursor(q, deadline=deadline)
        while not cur.done:
            cur.step()
        return cur.results()

    def cursor(self, q: Query, deadline: QueryDeadline | None = None):
        """Steppable execution state (one driver block per step). Non-top-k
        shapes (range / within / kNN / spatial join, core/shapes.py) return
        a `ShapeCursor` speaking the same protocol."""
        if q.spatial is not None and q.shape() != "topk":
            from .shapes import ShapeCursor   # shapes imports this module
            return ShapeCursor(self, q, deadline=deadline)
        return QueryCursor(self, q, deadline=deadline)

    # ------------------------------------------------------------------
    def _driven_full(self, driven: SidePlan, impl: str | None,
                     backend: str | None = None) -> Relation:
        """Fully-joined driven sub-query, cached per query (S-Plan is a
        full scan per the paper; only the SIP filter varies per block)."""
        # key on the pattern *contents*: id(tp) can collide after pattern
        # objects are garbage-collected, silently reusing a stale relation
        key = ("__driven_full", impl, backend) \
            + tuple((tp.g, tp.s, tp.p, tp.o) for tp in driven.all_ordered)
        if key not in self._scan_cache:
            rel = self._cached_scan(driven.all_ordered[0])
            rel = self._join_chain(rel, driven.all_ordered[1:], impl, backend)
            self._scan_cache[key] = rel
        return self._scan_cache[key]

    @tracing.spanned("driven.splan")
    def _driven_splan(self, driven: SidePlan, plan: QueryPlan, intervals,
                      explicit, stats: ExecStats) -> Relation:
        """S-Plan: spatial join pushed down -- one full scan of the driven
        sub-query (cached), then I-Range/E-list skipping of its rows."""
        rel = self._driven_full(driven, plan.join_impl, plan.rank_backend)
        stats.driven_rows_scanned += rel.n
        if self.config.use_sip and driven.entity_var in rel:
            sc, key = self.share_cache, None
            if sc is not None:
                key = ("splan", self._side_sig(driven, plan),
                       intervals.tobytes(), explicit.tobytes())
            if key is not None and _shared(sc, key, "splan"):
                rel = sc[key]
            else:
                rel = filter_in_ranges(rel, driven.entity_var, intervals,
                                       explicit, impl=plan.join_impl,
                                       backend=plan.rank_backend,
                                       device=self.device)
                if key is not None:
                    sc[key] = rel
        stats.driven_rows_after_sip += rel.n
        return rel

    @tracing.spanned("driven.nplan")
    def _driven_nplan(self, driven: SidePlan, plan: QueryPlan, intervals,
                      explicit, key_needed: float, stats: ExecStats) -> Relation:
        """N-Plan: numeric predicate pushed down -- block-wise driven scan in
        score-key order with SIP skipping and threshold early termination."""
        cfg = self.config
        parts: list[Relation] = []
        kw = self._kw(driven.primary[2], plan.descending)
        sc = self.share_cache
        sig = self._side_sig(driven, plan) if sc is not None else None
        for b2 in range(driven.scan.n_blocks):
            best = kw * float(driven.scan.get_block(b2)[0][0])
            if np.isfinite(key_needed) and best <= key_needed:
                break  # no further driven block can reach the threshold
            # the per-block retrieval is θ-independent (only the truncation
            # above is), so concurrent same-shape tenants share it
            key = None
            if sc is not None:
                key = ("nblk", sig, b2, intervals.tobytes(),
                       explicit.tobytes())
            if key is not None and _shared(sc, key, "nblk"):
                scanned, joined = sc[key]
                stats.driven_rows_scanned += scanned
            else:
                block_rel, _ = self._block_relation(driven, b2)
                scanned = block_rel.n
                stats.driven_rows_scanned += scanned
                if cfg.use_sip and driven.entity_var in block_rel:
                    block_rel = filter_in_ranges(block_rel,
                                                 driven.entity_var,
                                                 intervals, explicit,
                                                 impl=plan.join_impl,
                                                 backend=plan.rank_backend,
                                                 device=self.device)
                joined = self._join_chain(block_rel, driven.join_patterns,
                                          plan.join_impl, plan.rank_backend)
                if cfg.use_sip and driven.entity_var not in block_rel \
                        and driven.entity_var in joined:
                    joined = filter_in_ranges(joined, driven.entity_var,
                                              intervals, explicit,
                                              impl=plan.join_impl,
                                              backend=plan.rank_backend,
                                              device=self.device)
                if key is not None:
                    sc[key] = (scanned, joined)
            stats.driven_rows_after_sip += joined.n
            if joined.n:
                parts.append(joined)
        if not parts:
            return Relation()
        cols = parts[0].keys()
        return Relation({c: np.concatenate([p[c] for p in parts]) for c in cols})


class QueryCursor:
    """Steppable execution state of one query: one driver block per step.

    ``execute()`` is literally ``while not done: step()`` — block order, the
    per-block θ checks, and the `sip_lookahead` prefetch window are unchanged
    from the monolithic loop, so serial results are bit-identical to the
    pre-cursor engine.

    The serving layer (serve/spatial.py) instead drives the two-phase form:
    ``begin_block()`` runs the early-termination check, materializes the next
    driver block, and returns the Phase-1/2 *request* (driver boxes + CS
    material) so the server can batch candidate-node search and node
    selection ACROSS queries; ``finish_block(v_star, batcher)`` then runs
    APS + driven retrieval + the Phase-3 join, optionally registering the
    fused join with a cross-query batcher instead of streaming it alone.
    θ pruning is sound at every granularity, so results do not depend on how
    blocks from different queries interleave.

    Kernels run on the engine's device; everything else is host numpy.
    """

    @tracing.spanned("exec.cursor")
    def __init__(self, engine: StreakEngine, q: Query,
                 deadline: QueryDeadline | None = None):
        self.engine = engine
        self.deadline = deadline
        cfg = engine.config
        store = engine.store
        self.tree = store.tree
        with tracing.span("exec.plan"):
            self.plan = plan_query(store, q, force_driver=cfg.force_driver,
                                   policy=cfg.policy)
        self.stats = ExecStats()
        self.topk = TopK(k=self.plan.k, descending=True)  # key space
        self.driver, self.driven = self.plan.driver, self.plan.driven
        self.driver_other = engine._side_bound(
            self.driver, self.plan.descending, exclude_primary=True)
        self.driven_bound = engine._side_bound(
            self.driven, self.plan.descending, exclude_primary=False)
        self.kw_p = (engine._kw(self.driver.primary[2], self.plan.descending)
                     if self.driver.primary else 0.0)
        # shard views: one view on an unsharded store. SIP disabled ⟹ no
        # interval filtering, so a per-shard loop would replicate the
        # driven side — the single global view instead.
        self.shards = (shard_mod.shard_views(store) if cfg.use_sip
                       else shard_mod.whole_view(store)) \
            if store.tree is not None else []
        # per-query (block-invariant) driven-CS cardinality per shard node
        self.card_all = [sh.tree.cs_stats.cardinality_all(self.plan.driven_cs)
                         for sh in self.shards]
        # query-invariant probe material: driven-CS keys hashed once and
        # reused by every frontier level of every window; `prepare` is pure
        # in (keys, bloom geometry) and the shard builder copies the global
        # Bloom geometry, so ONE prepared serves every shard
        self.prepared = (self.tree.bloom_self.prepare(self.plan.driven_cs)
                         if cfg.use_sip else None)
        # fused-descent routes probe the Bloom root paths ONCE per query
        # (block/box-independent, see SQuadTree.cs_path_mask) instead of
        # once per frontier level of every lookahead window — per shard
        self.cs_path = (
            [sh.tree.cs_path_mask(self.plan.driven_cs,
                                  prepared=self.prepared,
                                  probe_backend=self.plan.probe_backend,
                                  device=engine.device)
             for sh in self.shards]
            if cfg.use_sip and self.plan.descend_backend != "numpy" else None)
        self.window = max(int(cfg.sip_lookahead), 1) if cfg.use_sip else 1
        self._drv_sig = engine._side_sig(self.driver, self.plan)
        self.pending: dict[int, tuple] = {}  # block -> (rel, ents, boxes)
        self._vstars: dict[int, np.ndarray] = {}   # block -> prefetched V*
        self._win_blocks: list[int] = []     # rows of an open SIP request
        self.n_blocks = (self.driver.scan.n_blocks
                         if self.driver.scan is not None else 1)
        self.b = 0
        self.done = False
        self._cur: tuple | None = None      # begin_block() materialization
        if self.n_blocks == 0:
            self._finish()

    # -- lifecycle ------------------------------------------------------
    def _finish(self) -> None:
        self.done = True

    def results(self) -> tuple[np.ndarray, Relation, ExecStats]:
        """Scores/rows of the TopK plus stats. Always safe to call: on a
        deadline-truncated cursor (``stats.partial``) the returned set is
        the anytime answer and ``stats.score_bound`` certifies it — no
        result outside the set has a key above the bound."""
        keys, rows = self.topk.results()
        scores = keys if self.plan.descending else -keys
        if self.stats.score_bound is None and self.done:
            # complete run: every candidate was seen, θ is the exact bound
            self.stats.score_bound = float(self.topk.theta)
        return scores, rows, self.stats

    # -- shared per-block pieces ----------------------------------------
    def _block_guard(self, b: int) -> bool:
        """Early-termination + deadline check; False ⟹ query finished."""
        if self.driver.scan is not None:
            dpb = self.kw_p * float(self.driver.scan.get_block(b)[0][0])
        else:  # no numeric driver: no driver bound
            dpb = 0.0
        self._driver_primary_best = dpb
        ub = dpb + self.driver_other + self.driven_bound
        if self.topk.full and ub <= self.topk.theta:
            self.stats.early_terminated = True
            self._finish()
            return False
        if self.deadline is not None \
                and self.deadline.expired(self.stats.driver_blocks):
            # stop admitting driver blocks: the current TopK is the anytime
            # answer. Unseen pairs (block >= b) are bounded by ub (blocks
            # arrive in score-key order, so ub is non-increasing); pairs
            # seen but dropped from the heap are bounded by θ — the max
            # certifies every unreturned result (θ is -inf until the heap
            # fills, in which case nothing was dropped and ub alone binds).
            self.stats.deadline_expired = True
            self.stats.partial = True
            self.stats.score_bound = max(float(self.topk.theta), ub)
            self._finish()
            return False
        return True

    @tracing.spanned("exec.materialize")
    def _materialize(self, w: int) -> tuple:
        """(drv_rel, uniq_ents, boxes) for driver block `w`."""
        eng, plan, driver = self.engine, self.plan, self.driver
        sc = eng.share_cache
        key = ("mat", self._drv_sig, w) if sc is not None else None
        if key is not None and _shared(sc, key, "mat"):
            return sc[key]
        if driver.scan is not None:
            block_rel, _ = eng._block_relation(driver, w)
            join_chain = driver.join_patterns
        else:  # no numeric driver: single full block
            block_rel = eng._cached_scan(driver.all_ordered[0])
            join_chain = driver.all_ordered[1:]
        drv_rel = eng._join_chain(block_rel, join_chain, plan.join_impl,
                                  plan.rank_backend)
        uniq_ents = boxes = None
        if drv_rel.n:
            # driver entities with geometry
            uniq_ents = np.unique(drv_rel[driver.entity_var])
            boxes = eng.store.spatial_box_of(uniq_ents)
            has_geom = ~np.isnan(boxes[:, 0])
            uniq_ents, boxes = uniq_ents[has_geom], boxes[has_geom]
        if key is not None:
            sc[key] = (drv_rel, uniq_ents, boxes)
        return drv_rel, uniq_ents, boxes

    def _sip_prefetch(self, b0: int) -> None:
        """Phases 1-2 for a `sip_lookahead` window of driver blocks: one
        batched candidate-node search + node selection, shared Bloom-row
        gathers and MBR tests across blocks (per shard). Speculative work
        past an early termination cut is discarded — the per-block guard is
        unchanged."""
        cfg, plan = self.engine.config, self.plan
        mats = self._materialize_window(b0)
        if cfg.use_sip:
            box_sets = [bx if bx is not None else np.zeros((0, 4))
                        for (_, _, _, bx) in mats]
            v_stars = shard_mod.sip_select(
                self.shards, box_sets, plan.dist_norm, plan.driven_cs,
                self.prepared, plan.probe_backend, plan.descend_backend,
                self.cs_path, cfg.select_params, self.card_all,
                self.engine.device)
            for (w, _, _, _), v_star in zip(mats, v_stars):
                self._vstars[w] = v_star

    def _materialize_window(self, b0: int) -> list[tuple]:
        """Materialize (and cache in `pending`) a lookahead window."""
        mats = [(w,) + self._materialize(w)
                for w in range(b0, min(b0 + self.window, self.n_blocks))]
        for w, drv_rel, uniq_ents, boxes in mats:
            self.pending[w] = (drv_rel, uniq_ents, boxes)
        return mats

    def _process(self, drv_rel, uniq_ents, boxes, v_star,
                 batcher=None) -> None:
        """APS + driven retrieval + Phase-3 join for one materialized block.

        With `batcher` (serve mode, fused backend) the streaming join is
        REGISTERED with the cross-query batcher instead of running here —
        the batcher's emit callback refines + scores + pushes into this
        cursor's TopK so θ tightens between shared kernel launches.

        ``v_star`` is a per-shard list aligned with ``self.shards``. The
        shard-clipped SIP intervals partition the driven result set, so
        sweeping shards sequentially and re-reading θ before each shard's
        APS `key_needed` (global-θ exchange) is exact: earlier shards'
        pushes only tighten later shards' pruning, never change the union.
        """
        eng = self.engine
        cfg, plan = eng.config, self.plan
        driven = self.driven
        topk, stats = self.topk, self.stats
        if cfg.use_sip and all(len(v) == 0 for v in v_star):
            return  # nothing on the driven side can join this block
        stats.v_star_sizes.append(sum(len(v) for v in v_star))
        for si, sh in enumerate(self.shards):
            if cfg.use_sip and len(v_star[si]) == 0:
                continue
            with tracing.span("exec.filter_material"):
                intervals, explicit = sh.filter_material(v_star[si])

            # ---- APS plan decision ----------------------------------
            # θ re-read per shard: the cross-shard pruning exchange
            key_needed = (topk.theta
                          - (self._driver_primary_best + self.driver_other)
                          - eng._side_bound(driven, plan.descending, True)) \
                if topk.full else -np.inf
            decision = aps.choose(sh.tree, v_star[si], plan.driven_cs,
                                  driven.scan, key_needed, drv_rel.n,
                                  cfg.cost_params, self.card_all[si])
            chosen = cfg.force_plan or decision.plan
            if driven.scan is None:
                chosen = "S"
            stats.plan_log.append(chosen)
            if chosen == "N":
                stats.plan_n += 1
                dvn_rel = eng._driven_nplan(driven, plan, intervals,
                                            explicit, key_needed, stats)
            else:
                stats.plan_s += 1
                dvn_rel = eng._driven_splan(driven, plan, intervals,
                                            explicit, stats)
            if dvn_rel.n:
                self._phase3(drv_rel, uniq_ents, boxes, dvn_rel,
                             batcher=batcher)

    def _phase3(self, drv_rel, uniq_ents, boxes, dvn_rel,
                batcher=None) -> None:
        """Phase-3 spatial join + refinement of one driven relation."""
        eng = self.engine
        cfg, plan = eng.config, self.plan
        driver, driven = self.driver, self.driven
        topk, stats = self.topk, self.stats
        fused = cfg.mbr_join_fn is None and plan.join_backend == "fused"
        with tracing.span("phase3.prepare"):
            dvn_ents = np.unique(dvn_rel[driven.entity_var])
            dvn_boxes = eng.store.spatial_box_of(dvn_ents)
            ok = ~np.isnan(dvn_boxes[:, 0])
            dvn_ents, dvn_boxes = dvn_ents[ok], dvn_boxes[ok]
            if len(dvn_ents) == 0:
                return
            if fused:
                ds = eng._entity_key_bound(drv_rel, uniq_ents, driver, plan)
                vs = eng._entity_key_bound(dvn_rel, dvn_ents, driven, plan)
        with tracing.span("phase3.join"):
            if fused:
                # streaming fused path: driven columns arrive in score-key
                # order, each batch refined+scored+pushed before the next so
                # the θ the kernel prunes with tightens inside the block; the
                # pairs are refined on behalf of this query also when a shared
                # launch emits them
                rid = tracing.current_rid()

                def emit(pi, pj):
                    eng._emit_pairs(pi, pj, uniq_ents, dvn_ents, drv_rel,
                                    dvn_rel, driver, driven, plan, topk,
                                    stats, ds=ds, vs=vs, rid=rid)

                if batcher is not None:
                    batcher.add(spatial_join.StreamEntry(
                        boxes, dvn_boxes, ds, vs, plan.dist_norm, plan.k,
                        theta_fn=lambda: topk.theta, emit=emit,
                        stats=stats.join))
                    return
                for pi, pj in spatial_join.fused_stream_join(
                        boxes, dvn_boxes, ds, vs, plan.dist_norm, k=plan.k,
                        theta_fn=lambda: topk.theta,
                        batch_cols=cfg.fused_batch_cols, stats=stats.join,
                        tuner=eng.kcap_tuner, device=eng.device):
                    emit(pi, pj)
            else:
                # the MBR pair set is pure in (boxes, driven boxes, distance),
                # so same-shape tenants share it too; a cache hit skips the
                # per-launch JoinStats counters (they count work done, and a
                # hit does none)
                # (an overriding join is never keyed: it need not be pure)
                sc = eng.share_cache
                key = None
                if sc is not None and cfg.mbr_join_fn is None:
                    key = ("mbr", plan.join_backend, boxes.shape,
                           dvn_boxes.shape, boxes.tobytes(),
                           dvn_boxes.tobytes(), float(plan.dist_norm))
                if key is not None and _shared(sc, key, "mbr"):
                    pi, pj = sc[key]
                elif cfg.mbr_join_fn is not None:
                    pi, pj = cfg.mbr_join_fn(boxes, dvn_boxes, plan.dist_norm,
                                             plan.join_backend, stats.join)
                else:
                    pi, pj = spatial_join.mbr_distance_join(
                        boxes, dvn_boxes, plan.dist_norm, plan.join_backend,
                        stats.join, device=eng.device)
                    if key is not None:
                        sc[key] = (pi, pj)
                eng._emit_pairs(pi, pj, uniq_ents, dvn_ents, drv_rel,
                                dvn_rel, driver, driven, plan, topk, stats)

    # -- serial mode ----------------------------------------------------
    def step(self) -> None:
        """Advance one driver block (internal lookahead SIP prefetch)."""
        if self.done:
            return
        b = self.b
        if not self._block_guard(b):
            return
        self.stats.driver_blocks += 1
        if b not in self.pending:
            self.pending.clear()
            self._vstars.clear()
            self._sip_prefetch(b)
        drv_rel, uniq_ents, boxes = self.pending.pop(b)
        v_star = self._vstars.pop(
            b, [np.array([0], dtype=np.int64)] * len(self.shards))
        self.b += 1
        if drv_rel.n and uniq_ents is not None and len(uniq_ents):
            self._process(drv_rel, uniq_ents, boxes, v_star)
        if self.b >= self.n_blocks:
            self._finish()

    # -- serve mode (two-phase step) ------------------------------------
    def begin_block(self) -> dict | None:
        """Advance to the next live block and materialize it (serve mode).

        Returns None when the cursor is finished, else a Phase-1/2 request
        the serving engine batches across queries::

            {"boxes": [(M_i, 4) driver MBRs, ...], "driven_cs": (C,) int64,
             "prepared": PreparedKeys, "dist_norm": float,
             "card_all": [(N_s,) float64 per shard], "need_sip": bool,
             "cs_path": [(N_s,) bool per shard] | None}

        ``card_all``/``cs_path`` carry one entry per shard view (a 1-list
        on unsharded stores). ``cs_path`` is this query's precomputed
        root-path Bloom mask (set on fused-descent routes, None on the host
        frontier) — the server passes it through so pooled descents skip
        the per-step Bloom probes.

        ``boxes`` covers this block plus the cursor's `sip_lookahead`
        speculative window (one row per block), so each tenant keeps the
        serial path's amortization — one shared frontier pass per refill —
        while the server pools rows across tenants. On steps served from
        the window cache ``need_sip`` is False and ``boxes`` is empty.

        Follow with ``finish_block(v_stars, batcher)`` where ``v_stars`` is
        the per-row V* list for this request (None when ``need_sip`` was
        False).
        """
        if self._cur is not None:
            raise RuntimeError("finish_block() the previous block first")
        while not self.done:
            b = self.b
            if not self._block_guard(b):
                return None
            self.stats.driver_blocks += 1
            self.b += 1
            if b not in self.pending:
                self.pending.clear()
                self._vstars.clear()
                self._materialize_window(b)
            drv_rel, uniq_ents, boxes = self.pending.pop(b)
            if drv_rel.n and uniq_ents is not None and len(uniq_ents):
                self._cur = (b, drv_rel, uniq_ents, boxes)
                need_sip = (bool(self.engine.config.use_sip)
                            and b not in self._vstars)
                if need_sip:
                    self._win_blocks = [b] + sorted(self.pending)
                    win_boxes = [boxes] + [
                        self.pending[w][2] if self.pending[w][2] is not None
                        else np.zeros((0, 4)) for w in sorted(self.pending)]
                else:
                    self._win_blocks, win_boxes = [], []
                return {"boxes": win_boxes,
                        "driven_cs": self.plan.driven_cs,
                        "prepared": self.prepared,
                        "dist_norm": self.plan.dist_norm,
                        "card_all": self.card_all,
                        "need_sip": need_sip,
                        "cs_path": self.cs_path}
            if self.b >= self.n_blocks:
                self._finish()
        return None

    def finish_block(self, v_stars: list | None, batcher=None) -> None:
        """Run Phases 2'-3 for the block begin_block() materialized.

        ``v_stars`` aligns with the request's ``boxes`` rows; rows past the
        first are the speculative window and are cached for later steps.
        """
        if self._cur is None:
            raise RuntimeError("begin_block() first")
        b, drv_rel, uniq_ents, boxes = self._cur
        self._cur = None
        if v_stars is not None:
            for w, v in zip(self._win_blocks, v_stars):
                self._vstars[w] = v
            self._win_blocks = []
        v_star = self._vstars.pop(
            b, [np.array([0], dtype=np.int64)] * len(self.shards))
        self._process(drv_rel, uniq_ents, boxes, v_star, batcher=batcher)
        if self.b >= self.n_blocks:
            self._finish()
