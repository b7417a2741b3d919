"""Query planning: driver/driven split, join ordering, plan skeletons (§3.3.2).

The driver sub-query gets the Quark-X / SPARQL-RANK heuristic: its primary
numeric (ranking) predicate is pushed to the *deepest* position, i.e. the
driver is enumerated in score-key order through the sorted numeric index, so
blocks arrive best-first and the top-k threshold can terminate the scan.
Remaining driver patterns are joined greedily smallest-cardinality-first
(Selinger-style cost heuristic on index-scan cardinalities).

The driven side keeps BOTH skeletons (N-Plan / S-Plan); APS routes each block.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .policy import BackendPolicy
from .query import Query, TriplePattern, Var
from .store import DirectedNumericScan, QuadStore


@dataclasses.dataclass
class SidePlan:
    entity_var: str                      # variable bound to the spatial entity
    patterns: list                       # all patterns of this side
    join_patterns: list                  # block-join chain (excl. primary)
    all_ordered: list                    # full chain incl. primary (S-Plan)
    quant_terms: list                    # [(pattern, obj_var, weight), ...]
    primary: tuple | None                # (pattern, obj_var, weight) driving scan
    scan: DirectedNumericScan | None     # primary numeric scan (score order)


def _connectivity_order(store: QuadStore, patterns: list,
                        seed_vars: set) -> list:
    """Greedy smallest-cardinality-first join chain where every step shares a
    variable with what has been joined so far (avoids cartesian products)."""
    remaining = list(patterns)
    reached = set(seed_vars)
    ordered: list = []
    cards = {id(tp): _estimate_card(store, tp) for tp in remaining}
    while remaining:
        connected = [tp for tp in remaining
                     if {v.name for v in tp.vars()} & reached]
        pool = connected if connected else remaining
        best = min(pool, key=lambda tp: cards[id(tp)])
        ordered.append(best)
        reached |= {v.name for v in best.vars()}
        remaining.remove(best)
    return ordered


@dataclasses.dataclass
class QueryPlan:
    driver: SidePlan
    driven: SidePlan
    dist_world: float
    dist_norm: float
    metric: str
    driven_cs: np.ndarray
    descending: bool
    k: int
    # backend selection (core/policy.BackendPolicy), resolved ONCE at plan
    # time so the per-block hot paths — APS plan switches, SIP prefetch,
    # the Phase-3 join — read plain strings with zero dispatch cost
    join_impl: str = "merge"            # relational primitive (JOIN_IMPLS)
    rank_backend: str | None = None     # merge-join rank pass (RANK_BACKENDS)
    probe_backend: str | None = None    # Bloom CS probes (PROBE_BACKENDS)
    join_backend: str = "numpy"         # Phase-3 MBR join (JOIN_BACKENDS)
    descend_backend: str = "numpy"      # Phase-1 traversal (DESCEND_BACKENDS)
    shape: str = "topk"                 # query shape (core/query.Query.shape)


def resolve_spatial_vars(store: QuadStore, q: Query) -> tuple[str, str]:
    """Map FILTER(distance(?ga, ?gb)) geometry vars to their subject entity
    vars when they are objects of a hasGeometry pattern."""
    def resolve(v: Var) -> str:
        for tp in q.patterns:
            if (isinstance(tp.o, Var) and tp.o.name == v.name
                    and tp.p == store.geometry_predicate
                    and isinstance(tp.s, Var)):
                return tp.s.name
        return v.name
    var_a = resolve(q.spatial.a)
    # unary shapes (range / within-distance) have no second geometry var;
    # the "driven" side collapses to the driver's entity var (empty side)
    var_b = resolve(q.spatial.b) if q.spatial.b is not None else var_a
    return var_a, var_b


def _connected_component(patterns: list, seed_var: str) -> list:
    """Patterns reachable from seed_var through shared variables."""
    reach = {seed_var}
    chosen: list = []
    remaining = list(patterns)
    changed = True
    while changed:
        changed = False
        for tp in list(remaining):
            names = {v.name for v in tp.vars()}
            if names & reach:
                reach |= names
                chosen.append(tp)
                remaining.remove(tp)
                changed = True
    return chosen


def _estimate_card(store: QuadStore, tp: TriplePattern) -> int:
    """Cheap cardinality estimate: exact count via index range scan."""
    return len(_scan_rows(store, tp))


def _scan_rows(store, tp):
    def const(t):
        return None if (t is None or isinstance(t, Var)) else int(t)
    return store.scan(g=const(tp.g), s=const(tp.s), p=const(tp.p), o=const(tp.o))


def _build_side(store: QuadStore, patterns: list, entity_var: str,
                ranking_weights: dict, descending: bool) -> SidePlan:
    quant_terms = []
    for tp in patterns:
        if isinstance(tp.o, Var) and tp.o.name in ranking_weights \
                and not isinstance(tp.p, Var) and int(tp.p) in store.numeric:
            quant_terms.append((tp, tp.o.name, ranking_weights[tp.o.name]))
    primary = None
    scan = None
    if quant_terms:
        # primary = the largest-|weight| quantifiable TP (ties: largest index,
        # which maximizes the benefit of the sorted scan)
        primary = max(quant_terms,
                      key=lambda t: (abs(t[2]), store.numeric[int(t[0].p)].n_rows))
        scan = DirectedNumericScan(store.numeric[int(primary[0].p)], descending)
    # drop the hasGeometry pattern from the join chains: it is implied by the
    # spatial id (S bit) and the tree holds the geometry
    joinable = [tp for tp in patterns if tp.p != store.geometry_predicate]
    seed = {entity_var}
    if primary is not None:
        seed |= {v.name for v in primary[0].vars()}
    rest = [tp for tp in joinable if primary is None or tp is not primary[0]]
    rest = _connectivity_order(store, rest, seed)
    all_ordered = _connectivity_order(store, joinable, {entity_var})
    return SidePlan(entity_var=entity_var, patterns=patterns,
                    join_patterns=rest, all_ordered=all_ordered,
                    quant_terms=quant_terms, primary=primary, scan=scan)


def plan_query(store: QuadStore, q: Query,
               force_driver: str | None = None,
               join_impl: str | None = None,
               rank_backend: str | None = None,
               policy: BackendPolicy | None = None) -> QueryPlan:
    """Plan a spatial top-k query.

    `policy` fixes every stage backend (core/policy.BackendPolicy; resolved
    here if it still carries "auto" entries). The `join_impl` /
    `rank_backend` kwargs are the pre-policy per-stage form, kept for
    direct callers; they are ignored when `policy` is given.
    """
    assert q.spatial is not None, "plan_query expects a spatial query"
    shape = q.shape()
    if shape in ("range", "within", "knn", "join") and q.ranking is not None:
        raise ValueError(
            f"{shape!r}-shaped queries are selections; ranking is only "
            "supported on the top-k distance-join shape")
    if shape in ("range", "within") and q.spatial.b is not None:
        raise ValueError(f"{shape!r}-shaped queries are unary: spatial.b "
                         "must be None")
    if shape in ("knn", "join", "topk") and q.spatial.b is None:
        raise ValueError(f"{shape!r}-shaped queries need spatial.b")
    if policy is None:
        policy = BackendPolicy(impl=join_impl or "auto",
                               rank=rank_backend or "auto")
    policy = policy.resolve()
    var_a, var_b = resolve_spatial_vars(store, q)
    patterns = list(q.patterns)
    side_a_patterns = _connected_component(patterns, var_a)
    covered = set(map(id, side_a_patterns))
    side_b_patterns = [tp for tp in patterns if id(tp) not in covered]
    # safety: anything left unattached joins the a-side
    if shape in ("range", "within") and side_b_patterns:
        # unary shapes have one side only; disconnected patterns would
        # otherwise dangle on a nonexistent driven side
        side_a_patterns = side_a_patterns + side_b_patterns
        side_b_patterns = []
    ranking_weights = {v.name: w for v, w in (q.ranking.terms if q.ranking else ())}
    descending = q.ranking.descending if q.ranking else True

    side_a = _build_side(store, side_a_patterns, var_a, ranking_weights, descending)
    side_b = _build_side(store, side_b_patterns, var_b, ranking_weights, descending)

    # driver choice (paper: APS picks driver/driven): prefer the side with a
    # primary numeric scan; among those, the smaller index converges faster.
    def scan_rows(sp: SidePlan) -> int:
        return sp.scan.n_rows if sp.scan is not None else 1 << 62
    if shape in ("range", "within", "knn"):
        # unary shapes have only the a-side; kNN's FILTER is directional
        # (k nearest ?b per ?a entity), so ?a's side MUST drive
        driver, driven = side_a, side_b
    elif force_driver == "a":
        driver, driven = side_a, side_b
    elif force_driver == "b":
        driver, driven = side_b, side_a
    elif (side_a.scan is None) != (side_b.scan is None):
        driver, driven = (side_a, side_b) if side_a.scan else (side_b, side_a)
    else:
        driver, driven = ((side_a, side_b)
                          if scan_rows(side_a) <= scan_rows(side_b)
                          else (side_b, side_a))

    # driven CS compatibility: every CS whose predicate set contains the
    # driven entity's query predicates. Unary shapes filter the DRIVER's
    # entities against the tree (there is no driven side), so their CS set
    # comes from the driver's patterns instead.
    cs_side = driver if shape in ("range", "within") else driven
    driven_preds = {int(tp.p) for tp in cs_side.patterns
                    if isinstance(tp.s, Var) and tp.s.name == cs_side.entity_var
                    and not isinstance(tp.p, Var)}
    matching = [cid for cid, preds in store.cs_catalog.items()
                if driven_preds <= preds]
    driven_cs = np.array(sorted(matching), dtype=np.int64)

    dist_norm = store.tree.extent.denormalize_distance(q.spatial.dist)
    return QueryPlan(driver=driver, driven=driven,
                     dist_world=q.spatial.dist, dist_norm=dist_norm,
                     metric=q.spatial.metric, driven_cs=driven_cs,
                     descending=descending, k=q.k,
                     join_impl=policy.impl, rank_backend=policy.rank,
                     probe_backend=policy.probe, join_backend=policy.join,
                     descend_backend=policy.descend, shape=shape)
