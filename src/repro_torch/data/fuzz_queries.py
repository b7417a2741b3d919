"""Random spatial queries over `synth_rdf.make_lgd` stores, for holding
`StreakEngine` against the full-scan oracle (`core.baselines`).

Two families, both over a pair of reified-type, confidence-ranked sides
whose class pair is drawn from `CLASSES`:

- `topk_query`: the two sides joined by a spatial distance filter and
  ranked by their weighted confidences, with 0-3 / 0-2 extra predicate
  patterns on each side (`TOPK_PARAMS` holds the grids);
- `shape_query`: a Geographica-shaped query without ranking (range,
  within, kNN or distance join; `SHAPE_PARAMS` holds each kind's grids).

`sample` draws one query of either family from a numpy generator. The
differential tests draw the same parameters through hypothesis instead.
"""
from __future__ import annotations

import numpy as np

from ..core.query import Query, Ranking, SpatialFilter, TriplePattern, Var

# class -> extra (pa/pb-attached) predicates available for pattern-count
# fuzzing; mirrors the synth_rdf LGD catalog
CLASSES = {
    "class:hotel": ("name", "label", "stars"),
    "class:park": ("label", "area"),
    "class:police": ("name",),
    "class:road": ("name", "lanes"),
    "class:pub": ("name", "label"),
}

# the top-k family's grids (weights snapped so that oracles can be cached)
TOPK_PARAMS = dict(
    dist=(1.5, 3.0, 6.0, 12.0),          # high -> low selectivity
    k=(1, 3, 10, 40, 150),
    w_a=(0.25, 1.0, 1.75),
    w_b=(0.5, 1.0, 2.0),
)

# kind -> (p1 choices, p2 choices); see `shape_query` for their meaning
SHAPE_PARAMS = {
    "range": ((0.0, 25.0, 60.0, 95.0), (0.0, 40.0, 80.0)),
    "within": ((5.0, 30.0, 50.0, 90.0), (0.0, 1.5, 8.0, 25.0)),  # p2 = dist
    "knn": ((1.0, 2.0, 5.0, 1000.0), (0.0,)),                    # p1 = k
    "join": ((0.25, 2.0, 6.0), (0.0,)),                          # p1 = dist
}

TOPK_SHARE = 0.7        # `sample`'s share of top-k queries


def _sides(ns, cls_a: str, cls_b: str) -> list:
    pa, pb = Var("place"), Var("nplace")
    return [
        TriplePattern(pa, Var("typePred1"), ns[cls_a], g=Var("r")),
        TriplePattern(Var("r"), ns["hasConfidence"], Var("conf")),
        TriplePattern(pa, ns["hasGeometry"], Var("g1")),
        TriplePattern(pb, Var("typePred2"), ns[cls_b], g=Var("r1")),
        TriplePattern(Var("r1"), ns["hasConfidence"], Var("conf1")),
        TriplePattern(pb, ns["hasGeometry"], Var("g2")),
    ]


def topk_query(ns, cls_a, cls_b, dist, k, w_a, w_b, descending,
               n_extra_a, n_extra_b) -> Query:
    """pair_query-shaped random query: two reified-type confidence-ranked
    sides joined by a spatial distance filter."""
    pa, pb = Var("place"), Var("nplace")
    patterns = _sides(ns, cls_a, cls_b)
    for p in CLASSES[cls_a][:n_extra_a]:
        patterns.append(TriplePattern(pa, ns[p], Var(f"a_{p}")))
    for p in CLASSES[cls_b][:n_extra_b]:
        patterns.append(TriplePattern(pb, ns[p], Var(f"b_{p}")))
    return Query(
        select=(pa, pb), patterns=tuple(patterns),
        spatial=SpatialFilter(Var("g1"), Var("g2"), dist),
        ranking=Ranking(((Var("conf"), w_a), (Var("conf1"), w_b)),
                        descending=descending),
        k=k)


def shape_query(ns, kind, cls_a, cls_b, p1, p2) -> Query:
    """A query shape over the two sides: a 30 x 22 window at (p1, p2), a
    disc of radius p2 around (p1, 100 - p1), the p1 nearest, or a
    distance join at p1."""
    if kind == "range":
        spatial = SpatialFilter(Var("g1"), None,
                                window=(p1, p2, p1 + 30.0, p2 + 22.0))
    elif kind == "within":
        spatial = SpatialFilter(Var("g1"), None, dist=p2,
                                center=(p1, 100.0 - p1))
    elif kind == "knn":
        spatial = SpatialFilter(Var("g1"), Var("g2"), knn=int(p1))
    else:  # join
        spatial = SpatialFilter(Var("g1"), Var("g2"), dist=p1)
    return Query(select=(Var("place"), Var("nplace")),
                 patterns=tuple(_sides(ns, cls_a, cls_b)), spatial=spatial,
                 ranking=None)


def sample(ns, rng: np.random.Generator) -> tuple:
    """One random query: ("topk", its `topk_query` arguments, Query) with
    probability `TOPK_SHARE`, else (kind, its `shape_query` arguments,
    Query)."""
    cls = sorted(CLASSES)
    cls_a, cls_b = str(rng.choice(cls)), str(rng.choice(cls))
    if rng.random() < TOPK_SHARE:
        p = {k: float(rng.choice(v)) for k, v in TOPK_PARAMS.items()}
        args = (cls_a, cls_b, p["dist"], int(p["k"]), p["w_a"], p["w_b"],
                bool(rng.integers(2)), int(rng.integers(4)),
                int(rng.integers(3)))
        return "topk", args, topk_query(ns, *args)
    kind = str(rng.choice(sorted(SHAPE_PARAMS)))
    p1s, p2s = SHAPE_PARAMS[kind]
    args = (kind, cls_a, cls_b, float(rng.choice(p1s)),
            float(rng.choice(p2s)))
    return kind, args, shape_query(ns, *args)
