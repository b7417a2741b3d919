"""Query representation (§2): graph patterns + spatial filter + top-k ranking.

    SELECT [projection] WHERE [patterns] FILTER [distance(a,b) < d]
    ORDER BY [ranking] LIMIT [k]

Reified statements are plain quad patterns with a bound/variable `g` slot
(``?r rdf:subject ?s . ?r rdf:predicate ?p . ?r rdf:object ?o`` collapses to
one quad pattern with g = ?r).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Var:
    name: str

    def __repr__(self):
        return f"?{self.name}"


@dataclasses.dataclass(frozen=True)
class TriplePattern:
    s: object
    p: object
    o: object
    g: object = None   # None = don't-care, Var = reification id, int = bound

    def vars(self) -> list[Var]:
        return [t for t in (self.g, self.s, self.p, self.o) if isinstance(t, Var)]

    def n_bound(self) -> int:
        return sum(1 for t in (self.g, self.s, self.p, self.o)
                   if t is not None and not isinstance(t, Var))


@dataclasses.dataclass(frozen=True)
class SpatialFilter:
    """Spatial predicate over geometry variables, in world units.

    The binary form is the paper's FILTER(distance(?a, ?b) < dist). The
    Geographica-shaped extensions reuse the same carrier:

    - ``window=(xmin, ymin, xmax, ymax)`` — spatial *range*: ?a's exact
      geometry has a point inside the (closed) window. Unary (``b=None``).
    - ``center=(x, y)`` — *within-distance*: min distance from ?a's exact
      geometry to the point is <= ``dist``. Unary (``b=None``).
    - ``knn=k`` — per-?a-entity k nearest ?b entities by exact geometry
      distance (short lists allowed when fewer than k candidates exist).
    - binary, no ranking on the query — non-top-k *spatial join*: every
      (?a, ?b) pair within ``dist``.
    """
    a: Var
    b: Var | None = None
    dist: float = 0.0
    metric: str = "euclid"   # or "haversine"
    window: tuple | None = None   # (xmin, ymin, xmax, ymax) world coords
    center: tuple | None = None   # (x, y) world coords
    knn: int | None = None        # per-driver-entity k

    def shape(self) -> str:
        """One of "range", "within", "knn", "join", "topk"."""
        if self.window is not None:
            return "range"
        if self.center is not None:
            return "within"
        if self.knn is not None:
            return "knn"
        return "topk"   # binary; Query.shape() downgrades to "join"


@dataclasses.dataclass(frozen=True)
class Ranking:
    """ORDER BY sum_i w_i * value(?v_i); descending = True for DESC."""
    terms: tuple            # ((Var, weight), ...)
    descending: bool = True

    def vars(self) -> list[Var]:
        return [v for v, _ in self.terms]


@dataclasses.dataclass(frozen=True)
class Query:
    select: tuple
    patterns: tuple
    spatial: SpatialFilter | None
    ranking: Ranking | None
    k: int = 100

    def shape(self) -> str:
        """Query shape: "topk" (paper §2), "range", "within", "knn", or
        "join" (binary spatial filter without a ranking = non-top-k
        spatial join). Selection shapes ignore `ranking`/`k`; "knn" takes
        its per-driver k from ``spatial.knn``."""
        if self.spatial is None:
            return "scan"
        s = self.spatial.shape()
        if s == "topk" and self.ranking is None:
            return "join"
        return s

    def all_vars(self) -> list[Var]:
        seen, out = set(), []
        for tp in self.patterns:
            for v in tp.vars():
                if v.name not in seen:
                    seen.add(v.name)
                    out.append(v)
        return out
