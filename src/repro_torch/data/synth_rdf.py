"""Synthetic YAGO3-like and LGD-like RDF datasets + benchmark queries (§4).

Mirrors the paper's evaluation setup at configurable scale:
- LGD-like: OpenStreetMap-flavored classes (hotel / park / police / road /
  pub) with POINT, LINESTRING and POLYGON geometries, reified type facts
  carrying exponential-distributed confidence scores, *complex*-shaped
  benchmark queries with (SS, RS) joins.
- YAGO3-like: POINT-only places with numeric attributes (population density,
  economic growth, ...), *star*- and *complex*-shaped queries.

Spatial layout is a mixture of Gaussian clusters (real geo data is skewed);
classes can be geographically localized so that some queries are highly
selective at the spatial join (the regime where SIP shines, paper Fig. 7)
while others overlap heavily (low selectivity, Q1-Q5 of LGD).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.dictionary import Dictionary
from ..core.query import Query, Ranking, SpatialFilter, TriplePattern, Var
from ..core.store import QuadStore, build_store


@dataclasses.dataclass
class SynthDataset:
    name: str
    store: QuadStore
    ns: dict                  # predicate/class name -> id
    queries: list             # benchmark Query objects
    raw_nbytes: int           # size of the raw quad table (Table 3 analogue)


class _Builder:
    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.dict = Dictionary.empty()
        self.quads: list[tuple[int, int, int, int]] = []
        self.geoms: dict = {}
        self.exact: dict = {}
        self._fact = 0

    def term(self, t: str) -> int:
        return self.dict.intern(t)

    def num(self, v: float) -> int:
        return self.dict.intern_numeric(v)

    def fact(self, s: int, p: int, o: int) -> int:
        g = self.term(f"_:fact{self._fact}")
        self._fact += 1
        self.quads.append((g, s, p, o))
        return g

    def plain(self, s: int, p: int, o: int) -> None:
        self.quads.append((0, s, p, o))

    def cluster_points(self, n: int, n_clusters: int, extent: float = 100.0,
                       region: tuple | None = None) -> np.ndarray:
        lo, hi = region if region else (0.0, extent)
        centers = self.rng.uniform(lo, hi, size=(n_clusters, 2))
        which = self.rng.integers(0, n_clusters, size=n)
        pts = centers[which] + self.rng.normal(0, extent * 0.02, size=(n, 2))
        return np.clip(pts, 0.0, extent)


def _geom_points(b: _Builder, pts: np.ndarray, kind: str,
                 extent: float) -> tuple[np.ndarray, list]:
    """exact geometry point sets per entity; returns (boxes, exact_list)."""
    n = len(pts)
    boxes = np.empty((n, 4))
    exact = []
    for i in range(n):
        if kind == "point":
            g = pts[i:i + 1]
        elif kind == "linestring":
            m = int(b.rng.integers(2, 6))
            g = pts[i] + np.cumsum(
                b.rng.normal(0, extent * 0.004, size=(m, 2)), axis=0)
        else:  # polygon ring
            m = int(b.rng.integers(4, 9))
            ang = np.sort(b.rng.uniform(0, 2 * np.pi, size=m))
            r = b.rng.uniform(extent * 0.001, extent * 0.008)
            g = pts[i] + r * np.stack([np.cos(ang), np.sin(ang)], axis=1)
        g = np.clip(g, 0.0, extent)
        exact.append(g)
        boxes[i] = [g[:, 0].min(), g[:, 1].min(), g[:, 0].max(), g[:, 1].max()]
    return boxes, exact


def _confidence(b: _Builder, n: int) -> np.ndarray:
    """Exponential-distributed confidence in [0, 1] (paper §4.1)."""
    return np.clip(b.rng.exponential(0.3, size=n), 0.0, 1.0)


# ---------------------------------------------------------------------------
# LGD-like
# ---------------------------------------------------------------------------

def make_lgd(n_per_class: int = 400, seed: int = 0,
             l_max: int = 8, leaf_capacity: int = 64,
             block: int = 256) -> SynthDataset:
    b = _Builder(seed)
    extent = 100.0
    ns = {k: b.term(k) for k in (
        "rdf:type", "hasGeometry", "hasConfidence", "name", "label",
        "stars", "area", "lanes", "class:hotel", "class:park",
        "class:police", "class:road", "class:pub")}

    # class -> (geometry kind, spatial region, extra predicates)
    # park/police/pub are geographically localized with a narrow overlap so
    # their pair queries are highly spatially selective (paper Fig. 7
    # regime) while still having >= k results at benchmark scale.
    classes = {
        "class:hotel": ("point", (0.0, 100.0), ("name", "label", "stars")),
        "class:park": ("polygon", (0.0, 62.0), ("label", "area")),
        "class:police": ("point", (48.0, 100.0), ("name",)),
        "class:road": ("linestring", (0.0, 100.0), ("name", "lanes")),
        "class:pub": ("point", (0.0, 52.0), ("name", "label")),
    }
    for cname, (kind, region, preds) in classes.items():
        pts = b.cluster_points(n_per_class, 12, extent, region)
        boxes, exact = _geom_points(b, pts, kind, extent)
        conf = _confidence(b, n_per_class)
        for i in range(n_per_class):
            e = b.term(f"{cname}/e{i}")
            geo = b.term(f"geom:{cname}/e{i}")
            b.geoms[e] = boxes[i]
            b.exact[e] = exact[i]
            # reified type fact with confidence (RS-join structure)
            r = b.fact(e, ns["rdf:type"], ns[cname])
            b.plain(r, ns["hasConfidence"], b.num(float(conf[i])))
            b.plain(e, ns["hasGeometry"], geo)
            for pname in preds:
                b.plain(e, ns[pname], b.term(f"{pname}:{cname}/{i % 97}"))

    store = build_store(np.array(b.quads, dtype=np.int64), b.dict,
                        geometry_predicate=ns["hasGeometry"],
                        geometries=b.geoms, exact_geoms=b.exact,
                        l_max=l_max, leaf_capacity=leaf_capacity, block=block)
    ns = {k: store.dictionary.term_to_id[k] for k in ns}

    def pair_query(cls_a: str, cls_b: str, dist: float, k: int = 100,
                   extra_a: tuple = (), extra_b: tuple = ()) -> Query:
        """?place typed cls_a (reified, conf-ranked) near ?nplace typed cls_b."""
        pa, pb = Var("place"), Var("nplace")
        patterns = [
            TriplePattern(pa, Var("typePred1"), ns[cls_a], g=Var("r")),
            TriplePattern(Var("r"), ns["hasConfidence"], Var("conf")),
            TriplePattern(pa, ns["hasGeometry"], Var("g1")),
            TriplePattern(pb, Var("typePred2"), ns[cls_b], g=Var("r1")),
            TriplePattern(Var("r1"), ns["hasConfidence"], Var("conf1")),
            TriplePattern(pb, ns["hasGeometry"], Var("g2")),
        ]
        for p in extra_a:
            patterns.append(TriplePattern(pa, ns[p], Var(f"a_{p}")))
        for p in extra_b:
            patterns.append(TriplePattern(pb, ns[p], Var(f"b_{p}")))
        return Query(
            select=(pa, pb),
            patterns=tuple(patterns),
            spatial=SpatialFilter(Var("g1"), Var("g2"), dist),
            ranking=Ranking(((Var("conf"), 1.0), (Var("conf1"), 1.0)),
                            descending=False),  # ORDER BY ASC(conf+conf1)
            k=k)

    d_lo, d_hi = extent * 0.02, extent * 0.06
    queries = [
        pair_query("class:hotel", "class:park", d_hi),                    # Q1
        pair_query("class:park", "class:police", d_lo),                   # Q2
        pair_query("class:hotel", "class:police", d_lo, extra_a=("label",)),  # Q3
        pair_query("class:pub", "class:police", d_lo,
                   extra_a=("name", "label"), extra_b=("name",)),         # Q4
        pair_query("class:park", "class:police", d_lo,
                   extra_a=("label",), extra_b=("name",)),                # Q5
        pair_query("class:hotel", "class:road", d_hi),                    # Q6
        pair_query("class:road", "class:hotel", d_hi),                    # Q7 (swap)
        pair_query("class:park", "class:road", d_hi, extra_a=("label",)),  # Q8
    ]
    raw = np.array(b.quads, dtype=np.int64).nbytes
    return SynthDataset("lgd", store, ns, queries, raw)


# ---------------------------------------------------------------------------
# Bulk scaling generator (1M -> 100M quads)
# ---------------------------------------------------------------------------

def make_scale(n_quads: int, seed: int = 0,
               l_max: int = 8, leaf_capacity: int = 256,
               block: int = 4096, n_conf_bins: int = 4096) -> SynthDataset:
    """LGD-shaped dataset built with bulk numpy ops, viable at 10M-100M quads.

    The per-entity Python loops of `make_lgd`/`make_yago` cap out around
    ~1M quads; this generator constructs the quad table, geometry boxes and
    numeric literals as whole arrays (only the handful of predicate/class
    terms and the `n_conf_bins` quantized confidence literals go through
    the dictionary), keeping the paper's evaluated shape: two localized
    spatial classes, reified type facts ranked by exponential confidence,
    attribute quads for CS variety, and the LGD pair query (SS + RS joins,
    spatial filter, ORDER BY ASC(conf+conf1) LIMIT k).

    Entities carry box MBRs (not points), so quadrant-line straddlers give
    the interior nodes populated E-lists — the regime the compressed
    `PackedEList` tier targets.

    ~4.5 quads per entity: geometry + reified type + confidence per
    entity, attr1 for all, attr2 for every other entity.
    """
    rng = np.random.default_rng(seed)
    d = Dictionary.empty()
    ns = {k: d.intern(k) for k in (
        "rdf:type", "hasGeometry", "hasConfidence", "attr1", "attr2",
        "class:poi", "class:site")}
    # quantized confidence literals (bounded distinct count: the dictionary
    # round-trip stays O(n_conf_bins), not O(n_quads))
    grid = np.round(np.linspace(0.0, 1.0, n_conf_bins), 6)
    conf_ids = np.array([d.intern_numeric(float(v)) for v in grid],
                        dtype=np.int64)

    n_ent = max(int(n_quads / 4.5), 2)
    extent = 100.0
    # plain-id ranges (disjoint, far below the S bit)
    e0 = 1 << 20                       # entities
    f0 = e0 + n_ent                    # reified type-fact ids
    g0 = f0 + n_ent                    # geometry objects
    a0 = g0 + n_ent                    # attribute object pool
    n_pool = 1 << 16
    d._next = a0 + n_pool

    ent = e0 + np.arange(n_ent, dtype=np.int64)
    fact = f0 + np.arange(n_ent, dtype=np.int64)
    geo = g0 + np.arange(n_ent, dtype=np.int64)

    # two localized classes: poi in [0, 62], site in [48, 100] — the narrow
    # overlap keeps the pair query spatially selective (Fig. 7 regime)
    is_site = np.arange(n_ent) % 2 == 1
    cls = np.where(is_site, ns["class:site"], ns["class:poi"])
    n_cl = 64
    lo = np.where(is_site, 48.0, 0.0)
    hi = np.where(is_site, 100.0, 62.0)
    centers = rng.uniform(0.0, 1.0, size=(n_cl, 2))
    which = rng.integers(0, n_cl, size=n_ent)
    pts = centers[which] * (hi - lo)[:, None] + lo[:, None] \
        + rng.normal(0, extent * 0.02, size=(n_ent, 2))
    pts = np.clip(pts, 0.0, extent)
    half = rng.lognormal(np.log(extent * 0.002), 0.6, size=(n_ent, 2))
    boxes = np.concatenate([np.clip(pts - half, 0, extent),
                            np.clip(pts + half, 0, extent)], axis=1)

    conf_bin = np.minimum((rng.exponential(0.3, size=n_ent) *
                           (n_conf_bins - 1)).astype(np.int64),
                          n_conf_bins - 1)
    conf_obj = conf_ids[conf_bin]
    attr1_obj = a0 + rng.integers(0, n_pool, size=n_ent)
    has_a2 = np.arange(n_ent) % 2 == 0
    attr2_obj = a0 + rng.integers(0, n_pool, size=int(has_a2.sum()))

    zeros = np.zeros(n_ent, dtype=np.int64)
    quads = np.concatenate([
        np.stack([zeros, ent, np.full(n_ent, ns["hasGeometry"]), geo], 1),
        np.stack([fact, ent, np.full(n_ent, ns["rdf:type"]), cls], 1),
        np.stack([zeros, fact, np.full(n_ent, ns["hasConfidence"]),
                  conf_obj], 1),
        np.stack([zeros, ent, np.full(n_ent, ns["attr1"]), attr1_obj], 1),
        np.stack([zeros[has_a2], ent[has_a2],
                  np.full(int(has_a2.sum()), ns["attr2"]),
                  attr2_obj], 1),
    ]).astype(np.int64)

    geometries = dict(zip(ent.tolist(), boxes))
    store = build_store(quads, d, geometry_predicate=ns["hasGeometry"],
                        geometries=geometries, exact_geoms=None,
                        l_max=l_max, leaf_capacity=leaf_capacity,
                        block=block)
    ns = {k: store.dictionary.term_to_id[k] for k in ns}

    def pair_query(cls_a: str, cls_b: str, dist: float, k: int = 100) -> Query:
        pa, pb = Var("place"), Var("nplace")
        patterns = (
            TriplePattern(pa, Var("typePred1"), ns[cls_a], g=Var("r")),
            TriplePattern(Var("r"), ns["hasConfidence"], Var("conf")),
            TriplePattern(pa, ns["hasGeometry"], Var("g1")),
            TriplePattern(pb, Var("typePred2"), ns[cls_b], g=Var("r1")),
            TriplePattern(Var("r1"), ns["hasConfidence"], Var("conf1")),
            TriplePattern(pb, ns["hasGeometry"], Var("g2")),
        )
        return Query(
            select=(pa, pb), patterns=patterns,
            spatial=SpatialFilter(Var("g1"), Var("g2"), dist),
            ranking=Ranking(((Var("conf"), 1.0), (Var("conf1"), 1.0)),
                            descending=False), k=k)

    queries = [
        pair_query("class:poi", "class:site", extent * 0.005),
        pair_query("class:site", "class:poi", extent * 0.002),
    ]
    return SynthDataset("scale", store, ns, queries, quads.nbytes)


# ---------------------------------------------------------------------------
# YAGO3-like
# ---------------------------------------------------------------------------

def make_yago(n_places: int = 1500, seed: int = 1,
              l_max: int = 8, leaf_capacity: int = 64,
              block: int = 256) -> SynthDataset:
    b = _Builder(seed)
    extent = 360.0
    ns = {k: b.term(k) for k in (
        "hasPopulationDensity", "hasNumberOfPeople", "hasEconomicGrowth",
        "hasInflation", "isLocatedIn", "hasNeighbor", "isConnectedTo",
        "hasGeometry", "hasConfidence", "happenedIn", "wasBornIn", "diedIn",
        "rdf:type", "class:city", "class:village", "class:event",
        "class:person")}

    n_loc = max(8, n_places // 50)
    locations = [b.term(f"loc{i}") for i in range(n_loc)]

    pts = b.cluster_points(n_places, 25, extent)
    boxes, exact = _geom_points(b, pts, "point", extent)
    popul = b.rng.lognormal(5.0, 1.5, size=n_places)
    people = b.rng.lognormal(8.0, 2.0, size=n_places)
    growth = b.rng.normal(2.0, 3.0, size=n_places)
    infl = b.rng.normal(4.0, 2.0, size=n_places)
    places = []
    for i in range(n_places):
        e = b.term(f"place{i}")
        places.append(e)
        b.geoms[e] = boxes[i]
        b.exact[e] = exact[i]
        b.plain(e, ns["hasGeometry"], b.term(f"geom:place{i}"))
        b.plain(e, ns["isLocatedIn"], locations[i % n_loc])
        kind = i % 3
        if kind == 0:  # "city": density + growth (+ inflation sometimes)
            b.plain(e, ns["hasPopulationDensity"], b.num(float(popul[i])))
            b.plain(e, ns["hasEconomicGrowth"], b.num(float(growth[i])))
            if i % 5 == 0:
                b.plain(e, ns["hasInflation"], b.num(float(infl[i])))
        elif kind == 1:  # "town": population count
            b.plain(e, ns["hasNumberOfPeople"], b.num(float(people[i])))
        else:  # both flavors
            b.plain(e, ns["hasPopulationDensity"], b.num(float(popul[i])))
            b.plain(e, ns["hasNumberOfPeople"], b.num(float(people[i])))
        if i % 4 == 0:
            b.plain(e, ns["hasNeighbor"], places[max(0, i - 1)])
        if i % 6 == 0:
            b.plain(b.term(f"conn{i}"), ns["isConnectedTo"], e)

    # reified event/person facts for the complex queries
    n_ev = n_places // 3
    conf = _confidence(b, n_ev)
    for i in range(n_ev):
        ev = b.term(f"event{i}")
        target = places[int(b.rng.integers(0, n_places))]
        r = b.fact(ev, ns["happenedIn"], target)
        b.plain(r, ns["hasConfidence"], b.num(float(conf[i])))
        person = b.term(f"person{i}")
        r2 = b.fact(person, ns["wasBornIn"],
                    places[int(b.rng.integers(0, n_places))])
        b.plain(r2, ns["hasConfidence"], b.num(float(1.0 - conf[i])))

    store = build_store(np.array(b.quads, dtype=np.int64), b.dict,
                        geometry_predicate=ns["hasGeometry"],
                        geometries=b.geoms, exact_geoms=b.exact,
                        l_max=l_max, leaf_capacity=leaf_capacity, block=block)
    ns = {k: store.dictionary.term_to_id[k] for k in ns}

    pa, pb = Var("place"), Var("nplace")
    d = extent * 0.02

    def star(extra_a: tuple, extra_b: tuple, k: int = 100) -> Query:
        """Star-shaped: both sides are attribute cliques on the subject."""
        patterns = [
            TriplePattern(pa, ns["hasPopulationDensity"], Var("popul")),
            TriplePattern(pa, ns["hasGeometry"], Var("g1")),
            TriplePattern(pa, ns["isLocatedIn"], Var("loc1")),
            TriplePattern(pb, ns["hasNumberOfPeople"], Var("popul1")),
            TriplePattern(pb, ns["hasGeometry"], Var("g2")),
            TriplePattern(pb, ns["isLocatedIn"], Var("loc2")),
        ]
        patterns += [TriplePattern(pa, ns[p], Var(f"a_{p}")) for p in extra_a]
        patterns += [TriplePattern(pb, ns[p], Var(f"b_{p}")) for p in extra_b]
        return Query(select=(pa, pb), patterns=tuple(patterns),
                     spatial=SpatialFilter(Var("g1"), Var("g2"), d),
                     ranking=Ranking(((Var("popul"), 1.0), (Var("popul1"), 1.0)),
                                     descending=False), k=k)

    def complex_reified(pred: str, k: int = 100) -> Query:
        """Reified event near an attribute place (OS/RS joins)."""
        patterns = (
            TriplePattern(Var("a"), ns[pred], Var("b"), g=Var("r")),
            TriplePattern(Var("r"), ns["hasConfidence"], Var("conf")),
            TriplePattern(Var("b"), ns["hasGeometry"], Var("g1")),
            TriplePattern(pb, ns["hasNumberOfPeople"], Var("popul1")),
            TriplePattern(pb, ns["hasGeometry"], Var("g2")),
            TriplePattern(pb, ns["isLocatedIn"], Var("loc2")),
        )
        return Query(select=(Var("a"), pb), patterns=patterns,
                     spatial=SpatialFilter(Var("g1"), Var("g2"), d),
                     ranking=Ranking(((Var("conf"), 1.0), (Var("popul1"), 1.0)),
                                     descending=False), k=k)

    queries = [
        star((), ()),                                            # Q1
        star(("hasEconomicGrowth",), ()),                        # Q2
        star(("hasEconomicGrowth",), ("isLocatedIn",)),          # Q3
        star(("hasEconomicGrowth", "hasNeighbor"), ()),          # Q4
        complex_reified("happenedIn"),                           # Q5
        complex_reified("wasBornIn"),                            # Q6
        star(("hasNeighbor",), ()),                              # Q7
        complex_reified("happenedIn", k=10),                     # Q8
    ]
    raw = np.array(b.quads, dtype=np.int64).nbytes
    return SynthDataset("yago3", store, ns, queries, raw)
