"""LGD- and YAGO3-shaped RDF data and query templates, made from a seed.

A frozen copy of ``make_lgd`` and ``make_yago`` in
``src/repro_torch/data/synth_rdf.py`` (with ``_Builder``, ``_geom_points`` and
``_confidence``): the same random draws in the same order, so the quads,
terms and geometries equal that module's for one seed. Later changes to the
program's generator cannot move this one. What differs is the output:
plain arrays and templates that the harness hands to the program
(``program.py``) and to the plain reference (``reference.py``) alike, and
no store.

A configuration's `generator` names one of `GENERATORS` or a file
``generators/<name>.py`` whose ``make(**scale, seed)`` returns a `Dataset`;
its templates may be of any query shape (``shapes/``).

`relabel` gives a dataset new identifiers in an order drawn from a run's
seed. A configuration fixes its dataset (the generator's seed is its
`data_seed`, as the paper evaluates one LGD and one YAGO3), and each run
sees that dataset under identifiers, and its quads in an order, of its own.
Where the whole dataset came from the run's seed, the clusters' centres
(where the parks and police stations gather) decide whether Q4 stops after
a few driver blocks or scans all of them, and a run's work moved with its
seed by more than runs of one seed spread.
"""
from __future__ import annotations

import dataclasses
import pathlib

import numpy as np

from . import files


@dataclasses.dataclass(frozen=True)
class V:
    """A query variable."""
    name: str


@dataclasses.dataclass(frozen=True)
class Template:
    """SELECT select WHERE patterns FILTER(distance(a, b) <= dist)
    ORDER BY sum(w * value(var)) [DESC] LIMIT k. A pattern is (g, s, p, o):
    a term id, a `V`, or None for g (the default graph, don't care).

    A template of another shape is a frozen dataclass of its own with
    `select`, `patterns` and `shape` (``shapes/<shape>.py``)."""
    select: tuple
    patterns: tuple
    geo_a: V
    geo_b: V
    dist: float
    ranking: tuple          # ((V, weight), ...)
    descending: bool
    k: int
    shape: str = "topk_join"


@dataclasses.dataclass
class Dataset:
    name: str
    terms: list             # term id i is terms[i - 1]; 0 is NULL
    quads: np.ndarray       # (n, 4) int64 (g, s, p, o) term ids
    geometry_predicate: int
    boxes: dict             # entity id -> (xmin, ymin, xmax, ymax)
    exact: dict             # entity id -> (m, 2) float64 points
    templates: list         # Q1..Q8 `Template`s
    extent: float

    def numeric(self) -> dict:
        """term id -> float, for every term that parses as a number."""
        out = {}
        for i, t in enumerate(self.terms, start=1):
            try:
                out[i] = float(t)
            except ValueError:
                pass
        return out


class _Builder:
    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.term_to_id: dict = {}
        self.terms: list = []
        self.quads: list = []
        self.geoms: dict = {}
        self.exact: dict = {}
        self._fact = 0

    def term(self, t: str) -> int:
        i = self.term_to_id.get(t)
        if i is None:
            self.terms.append(t)
            i = len(self.terms)
            self.term_to_id[t] = i
        return i

    def num(self, v: float) -> int:
        return self.term(repr(float(v)))

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

    def dataset(self, name: str, geometry_predicate: int, templates: list,
                extent: float) -> Dataset:
        return Dataset(name, self.terms, np.array(self.quads, dtype=np.int64),
                       geometry_predicate, self.geoms, self.exact, templates,
                       extent)


def _geom_points(b: _Builder, pts: np.ndarray, kind: str,
                 extent: float) -> tuple[np.ndarray, list]:
    """Exact point sets per entity: (boxes, exact list)."""
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


def make_lgd(n_per_class: int, seed: int) -> Dataset:
    """LGD-shaped: five OSM classes with POINT, LINESTRING and POLYGON
    geometries, reified type facts ranked by exponential confidence, the
    pair queries Q1-Q8 (ORDER BY ASC(conf + conf1))."""
    b = _Builder(seed)
    extent = 100.0
    ns = {k: b.term(k) for k in (
        "rdf:type", "hasGeometry", "hasConfidence", "name", "label",
        "stars", "area", "lanes", "class:hotel", "class:park",
        "class:police", "class:road", "class:pub")}
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
            r = b.fact(e, ns["rdf:type"], ns[cname])
            b.plain(r, ns["hasConfidence"], b.num(float(conf[i])))
            b.plain(e, ns["hasGeometry"], geo)
            for pname in preds:
                b.plain(e, ns[pname], b.term(f"{pname}:{cname}/{i % 97}"))

    def pair(cls_a: str, cls_b: str, dist: float, extra_a: tuple = (),
             extra_b: tuple = ()) -> Template:
        pa, pb = V("place"), V("nplace")
        pats = [
            (V("r"), pa, V("typePred1"), ns[cls_a]),
            (None, V("r"), ns["hasConfidence"], V("conf")),
            (None, pa, ns["hasGeometry"], V("g1")),
            (V("r1"), pb, V("typePred2"), ns[cls_b]),
            (None, V("r1"), ns["hasConfidence"], V("conf1")),
            (None, pb, ns["hasGeometry"], V("g2")),
        ]
        pats += [(None, pa, ns[p], V(f"a_{p}")) for p in extra_a]
        pats += [(None, pb, ns[p], V(f"b_{p}")) for p in extra_b]
        return Template((pa, pb), tuple(pats), V("g1"), V("g2"), dist,
                        ((V("conf"), 1.0), (V("conf1"), 1.0)), False, 100)

    d_lo, d_hi = extent * 0.02, extent * 0.06
    templates = [
        pair("class:hotel", "class:park", d_hi),                          # Q1
        pair("class:park", "class:police", d_lo),                         # Q2
        pair("class:hotel", "class:police", d_lo, extra_a=("label",)),    # Q3
        pair("class:pub", "class:police", d_lo,
             extra_a=("name", "label"), extra_b=("name",)),               # Q4
        pair("class:park", "class:police", d_lo,
             extra_a=("label",), extra_b=("name",)),                      # Q5
        pair("class:hotel", "class:road", d_hi),                          # Q6
        pair("class:road", "class:hotel", d_hi),                          # Q7
        pair("class:park", "class:road", d_hi, extra_a=("label",)),       # Q8
    ]
    return b.dataset("lgd", ns["hasGeometry"], templates, extent)


def make_yago(n_places: int, seed: int) -> Dataset:
    """YAGO3-shaped: POINT places with numeric attributes, reified
    event and birth facts; star (Q1-Q4, Q7) and complex reified (Q5, Q6,
    Q8) queries ranked ascending."""
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
        if kind == 0:
            b.plain(e, ns["hasPopulationDensity"], b.num(float(popul[i])))
            b.plain(e, ns["hasEconomicGrowth"], b.num(float(growth[i])))
            if i % 5 == 0:
                b.plain(e, ns["hasInflation"], b.num(float(infl[i])))
        elif kind == 1:
            b.plain(e, ns["hasNumberOfPeople"], b.num(float(people[i])))
        else:
            b.plain(e, ns["hasPopulationDensity"], b.num(float(popul[i])))
            b.plain(e, ns["hasNumberOfPeople"], b.num(float(people[i])))
        if i % 4 == 0:
            b.plain(e, ns["hasNeighbor"], places[max(0, i - 1)])
        if i % 6 == 0:
            b.plain(b.term(f"conn{i}"), ns["isConnectedTo"], e)
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

    pa, pb = V("place"), V("nplace")
    d = extent * 0.02

    def star(extra_a: tuple, extra_b: tuple, k: int = 100) -> Template:
        pats = [
            (None, pa, ns["hasPopulationDensity"], V("popul")),
            (None, pa, ns["hasGeometry"], V("g1")),
            (None, pa, ns["isLocatedIn"], V("loc1")),
            (None, pb, ns["hasNumberOfPeople"], V("popul1")),
            (None, pb, ns["hasGeometry"], V("g2")),
            (None, pb, ns["isLocatedIn"], V("loc2")),
        ]
        pats += [(None, pa, ns[p], V(f"a_{p}")) for p in extra_a]
        pats += [(None, pb, ns[p], V(f"b_{p}")) for p in extra_b]
        return Template((pa, pb), tuple(pats), V("g1"), V("g2"), d,
                        ((V("popul"), 1.0), (V("popul1"), 1.0)), False, k)

    def complex_reified(pred: str, k: int = 100) -> Template:
        pats = (
            (V("r"), V("a"), ns[pred], V("b")),
            (None, V("r"), ns["hasConfidence"], V("conf")),
            (None, V("b"), ns["hasGeometry"], V("g1")),
            (None, pb, ns["hasNumberOfPeople"], V("popul1")),
            (None, pb, ns["hasGeometry"], V("g2")),
            (None, pb, ns["isLocatedIn"], V("loc2")),
        )
        return Template((V("a"), pb), pats, V("g1"), V("g2"), d,
                        ((V("conf"), 1.0), (V("popul1"), 1.0)), False, k)

    templates = [
        star((), ()),                                            # Q1
        star(("hasEconomicGrowth",), ()),                        # Q2
        star(("hasEconomicGrowth",), ("isLocatedIn",)),          # Q3
        star(("hasEconomicGrowth", "hasNeighbor"), ()),          # Q4
        complex_reified("happenedIn"),                           # Q5
        complex_reified("wasBornIn"),                            # Q6
        star(("hasNeighbor",), ()),                              # Q7
        complex_reified("happenedIn", k=10),                     # Q8
    ]
    return b.dataset("yago3", ns["hasGeometry"], templates, extent)


GENERATORS = {"lgd": make_lgd, "yago3": make_yago}


def relabel(ds: Dataset, seed: int) -> Dataset:
    """`ds` under new term ids, drawn from `seed`: the same terms interned
    in another order, the same quads in another order."""
    rng = np.random.default_rng([int(seed), 0xDA7A])
    n = len(ds.terms)
    perm = rng.permutation(n)
    new = np.concatenate([[0], perm + 1]).astype(np.int64)   # old -> new id
    terms = [""] * n
    for i, t in enumerate(ds.terms):
        terms[perm[i]] = t
    quads = new[ds.quads]
    quads = quads[rng.permutation(len(quads))]

    def term(t):
        return t if t is None or isinstance(t, V) else int(new[int(t)])

    templates = [dataclasses.replace(
        tpl, patterns=tuple(tuple(term(t) for t in p) for p in tpl.patterns))
        for tpl in ds.templates]
    return Dataset(ds.name, terms, quads, int(new[ds.geometry_predicate]),
                   {int(new[e]): b for e, b in ds.boxes.items()},
                   {int(new[e]): g for e, g in ds.exact.items()},
                   templates, ds.extent)


def generator(name: str, root: pathlib.Path = files.ROOT):
    """`GENERATORS[name]`, or the `make` of `root`/portbench/generators/
    `name`.py."""
    if name in GENERATORS:
        return GENERATORS[name]
    return files.load("generators", name, root).make


def make(config: dict, seed: int, root: pathlib.Path = files.ROOT
         ) -> Dataset:
    """A configuration's dataset, under identifiers drawn from `seed`."""
    ds = generator(config["generator"], root)(**config["scale"],
                                               seed=config["data_seed"])
    return relabel(ds, seed)
