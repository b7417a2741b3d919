"""The LGD-shaped store with Geographica's map scenarios (arXiv 1305.5653).

`make(n_per_class, seed)` is `datagen.make_lgd(n_per_class, seed)`, whose
quads, geometries and Q1-Q8 stay as they are, with six selection
templates appended (9-14): the macro benchmark's Map Search and Browsing
(a window around a looked-up place, over points of interest, roads and
land use) and Reverse Geocoding (what lies within a short distance of a
device near such a place).

Each selection is one class: its reified ``rdf:type`` fact, ``hasGeometry``
and one name-like predicate, so each entity gives one row. All six share
one tuple of `anchors`, the places users look up: 4,096 stored points of
hotels, pubs and police stations, drawn after `make_lgd` by a generator
of their own seeded from `seed`, so that windows start from a named
place, as Geographica's browsing does.
"""
import dataclasses

import numpy as np

from portbench import datagen

N_ANCHORS = 4096
ANCHOR_CLASSES = ("class:hotel", "class:pub", "class:police")


@dataclasses.dataclass(frozen=True)
class Selection:
    """SELECT select WHERE patterns FILTER(geometry `geo` in a window of
    half side `dist`, or within `dist` of a point) around a place of
    `anchors`; no ranking, no LIMIT (`k` unused)."""
    select: tuple
    patterns: tuple
    geo: datagen.V
    dist: float                 # the window's half side, or the radius
    extent: float
    anchors: tuple = dataclasses.field(repr=False)   # ((x, y), ...)
    k: int = 0
    shape: str = "range_select"


# (scenario, class, name-like predicate, shape, half side or radius)
SELECTIONS = (
    ("map browsing, POIs", "class:hotel", "name", "range_select", 2.5),
    ("map browsing, POIs", "class:pub", "name", "range_select", 2.5),
    ("map browsing, roads", "class:road", "name", "range_select", 2.5),
    ("map browsing, land use", "class:park", "label", "range_select", 5.0),
    ("reverse geocoding, street", "class:road", "name", "within_point", 1.0),
    ("reverse geocoding, POI", "class:hotel", "name", "within_point", 1.0),
)


def anchors(ds: datagen.Dataset, seed: int) -> tuple:
    """`N_ANCHORS` stored (float32) points of the `ANCHOR_CLASSES`'
    entities, drawn uniformly, with replacement, from a stream of
    `seed`'s own."""
    ents = [i for i, t in enumerate(ds.terms, start=1)
            if t.partition("/e")[0] in ANCHOR_CLASSES and "/e" in t]
    rng = np.random.default_rng([int(seed), 0x6E0])
    pick = rng.integers(0, len(ents), size=N_ANCHORS)
    pts = np.array([ds.exact[ents[i]][0] for i in pick], dtype=np.float32)
    return tuple(map(tuple, pts.astype(np.float64).tolist()))


def make(n_per_class: int, seed: int) -> datagen.Dataset:
    ds = datagen.make_lgd(n_per_class, seed)
    ids = {t: i for i, t in enumerate(ds.terms, start=1)}
    places = anchors(ds, seed)
    V = datagen.V

    def selection(cls, pred, shape, dist):
        place, name = V("place"), V(pred)
        return Selection(
            (place, name),
            ((V("r"), place, ids["rdf:type"], ids[cls]),
             (None, place, ids["hasGeometry"], V("g")),
             (None, place, ids[pred], name)),
            V("g"), float(dist), ds.extent, places,
            shape=shape)

    return dataclasses.replace(ds, templates=ds.templates + [
        selection(cls, pred, shape, dist)
        for _, cls, pred, shape, dist in SELECTIONS])
