"""Real-format ingestion: GTFS-flavored POI CSVs -> QuadStore.

The synthetic generators (synth_rdf.py) exercise the engine at scale but
every value in them is drawn from a distribution the tests control. This
module ingests the shape of data Geographica-style workloads actually start
from — a `stops.txt`-like CSV of POIs with ids, names, lat/lon coordinates
and numeric attribute columns — and assembles the same `QuadStore` the
synthetic path builds, so every query shape (top-k join, range, within,
kNN, spatial join) runs on it unchanged:

- each row becomes an entity `stop:<stop_id>` with a POINT geometry at
  (lon, lat) — world x = longitude, y = latitude, the GeoSPARQL axis order;
- a reified ``rdf:type gtfs:Stop`` fact carries the row order as a
  confidence stand-in only when no numeric column exists;
- every extra column that parses as a float on every non-empty row becomes
  a numeric predicate ``gtfs:<column>`` with interned numeric literals —
  i.e. a rankable predicate with a directed numeric index, usable in
  ``ORDER BY`` rankings exactly like the synthetic ``hasConfidence``;
- non-numeric extra columns become plain string-object predicates.

Blank cells skip the quad (SPARQL open-world: the row simply has no such
fact), which also exercises the engine's NaN-score drop path when such a
column is used for ranking.

Parsing and quad assembly are host work, as is the store build; a 41-line
sample lives at `SAMPLE` (``data/samples/gtfs_stops.csv``).
"""
from __future__ import annotations

import csv
import dataclasses
import io
import pathlib

import numpy as np

from ..core.dictionary import Dictionary
from ..core.store import QuadStore, build_store

REQUIRED_COLUMNS = ("stop_id", "stop_name", "stop_lat", "stop_lon")
SAMPLE = pathlib.Path(__file__).resolve().parent / "samples" / "gtfs_stops.csv"


@dataclasses.dataclass
class IngestedDataset:
    """A CSV ingested into a queryable store.

    ns maps every predicate/class term used during ingestion to its
    (post-tree-build, spatial) dictionary id; numeric_columns lists the
    CSV columns that became rankable predicates.
    """
    store: QuadStore
    ns: dict
    n_stops: int
    numeric_columns: tuple
    string_columns: tuple


def parse_stops_csv(source) -> list[dict]:
    """Parse a GTFS-stops-flavored CSV into row dicts.

    `source` is a filesystem path or an already-open text stream. The four
    GTFS-required columns must be present; every other column rides along
    verbatim (classification into numeric/string happens at quad-build
    time, over the whole column). Raises ValueError on missing required
    columns, unparseable coordinates, or duplicate stop_ids.
    """
    if hasattr(source, "read"):
        rows = list(csv.DictReader(source))
    else:
        with open(source, newline="") as fh:
            rows = list(csv.DictReader(fh))
    if not rows:
        raise ValueError("empty stops CSV")
    missing = [c for c in REQUIRED_COLUMNS if c not in rows[0]]
    if missing:
        raise ValueError(f"stops CSV missing required columns: {missing}")
    seen: set = set()
    for i, row in enumerate(rows):
        sid = (row["stop_id"] or "").strip()
        if not sid:
            raise ValueError(f"row {i}: empty stop_id")
        if sid in seen:
            raise ValueError(f"row {i}: duplicate stop_id {sid!r}")
        seen.add(sid)
        try:
            row["stop_lat"] = float(row["stop_lat"])
            row["stop_lon"] = float(row["stop_lon"])
        except (TypeError, ValueError):
            raise ValueError(f"row {i} ({sid}): unparseable coordinates")
    return rows


def parse_stops_text(text: str) -> list[dict]:
    """`parse_stops_csv` over an in-memory CSV string (tests, fixtures)."""
    return parse_stops_csv(io.StringIO(text))


def _classify_columns(rows: list[dict]) -> tuple[list, list]:
    """Split extra columns into numeric (every non-empty cell parses as a
    float, at least one non-empty cell) and string columns."""
    extras = [c for c in rows[0] if c not in REQUIRED_COLUMNS]
    numeric, string = [], []
    for c in extras:
        cells = [(r.get(c) or "").strip() for r in rows]
        filled = [v for v in cells if v]
        if filled:
            try:
                for v in filled:
                    float(v)
                numeric.append(c)
                continue
            except ValueError:
                pass
            string.append(c)
    return numeric, string


def build_stops_store(source, l_max: int = 8, leaf_capacity: int = 64,
                      block: int = 256) -> IngestedDataset:
    """Ingest a stops CSV (path, stream, or pre-parsed row list) into a
    QuadStore with geometries, characteristic sets, and numeric indexes."""
    rows = source if isinstance(source, list) else parse_stops_csv(source)
    numeric_cols, string_cols = _classify_columns(rows)

    d = Dictionary.empty()
    names = ["rdf:type", "gtfs:Stop", "gtfs:name", "hasGeometry",
             "hasConfidence"]
    names += [f"gtfs:{c}" for c in numeric_cols + string_cols]
    ns = {t: d.intern(t) for t in names}

    quads: list[tuple[int, int, int, int]] = []
    geoms: dict = {}
    exact: dict = {}
    fact_n = 0
    for i, row in enumerate(rows):
        e = d.intern(f"stop:{row['stop_id'].strip()}")
        geo = d.intern(f"geom:stop:{row['stop_id'].strip()}")
        x, y = float(row["stop_lon"]), float(row["stop_lat"])
        geoms[e] = (x, y, x, y)
        exact[e] = np.array([[x, y]], dtype=np.float64)
        g = d.intern(f"_:stopfact{fact_n}")
        fact_n += 1
        quads.append((g, e, ns["rdf:type"], ns["gtfs:Stop"]))
        if not numeric_cols:
            # no rankable column in the file: row order as a stand-in so
            # top-k queries stay expressible
            quads.append((0, g, ns["hasConfidence"],
                          d.intern_numeric(float(i) / max(len(rows), 1))))
        quads.append((0, e, ns["gtfs:name"],
                      d.intern(f"name:{(row['stop_name'] or '').strip()}")))
        quads.append((0, e, ns["hasGeometry"], geo))
        for c in numeric_cols:
            v = (row.get(c) or "").strip()
            if v:
                quads.append((0, e, ns[f"gtfs:{c}"],
                              d.intern_numeric(float(v))))
        for c in string_cols:
            v = (row.get(c) or "").strip()
            if v:
                quads.append((0, e, ns[f"gtfs:{c}"], d.intern(f"{c}:{v}")))

    store = build_store(np.array(quads, dtype=np.int64), d,
                        geometry_predicate=ns["hasGeometry"],
                        geometries=geoms, exact_geoms=exact,
                        l_max=l_max, leaf_capacity=leaf_capacity,
                        block=block)
    ns = {t: store.dictionary.term_to_id[t] for t in ns}
    return IngestedDataset(store=store, ns=ns, n_stops=len(rows),
                           numeric_columns=tuple(numeric_cols),
                           string_columns=tuple(string_cols))
