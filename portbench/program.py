"""The system under test: `repro_torch`, given only the generated data.

The only module of the harness that builds the program's objects. It hands
the port the generated quads, boxes, exact geometries and queries, builds
one long-lived engine, and decodes the answers back into the generator's
own term ids for the comparison. Nothing here computes an answer: a query
is built, and an answer decoded, by its template's shape
(``shapes/<shape>.py``).
"""
from __future__ import annotations

import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent


def import_port():
    """The `repro_torch` package of this checkout (its `src/`)."""
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    import repro_torch
    return repro_torch


def shapes_of(templates, root: pathlib.Path = ROOT) -> dict:
    """{shape: its module, `root`/portbench/shapes/<shape>.py} of the
    templates' shapes."""
    from . import files
    return {s: files.load("shapes", s, root)
            for s in sorted({t.shape for t in templates})}


class Program:
    """One store and one engine of the port, built from a `datagen.Dataset`.

    `config` is the configuration file's dict: "store" holds
    `build_store`'s block and tree sizes, "policy" the `BackendPolicy`."""

    def __init__(self, ds, config: dict, device: str,
                 root: pathlib.Path = ROOT):
        rt = import_port()
        from repro_torch.core.dictionary import Dictionary
        d = Dictionary.empty()
        for t in ds.terms:             # ids 1..n in the generator's order
            d.intern(t)
        self.store = rt.build_store(
            ds.quads, d, geometry_predicate=ds.geometry_predicate,
            geometries=ds.boxes, exact_geoms=ds.exact, **config["store"])
        self.rt = rt
        self.device = device
        self.cfg = rt.ExecConfig(policy=rt.BackendPolicy(**config["policy"]))
        self.ds_terms = ds.terms
        self._to_prog = self.store.dictionary.term_to_id
        self._ours: dict | None = None
        self.shapes = shapes_of(ds.templates, root)

    # -- queries ---------------------------------------------------------
    def term(self, t):
        """A template's term (a generator id, a `datagen.V` or None) as
        the port's."""
        from .datagen import V
        if t is None:
            return None
        if isinstance(t, V):
            return self.rt.Var(t.name)
        return int(self._to_prog[self.ds_terms[int(t) - 1]])

    def select(self, tpl) -> tuple:
        return tuple(self.rt.Var(v.name) for v in tpl.select)

    def patterns(self, tpl) -> tuple:
        """The template's (g, s, p, o) patterns as the port's."""
        return tuple(self.rt.TriplePattern(self.term(s), self.term(p),
                                           self.term(o), g=self.term(g))
                     for g, s, p, o in tpl.patterns)

    def query(self, tpl, req):
        """The port's `Query` for template `tpl` and request `req`, as the
        template's shape builds it."""
        return self.shapes[tpl.shape].query(self, tpl, req)

    # -- engines ---------------------------------------------------------
    def serve_engine(self, max_slots: int):
        from repro_torch.serve.spatial import SpatialServeEngine
        return SpatialServeEngine(self.store, self.cfg, max_slots=max_slots,
                                  device=self.device)

    def serial_engine(self):
        return self.rt.StreakEngine(self.store, self.cfg, device=self.device)

    def new_request(self, rid: int, query):
        from repro_torch.serve.spatial import SpatialRequest
        return SpatialRequest(rid=rid, query=query)

    # -- answers ---------------------------------------------------------
    def decode(self, tpl, scores, rows) -> tuple[np.ndarray, np.ndarray]:
        """(scores, keys) of one answer, as the template's shape decodes
        it (`keys`, where the shape gives no `decode`)."""
        shape = self.shapes[tpl.shape]
        if hasattr(shape, "decode"):
            return shape.decode(self, tpl, scores, rows)
        return self.keys(tpl, scores, rows)

    def keys(self, tpl, scores, rows) -> tuple[np.ndarray, np.ndarray]:
        """(scores (n,) f64, keys (n, len(select)) generator term ids) of
        one answer: the selected variables' bindings in the generator's
        ids, through the store's dictionary."""
        if self._ours is None:
            self._ours = {t: i for i, t in enumerate(self.ds_terms, start=1)}
        scores = np.asarray(scores, dtype=np.float64)
        n = len(scores)
        keys = np.zeros((n, len(tpl.select)), dtype=np.int64)
        names = self.store.dictionary.id_to_term
        for c, v in enumerate(tpl.select):
            col = rows.get(v.name) if rows is not None else None
            if col is None or len(col) != n:
                keys[:, c] = -1        # a malformed answer: matches nothing
                continue
            keys[:, c] = [self._ours.get(names.get(int(x)), -1) for x in col]
        return scores, keys
