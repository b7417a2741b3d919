"""The plain reference: top-k spatial-join answers from the query semantics.

Written from the meaning of a query over the generated quads, exact
geometries and numeric literals (`datagen.Dataset`), with NumPy alone: it
imports nothing of the program, and takes nothing the program made.

    SELECT ?a ?b WHERE { pattern A . pattern B }
    FILTER(distance(?g1, ?g2) <= d) ORDER BY ASC(sum w * value(?v)) LIMIT k

The patterns split into two parts joined only by the spatial filter (the
variables of ?g1's part and of ?g2's part). Each part is evaluated on its
own as a basic graph pattern (bag semantics, hash-free sort joins). A
pair's distance is the least Euclidean distance between any point of the
one exact geometry and any point of the other (the geometry of the subject
that ``hasGeometry`` binds ?g to), in float64. A pair's score is the sum of
its parts' ranking terms; a row whose ranking variable is not numeric has
no score and is no answer.

The answer is found without pairing every row with every row: for a
threshold T, a row is admitted where its score plus the other part's least
score is at most T (no pair of an unadmitted row scores at most T); T grows
so that each part admits at least four times as many rows each round, until
k answers that lie surely inside the distance score at most T, or every row
is in.

Other query shapes (``shapes/<shape>.py``) answer from the same pieces:
`bgp` evaluates a basic graph pattern, `geometry_rows` finds a geometry
term's exact points, `points` holds them.

Near the distance. The store keeps exact points as float32, and an exact
engine tests the distance on those: the reference takes the same float32
points and works in float64, so an engine's float32 arithmetic alone sets
it apart. Pairs whose distance lies within a share `window` of d are kept
and marked, with their distance; the comparison (`check.py`) reads how far
beyond d an answer's decided pairs lie, and holds that to its own limit.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Answer:
    """Every answer row with score <= T: scores (n,), keys (n, n_select)
    term ids, sure (n,) bool (False: within the window around the
    distance), dist (n,) each row's pair distance; d the query's."""
    scores: np.ndarray
    keys: np.ndarray
    sure: np.ndarray
    T: float
    dist: np.ndarray
    d: float


def bf16(x) -> np.ndarray:
    """`x` rounded to bfloat16 (to nearest, ties to even), as float32."""
    b = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    b = (b + np.uint32(0x7FFF) + ((b >> 16) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return b.view(np.float32)


class Reference:
    def __init__(self, ds, dtype=np.float64, dist_bf16: bool = False):
        """`dtype` is the precision values and distances are computed in:
        float64 is the reference; float32 is a control (`control.py`).
        `dist_bf16` computes the distances in bfloat16 instead, the other
        control: points, differences, squares, sums and roots rounded."""
        self.ds = ds
        self.dtype = dtype
        self._rd = bf16 if dist_bf16 else (lambda x: x)
        # a box test that cannot drop a pair bfloat16 would keep
        self._slack = 0.02 * ds.extent if dist_bf16 else 0.0
        self.quads = ds.quads
        num = ds.numeric()
        self._num_ids = np.fromiter(num.keys(), np.int64, len(num))
        self._num_vals = np.fromiter(num.values(), np.float64, len(num))
        order = np.argsort(self._num_ids)
        self._num_ids = self._num_ids[order]
        self._num_vals = self._num_vals[order]
        # geometry term -> the subject that hasGeometry gives it
        gq = self.quads[self.quads[:, 2] == ds.geometry_predicate]
        self._geo_obj = gq[:, 3]
        self._geo_subj = gq[:, 1]
        o = np.argsort(self._geo_obj, kind="stable")
        self._geo_obj, self._geo_subj = self._geo_obj[o], self._geo_subj[o]
        # exact geometries as padded (E, P, 2) point arrays: padding
        # repeats the last point, which never changes a least distance
        ents = np.array(sorted(ds.exact), dtype=np.int64)
        pmax = max(len(ds.exact[int(e)]) for e in ents)
        pts = np.empty((len(ents), pmax, 2), dtype=np.float64)
        for r, e in enumerate(ents):
            # the points as the store keeps them: float32
            g = np.asarray(ds.exact[int(e)], dtype=np.float32)
            pts[r, :len(g)] = g
            pts[r, len(g):] = g[-1]
        self._ents = ents
        self.points = self._rd(pts.astype(dtype))
        self._box = np.concatenate([pts.min(1), pts.max(1)], axis=1)
        self._scans: dict = {}
        self._parts: dict = {}

    # -- basic graph patterns --------------------------------------------
    def _scan(self, pat) -> dict:
        """Rows of one (g, s, p, o) pattern: var name -> column."""
        key = tuple(t.name if hasattr(t, "name") else t for t in pat)
        if key in self._scans:
            return self._scans[key]
        q = self.quads
        mask = np.ones(len(q), dtype=bool)
        cols: dict = {}
        for c, t in enumerate(pat):
            if t is None:
                continue
            if hasattr(t, "name"):
                if t.name in cols:     # a variable twice: equal columns
                    mask &= q[:, c] == q[:, cols[t.name]]
                else:
                    cols[t.name] = c
            else:
                mask &= q[:, c] == int(t)
        rows = q[mask]
        out = {name: rows[:, c].copy() for name, c in cols.items()}
        self._scans[key] = out
        return out

    @staticmethod
    def _n(rel: dict) -> int:
        return len(next(iter(rel.values()))) if rel else 0

    def _join(self, a: dict, b: dict) -> dict:
        """Bag equi-join on the shared variables."""
        on = [v for v in a if v in b]
        na, nb = self._n(a), self._n(b)
        if not on:
            ia = np.repeat(np.arange(na), nb)
            ib = np.tile(np.arange(nb), na)
        else:
            # one int64 key a row: the shared columns' dense ranks packed
            key = np.zeros(na + nb, dtype=np.int64)
            for v in on:
                _, rank = np.unique(np.concatenate([a[v], b[v]]),
                                    return_inverse=True)
                _, key = np.unique(key * (int(rank.max()) + 1) + rank,
                                   return_inverse=True)
            ga, gb = key[:na], key[na:]
            ob = np.argsort(gb, kind="stable")
            gbs = gb[ob]
            lo = np.searchsorted(gbs, ga, "left")
            hi = np.searchsorted(gbs, ga, "right")
            cnt = hi - lo
            ia = np.repeat(np.arange(na), cnt)
            off = np.arange(int(cnt.sum())) - np.repeat(np.cumsum(cnt) - cnt,
                                                        cnt)
            ib = ob[np.repeat(lo, cnt) + off]
        out = {v: col[ia] for v, col in a.items()}
        for v, col in b.items():
            if v not in out:
                out[v] = col[ib]
        return out

    def bgp(self, pats: list) -> dict:
        """Rows of a basic graph pattern (bag semantics): var name ->
        column."""
        rel = self._scan(pats[0])
        left = list(pats[1:])
        while left:
            # next: a pattern sharing a variable with what is joined
            idx = next((i for i, p in enumerate(left)
                        if any(hasattr(t, "name") and t.name in rel
                               for t in p)), 0)
            rel = self._join(rel, self._scan(left.pop(idx)))
        return rel

    def geometry_rows(self, g: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(has, row) of geometry terms `g`: whether ``hasGeometry`` gives
        each term's subject an exact geometry, and that geometry's row of
        `points` ((E, P, 2) in `dtype`, padded with each last point)."""
        # the geometry's subject, then its exact-geometry row
        pos = np.clip(np.searchsorted(self._geo_obj, g), 0,
                      max(len(self._geo_obj) - 1, 0))
        has_geo = (self._geo_obj[pos] == g) if len(self._geo_obj) else \
            np.zeros(len(g), dtype=bool)
        subj = self._geo_subj[pos]
        grow = np.clip(np.searchsorted(self._ents, subj), 0,
                       len(self._ents) - 1)
        has_geo &= self._ents[grow] == subj
        return has_geo, grow

    def _values(self, ids: np.ndarray) -> np.ndarray:
        pos = np.searchsorted(self._num_ids, ids)
        pos = np.clip(pos, 0, len(self._num_ids) - 1)
        hit = self._num_ids[pos] == ids
        return np.where(hit, self._num_vals[pos], np.nan)

    def _part(self, tpl, geo) -> tuple:
        """(score (n,), geometry row (n,), select columns (n, c) with -1
        where the select variable lies in the other part) of the part of
        `tpl` that binds `geo`, rows without a score or a geometry
        dropped."""
        key = (id(tpl), geo.name)
        if key in self._parts:
            return self._parts[key]
        comp = _components(tpl.patterns)
        mine = comp[geo.name]
        pats = [p for p in tpl.patterns
                if any(hasattr(t, "name") and comp[t.name] == mine
                       for t in p)]
        rel = self.bgp(pats)
        n = self._n(rel)
        score = np.zeros(n, dtype=self.dtype)
        for v, w in tpl.ranking:
            if v.name in rel:
                val = self._values(rel[v.name]).astype(self.dtype)
                score = score + self.dtype(w) * val
        has_geo, grow = self.geometry_rows(rel[geo.name])
        ok = has_geo & ~np.isnan(score)
        sel = np.full((n, len(tpl.select)), -1, dtype=np.int64)
        for c, v in enumerate(tpl.select):
            if v.name in rel:
                sel[:, c] = rel[v.name]
        out = (score[ok], grow[ok], sel[ok])
        self._parts[key] = out
        return out

    # -- the spatial top-k -----------------------------------------------
    def _pairs(self, ga: np.ndarray, gb: np.ndarray, r: float
               ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(i, j, distance) of every pair of geometry rows ga[i], gb[j]
        with a least point distance <= r: a grid over the boxes, then the
        exact distance."""
        if len(ga) == 0 or len(gb) == 0:
            e = np.empty(0, dtype=np.int64)
            return e, e, np.empty(0, dtype=self.dtype)
        rd = self._rd
        rb = float(r) + self._slack
        cell = max(rb, 1e-9) * 2.0
        ba, bb = self._box[ga], self._box[gb]
        ea = np.concatenate([ba[:, :2] - rb, ba[:, 2:] + rb], axis=1)
        ca_i, ca_c = _cells(ea, cell)
        cb_i, cb_c = _cells(bb, cell)
        ob = np.argsort(cb_c, kind="stable")
        cb_c, cb_i = cb_c[ob], cb_i[ob]
        lo = np.searchsorted(cb_c, ca_c, "left")
        hi = np.searchsorted(cb_c, ca_c, "right")
        cnt = hi - lo
        ii = np.repeat(ca_i, cnt)
        off = np.arange(int(cnt.sum())) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        jj = cb_i[np.repeat(lo, cnt) + off]
        pair = np.unique(ii.astype(np.int64) * len(gb) + jj)
        ii, jj = pair // len(gb), pair % len(gb)
        # boxes within r (a necessary condition of the least distance)
        dx = np.maximum(0.0, np.maximum(ba[ii, 0] - bb[jj, 2],
                                        bb[jj, 0] - ba[ii, 2]))
        dy = np.maximum(0.0, np.maximum(ba[ii, 1] - bb[jj, 3],
                                        bb[jj, 1] - ba[ii, 3]))
        near = dx * dx + dy * dy <= rb * rb * (1 + 1e-9) + 1e-12
        ii, jj = ii[near], jj[near]
        d = np.empty(len(ii), dtype=self.dtype)
        step = 1 << 18
        for s in range(0, len(ii), step):
            pa = self.points[ga[ii[s:s + step]]]          # (q, P, 2)
            pb = self.points[gb[jj[s:s + step]]]
            diff = rd(pa[:, :, None, :] - pb[:, None, :, :])
            sq = rd(diff * diff)
            d2 = rd(sq[..., 0] + sq[..., 1]).min(axis=(1, 2))
            d[s:s + step] = rd(np.sqrt(d2))
        keep = d <= rd(self.dtype(r))
        return ii[keep], jj[keep], d[keep]

    def answer(self, tpl, dist: float, k: int, window: float) -> Answer:
        """Every answer row of `tpl` at distance `dist` (and within a share
        `window` beyond it) with a score of at most T, where T admits at
        least k rows surely inside `dist` (or is +inf)."""
        if tpl.descending:
            raise ValueError("the reference ranks ascending templates only")
        sa, ga, ka = self._part(tpl, tpl.geo_a)
        sb, gb, kb = self._part(tpl, tpl.geo_b)
        if len(sa) == 0 or len(sb) == 0:
            return Answer(np.empty(0), np.empty((0, len(tpl.select)),
                                                np.int64),
                          np.empty(0, bool), float("inf"), np.empty(0),
                          float(dist))
        ma, mb = sa.min(), sb.min()
        # each row's least pair score; T admits at least the c rows with
        # the smallest of each part, so neither part starves when their
        # scores lie on different scales
        oa, ob = np.sort(sa + mb), np.sort(sb + ma)
        c = 256
        while True:
            T = (float(max(oa[min(c, len(oa)) - 1], ob[min(c, len(ob)) - 1]))
                 if c < max(len(oa), len(ob)) else float("inf"))
            ia = np.flatnonzero(sa + mb <= T)
            ib = np.flatnonzero(sb + ma <= T)
            i, j, d = self._pairs(ga[ia], gb[ib], dist * (1 + window))
            i, j = ia[i], ib[j]
            score = sa[i] + sb[j]
            keep = score <= T
            i, j, d, score = i[keep], j[keep], d[keep], score[keep]
            sure = d <= dist * (1 - window)
            if T == float("inf") or int(sure.sum()) >= k:
                keys = np.where(ka[i] >= 0, ka[i], kb[j])
                return Answer(score.astype(np.float64), keys, sure, T,
                              d.astype(np.float64), float(dist))
            c *= 4


def _components(patterns) -> dict:
    """var name -> component id, variables joined by sharing a pattern."""
    parent: dict = {}

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for p in patterns:
        names = [t.name for t in p if hasattr(t, "name")]
        for nm in names:
            parent.setdefault(nm, nm)
        for nm in names[1:]:
            parent[find(nm)] = find(names[0])
    return {v: find(v) for v in parent}


def _cells(boxes: np.ndarray, cell: float) -> tuple[np.ndarray, np.ndarray]:
    """(row, cell id) for every grid cell each box overlaps."""
    x0 = np.floor(boxes[:, 0] / cell).astype(np.int64)
    y0 = np.floor(boxes[:, 1] / cell).astype(np.int64)
    x1 = np.floor(boxes[:, 2] / cell).astype(np.int64)
    y1 = np.floor(boxes[:, 3] / cell).astype(np.int64)
    nx, ny = x1 - x0 + 1, y1 - y0 + 1
    n = nx * ny
    row = np.repeat(np.arange(len(boxes)), n)
    off = np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n)
    cx = np.repeat(x0, n) + off % np.repeat(nx, n)
    cy = np.repeat(y0, n) + off // np.repeat(nx, n)
    return row, (cx + (1 << 20)) * (1 << 21) + (cy + (1 << 20))
