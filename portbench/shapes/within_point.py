"""Geographica's reverse geocoding: every row whose geometry lies within d
of a device's position, scored by that distance.

    SELECT ?place ?name WHERE { one class, hasGeometry ?g, a name }
    FILTER(distance(?g, point) <= d)

The template (``generators/geographica_lgd.py``) gives the class, d
(`dist`) and the `anchors`. The device stands 0.5 d from the anchor that
the request's `pos[0]` picks, at the angle 2 pi `pos[1]`. A row's
distance is the least Euclidean distance from a stored float32 point of
its geometry to the device, in float64; the rows are every binding within
d (no ranking, no LIMIT): Geographica's ORDER BY distance LIMIT 1 is
their least.

The reference is NumPy over `reference.Reference`'s `bgp`,
`geometry_rows` and `points` (``range_select.rows``). Its answer holds
every row within d (1 + WINDOW), those within d (1 - WINDOW) marked sure,
as `check.judge` marks pairs near d. An answer is held to:

- wrong rows: rows of no reference row of the same bindings and the
  bit-equal float64 distance (each matches once);
- missed rows: sure reference rows lacking;
- edge gap: the largest |distance - d| / d of a row decided otherwise than
  the reference: kept beyond d, or within d and not sure and lacking.
"""
import math
import pathlib

import numpy as np

from portbench import check, files

READS = ("dist", "pos")

_range = files.load("shapes", "range_select",
                    pathlib.Path(__file__).resolve().parents[2])


def point(tpl, req) -> tuple:
    """The device's position."""
    x, y = _range.centre(tpl, req)
    r, a = 0.5 * float(req.dist), 2.0 * math.pi * req.pos[1]
    return (x + r * math.cos(a), y + r * math.sin(a))


def query(prog, tpl, req):
    rt = prog.rt
    return rt.Query(select=prog.select(tpl), patterns=prog.patterns(tpl),
                    spatial=rt.SpatialFilter(rt.Var(tpl.geo.name),
                                             dist=float(req.dist),
                                             center=point(tpl, req)),
                    ranking=None)


def distance(ref, pts: np.ndarray, c: tuple) -> np.ndarray:
    """Each row's least point distance to `c`, in the reference's
    precision."""
    rd, dt = ref._rd, ref.dtype
    diff = rd(pts - np.asarray(c, dtype=dt))
    sq = rd(diff * diff)
    return rd(np.sqrt(rd(sq[..., 0] + sq[..., 1]))).min(axis=1)


def answer(ref, tpl, reqs):
    """(keys, distance, d) of every row within d (1 + WINDOW)."""
    keys, pts = _range.rows(ref, tpl)
    d = float(reqs[0].dist)
    dist = distance(ref, pts, point(tpl, reqs[0])).astype(np.float64)
    near = dist <= d * (1 + check.WINDOW)
    return keys[near], dist[near], d


def judge(ans, scores, keys, req, tpl):
    ref_keys, dist, d = ans
    used = _range.match(ref_keys, keys, dist, scores)
    wrong = int(len(keys) - used.sum())
    sure = dist <= d * (1 - check.WINDOW)
    missed = int(np.count_nonzero(sure & ~used))
    gaps = np.concatenate([dist[used & (dist > d)] - d,
                           d - dist[~used & ~sure & (dist <= d)]])
    return wrong, missed, float(gaps.max() / d) if len(gaps) else 0.0


def served(ref, tpl, reqs):
    """The rows within d of each request's device, with their distances,
    as the program would serve them."""
    keys, pts = _range.rows(ref, tpl)
    out = []
    for r in reqs:
        dist = distance(ref, pts, point(tpl, r))
        ok = dist <= ref._rd(ref.dtype(r.dist))
        out.append((dist[ok].astype(np.float64), keys[ok]))
    return out
