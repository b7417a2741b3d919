"""Geographica's map browsing: every row whose geometry has a stored point
inside a window around a looked-up place.

    SELECT ?place ?name WHERE { one class, hasGeometry ?g, a name }
    FILTER(?g has a point in [x - h, x + h] x [y - h, y + h])

The template (``generators/geographica_lgd.py``) gives the class, the
half side h (`dist`) and the `anchors`; the request's `pos[0]` picks the
anchor, the window's centre. The window is closed, the rows are every
qualifying binding (no ranking, no LIMIT), each scored 0.

The reference is NumPy over `reference.Reference`'s `bgp`,
`geometry_rows` and `points` (the stored float32 points, in the
reference's precision). A row's depth is the distance from its deepest
point to the window's nearest edge, negative outside: the row qualifies
where it is at least 0. The answer holds every row of depth at least
-WINDOW * h, the rows deeper than WINDOW * h marked sure, as
`check.judge` marks pairs near d. An answer is held to:

- wrong rows: rows of no reference row (each matches once), or scored
  other than 0;
- missed rows: sure reference rows lacking;
- edge gap: the largest |depth| / h of a row decided otherwise than the
  reference: kept outside the window, or inside and not sure and lacking.

Rows are compared as multisets in the generator's ids: the port orders
them by its own ids.
"""
import collections
import weakref

import numpy as np

from portbench import check

READS = ("dist", "pos")

_ROWS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def centre(tpl, req) -> tuple:
    """The anchor that the request's place picks."""
    return tpl.anchors[int(req.pos[0] * len(tpl.anchors))]


def window(tpl, req) -> tuple:
    x, y = centre(tpl, req)
    h = float(req.dist)
    return (x - h, y - h, x + h, y + h)


def query(prog, tpl, req):
    rt = prog.rt
    return rt.Query(select=prog.select(tpl), patterns=prog.patterns(tpl),
                    spatial=rt.SpatialFilter(rt.Var(tpl.geo.name),
                                             window=window(tpl, req)),
                    ranking=None)


def rows(ref, tpl) -> tuple[np.ndarray, np.ndarray]:
    """(keys (n, len(select)), points (n, P, 2)) of the template's
    bindings whose geometry term has an exact geometry, once a reference
    and template."""
    per_ref = _ROWS.setdefault(ref, {})
    if id(tpl) not in per_ref:
        rel = ref.bgp(list(tpl.patterns))
        has, row = ref.geometry_rows(rel[tpl.geo.name])
        keys = np.stack([rel[v.name] for v in tpl.select], axis=1)[has]
        per_ref[id(tpl)] = (keys, ref.points[row[has]])
    return per_ref[id(tpl)]


def depth(ref, pts: np.ndarray, win: tuple) -> np.ndarray:
    """Each row's deepest point's distance inside the window's nearest
    edge (negative: outside), in the reference's precision."""
    rd, dt = ref._rd, ref.dtype
    x0, y0, x1, y1 = (dt(v) for v in win)
    x, y = pts[..., 0], pts[..., 1]
    inside = np.minimum(np.minimum(rd(x - x0), rd(x1 - x)),
                        np.minimum(rd(y - y0), rd(y1 - y)))
    return inside.max(axis=1)


def answer(ref, tpl, reqs):
    """(keys, depth / h) of every row of depth at least -WINDOW * h."""
    keys, pts = rows(ref, tpl)
    h = float(reqs[0].dist)
    margin = depth(ref, pts, window(tpl, reqs[0])).astype(np.float64) / h
    near = margin >= -check.WINDOW
    return keys[near], margin[near]


def judge(ans, scores, keys, req, tpl):
    ref_keys, margin = ans
    wrong = int(np.count_nonzero(np.asarray(scores) != 0))
    used = match(ref_keys, keys)
    wrong += int(len(keys) - used.sum())
    sure = margin >= check.WINDOW
    missed = int(np.count_nonzero(sure & ~used))
    gaps = np.concatenate([-margin[used & (margin < 0)],
                           margin[~used & ~sure & (margin >= 0)]])
    return wrong, missed, float(gaps.max()) if len(gaps) else 0.0


def match(ref_keys: np.ndarray, keys: np.ndarray,
          ref_scores=None, scores=None) -> np.ndarray:
    """Which reference rows the answer's rows match, each reference row
    once: on the keys, and on the bit-equal score where scores are
    given."""
    pool = collections.defaultdict(collections.deque)
    sc = ([None] * len(ref_keys) if ref_scores is None
          else np.asarray(ref_scores, np.float64).tolist())
    for i, (k, s) in enumerate(zip(ref_keys.tolist(), sc)):
        pool[(tuple(k), s)].append(i)
    used = np.zeros(len(ref_keys), dtype=bool)
    got = ([None] * len(keys) if scores is None
           else np.asarray(scores, np.float64).tolist())
    for k, s in zip(np.asarray(keys).tolist(), got):
        hit = pool.get((tuple(k), s))
        if hit:
            used[hit.popleft()] = True
    return used


def served(ref, tpl, reqs):
    """The rows inside each request's window, scored 0, as the program
    would serve them."""
    keys, pts = rows(ref, tpl)
    out = []
    for r in reqs:
        a = keys[depth(ref, pts, window(tpl, r)) >= 0]
        out.append((np.zeros(len(a)), a))
    return out
