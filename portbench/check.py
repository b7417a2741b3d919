"""The comparison that decides `correct`: an answer against the reference.

`limits` are the numbers compared, for every query shape; `judge` is the
top-k join's (``shapes/topk_join.py``). For one request the reference
gives every answer row with a score of at most T (`reference.Answer`),
each with its pair's distance, marked sure where that lies beyond a share
`WINDOW` inside the query's distance d. An answer of n rows, ordered best
first, is held to:

- wrong rows: rows beyond k, rows out of order, and rows that match no
  reference row of the same selected bindings and the bit-equal score
  (each reference row matches once);
- missed rows: sure reference rows scoring strictly better than the
  answer's last row (all sure rows, where the answer has fewer than k)
  that the answer lacks;
- edge gap: how far, as a share of d, the pairs that the answer decided
  against the reference lie from d: a row it keeps whose distance is
  beyond d, or a row inside d, within the window, and strictly better
  than its last row, that it lacks. 0 where it decided none.

Rows that tie with the last one may be any of the tied rows. The window
(2^-7 of d) is where the edge gap is read, not a tolerance: the gap has a
limit of its own, set between a sound engine's float32 arithmetic and a
control's bfloat16 distances (`PERF.md`).
"""
from __future__ import annotations

import collections

import numpy as np

WINDOW = 2.0 ** -7


def judge(scores: np.ndarray, keys: np.ndarray, ref, k: int,
          descending: bool = False) -> tuple[int, int, float]:
    """(wrong rows, missed rows, edge gap) of one answer."""
    scores = np.asarray(scores, dtype=np.float64)
    n = len(scores)
    wrong = max(0, n - k)
    s = -scores if descending else scores
    wrong += int((np.diff(s) < 0).sum()) if n > 1 else 0
    # only reference rows of a score the answer gives can match a row;
    # of equal rows, the nearest matches first
    near = np.flatnonzero(np.isin(ref.scores, scores))
    near = near[np.argsort(ref.dist[near], kind="stable")]
    pool = collections.defaultdict(collections.deque)
    for i, kr, sc in zip(near.tolist(), ref.keys[near].tolist(),
                         ref.scores[near].tolist()):
        pool[(tuple(kr), float(sc))].append(i)
    used = np.zeros(len(ref.scores), dtype=bool)
    for kr, sc in zip(keys.tolist(), scores.tolist()):
        rows = pool.get((tuple(kr), float(sc)))
        if rows:
            used[rows.popleft()] = True
        else:
            wrong += 1
    last = float(scores[-1]) if n >= k and n else float("inf")
    better = _better(ref.scores, last, descending)
    missed = int(np.count_nonzero(ref.sure & better & ~used))
    d = ref.d
    kept_out = used & (ref.dist > d)
    dropped_in = ~used & ~ref.sure & better & (ref.dist <= d)
    gaps = np.concatenate([ref.dist[kept_out] - d, d - ref.dist[dropped_in]])
    edge = float(gaps.max() / d) if len(gaps) and d > 0 else 0.0
    return wrong, missed, edge


def _better(a, b, descending: bool):
    return a > b if descending else a < b


def limits() -> dict:
    """Each number compared and its limit: an exact engine misses and
    alters no row, and answers every request; the edge gap's limit lies
    between its readings (PERF.md section 2)."""
    return {"wrong_rows": 0, "missed_rows": 0, "edge_gap": EDGE_GAP,
            "unanswered": 0}


# a share of d: above float32 arithmetic's reading, below bfloat16's
EDGE_GAP = 2.0 ** -14
