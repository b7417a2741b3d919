"""Block-wise top-k accumulation with threshold early termination (§3.3).

The TopK state is the piece both N-Plan and S-Plan share: because the heap and
threshold θ survive across blocks and plans, switching plans at a
materialization point costs nothing (the paper's "zero plan-switch cost").
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .join import Relation

NEG_INF = -np.inf


@dataclasses.dataclass
class TopK:
    k: int
    descending: bool = True
    scores: np.ndarray = dataclasses.field(
        default_factory=lambda: np.empty(0, dtype=np.float64))
    rows: Relation = dataclasses.field(default_factory=Relation)

    def _key(self, s: np.ndarray) -> np.ndarray:
        return s if self.descending else -s

    @property
    def theta(self) -> float:
        """Score of the k-th result so far; -inf until the heap is full.

        (In ascending mode this is reported in *key space*: compare with
        `key(score) > theta` to test if a candidate can still enter.)
        """
        if len(self.scores) < self.k:
            return NEG_INF
        return float(self._key(self.scores).min())

    @property
    def full(self) -> bool:
        return len(self.scores) >= self.k

    def push(self, scores: np.ndarray, rows: Relation) -> None:
        if len(scores) == 0:
            return
        if self.rows.n == 0 and rows.n > 0:
            self.rows = Relation({c: np.empty(0, dtype=v.dtype)
                                  for c, v in rows.items()})
        all_scores = np.concatenate([self.scores, scores])
        all_rows = Relation({c: np.concatenate([self.rows[c], rows[c]])
                             for c in rows})
        order = np.argsort(-self._key(all_scores), kind="stable")[: self.k]
        self.scores = all_scores[order]
        self.rows = all_rows.take(order)

    def results(self) -> tuple[np.ndarray, Relation]:
        order = np.argsort(-self._key(self.scores), kind="stable")
        return self.scores[order], self.rows.take(order)

    def can_improve(self, upper_bound: float) -> bool:
        """Could a candidate with this score bound still enter the top-k?"""
        return (not self.full) or (self._keyf(upper_bound) > self.theta)

    def _keyf(self, s: float) -> float:
        return s if self.descending else -s


# ----------------------------------------------------- per-row partial merge --
def _merge2(a: tuple[np.ndarray, np.ndarray],
            b: tuple[np.ndarray, np.ndarray], k: int
            ) -> tuple[np.ndarray, np.ndarray]:
    s = np.concatenate([a[0], b[0]], axis=1)
    i = np.concatenate([a[1], b[1]], axis=1)
    if s.shape[1] <= k:
        return s, i
    order = np.argsort(-s, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(s, order, 1), np.take_along_axis(i, order, 1)


def merge_row_partials(parts: list, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Two-level absorption of per-row top-k partials (fused join backend).

    Level 1 happens inside the fused kernel (tiles of one column batch fold
    into an (M, k) partial); this is level 2: partials from successive column
    batches merge pairwise — tournament style, (M, 2k) peak — into the global
    per-row top-k. The dense (M, N) matrix is never rebuilt.

    `parts` is a list of (scores (M, w_i), idx (M, w_i)) pairs; returns the
    merged (scores (M, <=k), idx) sorted descending per row, -inf/-1 padded.
    """
    if not parts:
        raise ValueError("merge_row_partials needs at least one partial")
    parts = list(parts)
    while len(parts) > 1:
        nxt = [_merge2(parts[i], parts[i + 1], k)
               for i in range(0, len(parts) - 1, 2)]
        if len(parts) % 2:
            nxt.append(parts[-1])
        parts = nxt
    s, i = parts[0]
    order = np.argsort(-s, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(s, order, 1), np.take_along_axis(i, order, 1)
