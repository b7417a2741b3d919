"""APS: Adaptive Processing for Spatial filters (paper §3.3).

Per driver block, estimate the cost of routing the block through

  N-Plan -- driven numeric predicate pushed down: fetch the driven numeric
            index block-wise in score order, early-terminating against the
            shared top-k threshold. Cost grows with `x`, the estimated number
            of driven blocks needed (eq. 3), and pays a per-block random
            access/decompression penalty.
  S-Plan -- spatial join pushed down: one SIP-filtered full scan of the driven
            side; cost grows with C(R), the driven cardinality estimated from
            the spatial characteristic-set statistics at the selected V* nodes.

and route the block through the cheaper one. Because the top-k state is
shared, switching per block costs nothing.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .. import tracing


@dataclasses.dataclass(frozen=True)
class CostParams:
    beta_row: float = 1.0      # per-row CPU cost of scan+join work
    beta_seek: float = 32.0    # per-block penalty for N-Plan's repeated
    #                            unsorted accesses (paper §5.2: "overhead of
    #                            retrieving and uncompressing all blocks")
    gamma_join: float = 0.5    # per-candidate spatial-join cost


@dataclasses.dataclass
class PlanDecision:
    plan: str          # "N" or "S"
    cost_n: float
    cost_s: float
    x_blocks: int      # estimated driven blocks before early termination
    c_r: float         # C(R): driven cardinality estimate from V* CS stats
    c_ri: float        # C(R_i) = x * C(R) / nb   (eq. 3 surroundings)


def estimate_c_r(tree, v_star: np.ndarray, driven_cs: np.ndarray,
                 card_all: np.ndarray | None = None) -> float:
    """C(R) from the spatial CS cardinalities stored in the S-QuadTree."""
    if card_all is not None:
        return float(card_all[np.asarray(v_star, dtype=np.int64)].sum())
    total = 0.0
    for a in np.asarray(v_star, dtype=np.int64):
        total += tree.cs_stats.cardinality(int(a), driven_cs)
    return total


@tracing.spanned("driven.aps")
def choose(tree, v_star, driven_cs, driven_scan, key_needed: float,
           driver_block_rows: int,
           params: CostParams = CostParams(),
           card_all: np.ndarray | None = None) -> PlanDecision:
    """Route one driver block.

    key_needed: minimum driven score-key that could still produce a top-k
    result given the current threshold and this block's driver keys
    (-inf while the heap is not full -> all blocks needed).
    """
    c_r = estimate_c_r(tree, v_star, driven_cs, card_all)
    if driven_scan is None:
        return PlanDecision("S", np.inf, 0.0, 0, c_r, 0.0)
    nb = max(driven_scan.n_blocks, 1)
    x = driven_scan.blocks_needed(key_needed)
    block_rows = driven_scan.ni.block
    c_ri = x * c_r / nb
    # eq. 3 shape: block-wise (N) pays x * T(R_i) with a per-block random
    # access penalty; full-scan (S) pays T(R) over the SIP-reduced C(R).
    cost_n = x * (params.beta_row * block_rows + params.beta_seek) \
        + params.gamma_join * (c_ri + driver_block_rows)
    cost_s = params.beta_row * c_r \
        + params.gamma_join * (c_r + driver_block_rows)
    plan = "N" if cost_n <= cost_s else "S"
    return PlanDecision(plan, cost_n, cost_s, x, c_r, c_ri)
