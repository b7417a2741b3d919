"""The (S, Z, I, L) identifier codec (paper §3.1.1).

Layout of a 64-bit identifier (MSB -> LSB); bit 63 stays 0 so ids are
non-negative int64:

    [63] 0 | [62] S | [42..61] Z-path (2*L_MAX = 20 bits, level-aligned)
    | [38..41] L (4 bits) | [0..37] I (38 bits local id)

``Z`` is the Morton path of the deepest node that fully encloses the object,
*left-aligned* to L_MAX levels (a node at level l occupies the top 2l bits of
the field, with zeros below). Because Z sits directly under S, every quadtree
subtree owns one contiguous id interval -> I-Range pruning is two comparisons.
L disambiguates objects assigned to an ancestor from those assigned to its
first child (both share the zero-padded path). The paper fixes |L| = 4 and
L_MAX = 10 ("little benefit beyond 4^10 quadrants"); we keep those defaults
but parameterize for tests.
"""
from __future__ import annotations

import dataclasses

import numpy as np

L_MAX = 10
Z_BITS = 2 * L_MAX          # 20
L_BITS = 4
I_BITS = 62 - Z_BITS - L_BITS  # 38

S_SHIFT = 62
Z_SHIFT = L_BITS + I_BITS      # 42
L_SHIFT = I_BITS               # 38

S_MASK = np.int64(1) << np.int64(S_SHIFT)
Z_MASK = ((np.int64(1) << np.int64(Z_BITS)) - 1) << np.int64(Z_SHIFT)
L_MASK = ((np.int64(1) << np.int64(L_BITS)) - 1) << np.int64(L_SHIFT)
I_MASK = (np.int64(1) << np.int64(I_BITS)) - 1

MAX_LOCAL = (1 << I_BITS) - 1


@dataclasses.dataclass(frozen=True)
class SpatialId:
    spatial: bool
    zpath: int   # morton path at the object's own level (2*level bits)
    level: int
    local: int


def encode(zpath: np.ndarray, level: np.ndarray, local: np.ndarray) -> np.ndarray:
    """Vectorized spatial-id encode. `zpath` is at the object's own level."""
    zpath = np.asarray(zpath, dtype=np.int64)
    level = np.asarray(level, dtype=np.int64)
    local = np.asarray(local, dtype=np.int64)
    z_aligned = zpath << (2 * (L_MAX - level))
    return (
        S_MASK
        | (z_aligned << np.int64(Z_SHIFT))
        | (level << np.int64(L_SHIFT))
        | (local & I_MASK)
    )


def decode(ids: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Returns (spatial?, zpath-at-own-level, level, local)."""
    ids = np.asarray(ids, dtype=np.int64)
    spatial = (ids & S_MASK) != 0
    level = (ids & L_MASK) >> np.int64(L_SHIFT)
    z_aligned = (ids & Z_MASK) >> np.int64(Z_SHIFT)
    zpath = z_aligned >> (2 * (L_MAX - level))
    local = ids & I_MASK
    return spatial, zpath, level, local


def is_spatial(ids: np.ndarray) -> np.ndarray:
    return (np.asarray(ids, dtype=np.int64) & S_MASK) != 0


def subtree_interval(zpath: np.ndarray, level: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Closed id interval [lo, hi] owned by the subtree of node (zpath, level).

    This *is* the node's I-Range: by construction it covers every object whose
    deepest enclosing node lies in the subtree (paper §3.1.2).
    """
    zpath = np.asarray(zpath, dtype=np.int64)
    level = np.asarray(level, dtype=np.int64)
    z_lo = zpath << (2 * (L_MAX - level))
    z_hi = (zpath + 1) << (2 * (L_MAX - level))
    # `lo` carries the node's own level: an object assigned to an ANCESTOR has
    # a zero-padded Z-path that coincides with the leftmost-descendant prefix,
    # and only the L field (which sorts below Z) separates it from the subtree
    # -- this is exactly why the codec stores L (paper §3.1.1).
    lo = S_MASK | (z_lo << np.int64(Z_SHIFT)) | (level << np.int64(L_SHIFT))
    # the last sibling's z_hi overflows the Z field: saturate to the maximum
    # spatial id instead of wrapping into the S bit.
    max_id = S_MASK | Z_MASK | L_MASK | I_MASK
    hi = np.where(z_hi >= np.int64(1) << np.int64(Z_BITS),
                  max_id, (S_MASK | (z_hi << np.int64(Z_SHIFT))) - 1)
    return lo, hi


def node_own_interval(zpath: np.ndarray, level: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Closed id interval of objects assigned to the node itself (same Z, L)."""
    zpath = np.asarray(zpath, dtype=np.int64)
    level = np.asarray(level, dtype=np.int64)
    z_aligned = zpath << (2 * (L_MAX - level))
    base = S_MASK | (z_aligned << np.int64(Z_SHIFT)) | (level << np.int64(L_SHIFT))
    return base, base | I_MASK


def nonspatial_ids(n: int, start: int = 1) -> np.ndarray:
    """Plain entity ids (S bit clear). 0 is reserved as NULL."""
    return np.arange(start, start + n, dtype=np.int64)
