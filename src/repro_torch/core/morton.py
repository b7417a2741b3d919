"""Z-order (Morton) curve encoding.

The S-QuadTree imposes *equivalent hierarchies* for the quadtree and the
Z-curve (paper §3.1.1): the Z-order of a node at level ``l`` is the ``2l``-bit
prefix of the Morton codes of everything below it. Index construction is
host numpy, so this module is numpy only.
"""
from __future__ import annotations

import numpy as np

_B = [
    0x5555555555555555,
    0x3333333333333333,
    0x0F0F0F0F0F0F0F0F,
    0x00FF00FF00FF00FF,
    0x0000FFFF0000FFFF,
]


def _part1by1_np(x: np.ndarray) -> np.ndarray:
    """Spread the low 32 bits of x so there is a 0 between each bit."""
    x = x.astype(np.uint64) & np.uint64(0xFFFFFFFF)
    x = (x | (x << np.uint64(16))) & np.uint64(_B[4])
    x = (x | (x << np.uint64(8))) & np.uint64(_B[3])
    x = (x | (x << np.uint64(4))) & np.uint64(_B[2])
    x = (x | (x << np.uint64(2))) & np.uint64(_B[1])
    x = (x | (x << np.uint64(1))) & np.uint64(_B[0])
    return x


def _compact1by1_np(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64) & np.uint64(_B[0])
    x = (x | (x >> np.uint64(1))) & np.uint64(_B[1])
    x = (x | (x >> np.uint64(2))) & np.uint64(_B[2])
    x = (x | (x >> np.uint64(4))) & np.uint64(_B[3])
    x = (x | (x >> np.uint64(8))) & np.uint64(_B[4])
    x = (x | (x >> np.uint64(16))) & np.uint64(0xFFFFFFFF)
    return x


def interleave2(cx: np.ndarray, cy: np.ndarray) -> np.ndarray:
    """Morton code with x in even bits, y in odd bits (numpy, uint64)."""
    return _part1by1_np(np.asarray(cx)) | (_part1by1_np(np.asarray(cy)) << np.uint64(1))


def deinterleave2(z: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    z = np.asarray(z, dtype=np.uint64)
    return _compact1by1_np(z), _compact1by1_np(z >> np.uint64(1))


def cell_of(xy: np.ndarray, level: int) -> np.ndarray:
    """Integer cell coordinates of normalized points at a quadtree level."""
    n = 1 << level
    c = np.floor(np.asarray(xy, dtype=np.float64) * n).astype(np.int64)
    return np.clip(c, 0, n - 1)


def encode_points(xy: np.ndarray, level: int) -> np.ndarray:
    """Morton codes (2*level bits) of normalized points, numpy int64."""
    c = cell_of(xy, level)
    return interleave2(c[:, 0], c[:, 1]).astype(np.int64)


def common_level(z_lo: np.ndarray, z_hi: np.ndarray, level: int) -> np.ndarray:
    """Deepest level at which two Morton codes (at `level`) share a node.

    This is how an object's (Z, L) is derived: take the codes of the MBR's
    low/high corners at the max level; the deepest fully-enclosing node is
    their common Z-prefix (paper §3.1.1).
    """
    x = (np.asarray(z_lo) ^ np.asarray(z_hi)).astype(np.uint64)
    nbits = np.zeros(x.shape, dtype=np.int64)
    v = x.copy()
    for _ in range(2 * level):  # bit-length, vectorized
        nz = v != 0
        nbits += nz.astype(np.int64)
        v >>= np.uint64(1)
    # ceil(nbits / 2) quad-levels are lost to the differing suffix
    return level - ((nbits + 1) // 2)


def zpath_at(z: np.ndarray, from_level: int, to_level: int) -> np.ndarray:
    """Truncate a Morton code from `from_level` to its `to_level` prefix."""
    return np.asarray(z) >> np.int64(2 * (from_level - to_level))
