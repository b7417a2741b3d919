"""Geometry primitives: extents, MBRs, distances.

All boxes are ``(xmin, ymin, xmax, ymax)`` float64 rows. World coordinates are
normalized into the unit square via :class:`Extent` before indexing, so the
quadtree / Z-order machinery only ever sees ``[0, 1)^2``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

EARTH_RADIUS_KM = 6371.0088


@dataclasses.dataclass(frozen=True)
class Extent:
    """World bounding box with normalization helpers."""

    xmin: float
    ymin: float
    xmax: float
    ymax: float

    @staticmethod
    def of(boxes: np.ndarray, pad: float = 1e-9) -> "Extent":
        boxes = np.asarray(boxes, dtype=np.float64)
        span_x = float(boxes[:, 2].max() - boxes[:, 0].min())
        span_y = float(boxes[:, 3].max() - boxes[:, 1].min())
        # pad so that max coordinate maps strictly inside [0, 1)
        px = max(span_x, 1e-12) * pad + 1e-12
        py = max(span_y, 1e-12) * pad + 1e-12
        return Extent(
            float(boxes[:, 0].min()), float(boxes[:, 1].min()),
            float(boxes[:, 2].max()) + px, float(boxes[:, 3].max()) + py,
        )

    @property
    def width(self) -> float:
        return self.xmax - self.xmin

    @property
    def height(self) -> float:
        return self.ymax - self.ymin

    def normalize(self, boxes: np.ndarray) -> np.ndarray:
        boxes = np.asarray(boxes, dtype=np.float64)
        out = np.empty_like(boxes)
        out[:, 0] = (boxes[:, 0] - self.xmin) / self.width
        out[:, 2] = (boxes[:, 2] - self.xmin) / self.width
        out[:, 1] = (boxes[:, 1] - self.ymin) / self.height
        out[:, 3] = (boxes[:, 3] - self.ymin) / self.height
        return np.clip(out, 0.0, np.nextafter(1.0, 0.0))

    def denormalize_distance(self, d_world: float) -> float:
        """World distance -> normalized-space distance (isotropic approx).

        The spatial filter ``distance(a, b) < d`` is evaluated in world units
        during refinement; the normalized distance is only used for
        conservative MBR pruning, so we take the *smaller* scale to stay
        safe: normalization is anisotropic (x / width, y / height), and a
        world distance d spans up to d / min(width, height) in normalized
        space. Dividing by the larger span under-covers the other axis and
        prunes qualifying boundary pairs (caught by the differential query
        fuzzer on anisotropic extents).
        """
        return d_world / min(self.width, self.height)


def point_boxes(xy: np.ndarray) -> np.ndarray:
    """Degenerate MBRs for point data, shape (n, 2) -> (n, 4)."""
    xy = np.asarray(xy, dtype=np.float64)
    return np.concatenate([xy, xy], axis=1)


def boxes_intersect(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise-broadcast box intersection test. a: (..., 4), b: (..., 4)."""
    return (
        (a[..., 0] <= b[..., 2]) & (b[..., 0] <= a[..., 2])
        & (a[..., 1] <= b[..., 3]) & (b[..., 1] <= a[..., 3])
    )


def expand_boxes(boxes: np.ndarray, d: float) -> np.ndarray:
    out = np.array(boxes, dtype=np.float64, copy=True)
    out[..., 0] -= d
    out[..., 1] -= d
    out[..., 2] += d
    out[..., 3] += d
    return out


def union_boxes(boxes: np.ndarray) -> np.ndarray:
    """Union MBR over the leading axis; returns (4,)."""
    return np.array([
        boxes[:, 0].min(), boxes[:, 1].min(),
        boxes[:, 2].max(), boxes[:, 3].max(),
    ])


def clip_boxes(boxes: np.ndarray, cell: np.ndarray) -> np.ndarray:
    out = np.array(boxes, dtype=np.float64, copy=True)
    out[..., 0] = np.maximum(out[..., 0], cell[0])
    out[..., 1] = np.maximum(out[..., 1], cell[1])
    out[..., 2] = np.minimum(out[..., 2], cell[2])
    out[..., 3] = np.minimum(out[..., 3], cell[3])
    return out


def box_min_dist(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Minimum euclidean distance between two boxes (0 when intersecting)."""
    dx = np.maximum(0.0, np.maximum(a[..., 0] - b[..., 2], b[..., 0] - a[..., 2]))
    dy = np.maximum(0.0, np.maximum(a[..., 1] - b[..., 3], b[..., 1] - a[..., 3]))
    return np.sqrt(dx * dx + dy * dy)


def centroids(boxes: np.ndarray) -> np.ndarray:
    return np.stack(
        [(boxes[..., 0] + boxes[..., 2]) * 0.5, (boxes[..., 1] + boxes[..., 3]) * 0.5],
        axis=-1,
    )


def euclid_dist(p: np.ndarray, q: np.ndarray) -> np.ndarray:
    d = p - q
    return np.sqrt((d * d).sum(axis=-1))


def haversine_km(p: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Great-circle distance in km; p, q are (..., 2) [lon, lat] degrees."""
    lon1, lat1 = np.radians(p[..., 0]), np.radians(p[..., 1])
    lon2, lat2 = np.radians(q[..., 0]), np.radians(q[..., 1])
    dlat = lat2 - lat1
    dlon = lon2 - lon1
    h = (np.sin(dlat / 2.0) ** 2
         + np.cos(lat1) * np.cos(lat2) * np.sin(dlon / 2.0) ** 2)
    return 2.0 * EARTH_RADIUS_KM * np.arcsin(np.sqrt(np.clip(h, 0.0, 1.0)))
