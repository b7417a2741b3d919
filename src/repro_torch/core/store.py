"""Quad store with exhaustive permutation indexes + numeric block summaries.

Follows RDF-3X / Quark-X (paper §3): quads ``(g, s, p, o)`` where ``g`` is the
reification (fact) id, stored under multiple sort orders so that any bound
prefix becomes a binary-search range scan. A per-predicate *numeric index*
keeps facts sorted by the literal value with per-block min/max summaries —
the substrate for top-k early termination and for the APS `x`-block estimate.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import charsets, geometry
from .dictionary import Dictionary
from .squadtree import SQuadTree, build as build_tree, csr_gather

# column order names -> tuple of column indices into (g, s, p, o)
G, S, P, O = 0, 1, 2, 3
ORDERS = {
    "spog": (S, P, O, G), "posg": (P, O, S, G), "ospg": (O, S, P, G),
    "psog": (P, S, O, G), "opsg": (O, P, S, G), "sopg": (S, O, P, G),
    "gspo": (G, S, P, O), "pogs": (P, O, G, S),
}
DEFAULT_BLOCK = 1024


@dataclasses.dataclass
class NumericIndex:
    """Facts of one predicate sorted by numeric object value (descending)."""

    values: np.ndarray     # (m,) float64, sorted desc
    subjects: np.ndarray   # (m,) int64
    objects: np.ndarray    # (m,) int64 literal ids
    facts: np.ndarray      # (m,) int64 (g column)
    block: int
    block_max: np.ndarray  # (nb,) upper bound per block (= first value)
    block_min: np.ndarray  # (nb,) lower bound per block

    @property
    def n_blocks(self) -> int:
        return len(self.block_max)

    @property
    def n_rows(self) -> int:
        return len(self.values)

    def get_block(self, b: int) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                                         np.ndarray]:
        sl = slice(b * self.block, min((b + 1) * self.block, len(self.values)))
        return self.values[sl], self.subjects[sl], self.objects[sl], self.facts[sl]


class DirectedNumericScan:
    """Score-key-ordered block view of a NumericIndex.

    key(v) = v for descending ranking, -v for ascending; block 0 always holds
    the best keys so the top-k threshold logic is direction-agnostic.
    """

    def __init__(self, ni: NumericIndex, descending: bool):
        self.ni = ni
        self.descending = descending

    @property
    def n_blocks(self) -> int:
        return self.ni.n_blocks

    @property
    def n_rows(self) -> int:
        return self.ni.n_rows

    def best_key(self, b: int) -> float:
        if self.descending:
            return float(self.ni.block_max[b])
        return float(-self.ni.block_min[self.ni.n_blocks - 1 - b])

    def get_block(self, b: int):
        bb = b if self.descending else self.ni.n_blocks - 1 - b
        v, s, o, f = self.ni.get_block(bb)
        if not self.descending:
            v, s, o, f = v[::-1], s[::-1], o[::-1], f[::-1]
        return v, s, o, f

    def blocks_needed(self, key_threshold: float) -> int:
        """How many leading blocks can still contain keys > threshold --
        the paper's estimate `x` of blocks fetched before early termination."""
        if not np.isfinite(key_threshold):
            return self.n_blocks
        count = 0
        for b in range(self.n_blocks):
            if self.best_key(b) > key_threshold:
                count += 1
            else:
                break
        return count


def _sorted_lut(d: dict) -> tuple[np.ndarray, np.ndarray]:
    """dict -> (sorted int64 keys, aligned int64 values) for vector lookup."""
    if not d:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    keys = np.fromiter(d.keys(), np.int64, len(d))
    vals = np.fromiter(d.values(), np.int64, len(d))
    order = np.argsort(keys)
    return keys[order], vals[order]


def lut_get(keys: np.ndarray, vals: np.ndarray, col: np.ndarray,
            default: int = 0) -> np.ndarray:
    """Vectorized ``{k: v}.get(x, default)`` over a sorted-key LUT."""
    col = np.asarray(col, dtype=np.int64)
    out = np.full(len(col), default, dtype=np.int64)
    if len(keys):
        pos = np.clip(np.searchsorted(keys, col), 0, len(keys) - 1)
        hit = keys[pos] == col
        out[hit] = vals[pos[hit]]
    return out


def _segmented_unique_csr(seg: np.ndarray, vals: np.ndarray, n_seg: int
                          ) -> tuple[np.ndarray, np.ndarray]:
    """Per-segment sorted-unique values -> CSR ``(offsets, values)``.

    Matches ``[np.unique(vals[seg == i]) for i in range(n_seg)]`` exactly
    (sorted unique per segment, concatenated) without the python loop.
    """
    if len(seg) == 0:
        return np.zeros(n_seg + 1, dtype=np.int64), np.empty(0, np.int64)
    order = np.lexsort((vals, seg))
    s_s, v_s = seg[order], vals[order]
    keep = np.empty(len(s_s), dtype=bool)
    keep[0] = True
    keep[1:] = (s_s[1:] != s_s[:-1]) | (v_s[1:] != v_s[:-1])
    s_u, v_u = s_s[keep], v_s[keep]
    off = np.zeros(n_seg + 1, dtype=np.int64)
    np.add.at(off, s_u + 1, 1)
    return np.cumsum(off), v_u


def _entity_cs_csr(quads: np.ndarray, ent: np.ndarray,
                   cs_keys: np.ndarray, cs_vals: np.ndarray
                   ) -> tuple[tuple[np.ndarray, np.ndarray],
                              tuple[np.ndarray, np.ndarray]]:
    """Per-entity incoming/outgoing characteristic-set CSRs.

    incoming(e) = unique CS of subjects s with a quad (s, p, e);
    outgoing(e) = unique CS of objects o of quads (e, p, o). One sort per
    direction + a segmented unique — the vectorized twin of the original
    per-entity loop (identical CSRs), shared by `build_store` and the
    shard builder (`core/shard.py`), where `ent` holds spatial ids against
    the remapped quads (the remap is bijective, so the sets agree with
    build time).
    """
    ent = np.asarray(ent, dtype=np.int64)

    def one(col_sort: int, col_take: int):
        order = np.argsort(quads[:, col_sort], kind="stable")
        sorted_col = quads[order, col_sort]
        lo = np.searchsorted(sorted_col, ent, "left")
        hi = np.searchsorted(sorted_col, ent, "right")
        cnt = hi - lo
        rows = order[csr_gather(lo, cnt)]
        seg = np.repeat(np.arange(len(ent), dtype=np.int64), cnt)
        cs = lut_get(cs_keys, cs_vals, quads[rows, col_take])
        return _segmented_unique_csr(seg, cs, len(ent))

    return one(O, S), one(S, O)


def _build_numeric_index(values, subjects, objects, facts, block: int
                         ) -> NumericIndex:
    order = np.argsort(-values, kind="stable")
    v, s, o, f = values[order], subjects[order], objects[order], facts[order]
    nb = (len(v) + block - 1) // block
    bmax = np.array([v[i * block] for i in range(nb)]) if nb else np.empty(0)
    bmin = np.array([v[min((i + 1) * block, len(v)) - 1] for i in range(nb)]) \
        if nb else np.empty(0)
    return NumericIndex(v, s, o, f, block, bmax, bmin)


@dataclasses.dataclass
class GeomPool:
    """CSR pool of exact point-set geometries (paper §3.2.4 refinement).

    One flat ``(P, 2)`` float32 point array plus ``(E+1,)`` offsets: pool row
    ``r`` owns ``points[offsets[r] : offsets[r+1]]``. Rows ``0..n_entities-1``
    follow ``tree.obj_ids`` order (exact geometry when ingested, denormalized
    MBR corners otherwise) and the final row is a single-point ``(0, 0)``
    sentinel for unknown entities — every row holds >= 1 point, so dense
    gathers can pad by replicating a real point instead of masking.
    """

    points: np.ndarray    # (P, 2) float32
    offsets: np.ndarray   # (E+1,) int64, offsets[0] == 0
    # cached contiguous coordinate planes (see planes2d / planes3d)
    _p2d: tuple | None = dataclasses.field(default=None, init=False,
                                           repr=False, compare=False)
    _p3d: tuple | None = dataclasses.field(default=None, init=False,
                                           repr=False, compare=False)

    @classmethod
    def empty(cls) -> "GeomPool":
        return cls.from_lists([])

    @classmethod
    def from_lists(cls, geoms: list) -> "GeomPool":
        """Pack per-entity (m, 2) point arrays into CSR (one pool row per
        entry, in order) and append the sentinel row — the one authoritative
        encoder of the pool layout."""
        pts = [np.asarray(g, dtype=np.float32).reshape(-1, 2) for g in geoms]
        pts.append(np.zeros((1, 2), dtype=np.float32))      # sentinel
        offsets = np.zeros(len(pts) + 1, dtype=np.int64)
        offsets[1:] = np.cumsum([len(p) for p in pts])
        return cls(np.concatenate(pts, axis=0), offsets)

    @property
    def n_entities(self) -> int:
        """Pool rows backed by real entities (the sentinel row excluded)."""
        return len(self.offsets) - 2

    @property
    def sentinel_row(self) -> int:
        return self.n_entities

    def counts(self, rows: np.ndarray) -> np.ndarray:
        rows = np.asarray(rows, dtype=np.int64)
        return self.offsets[rows + 1] - self.offsets[rows]

    def planes2d(self) -> tuple:
        """Contiguous (P,) float32 x / y planes for euclidean refinement."""
        if self._p2d is None:
            self._p2d = (np.ascontiguousarray(self.points[:, 0]),
                         np.ascontiguousarray(self.points[:, 1]))
        return self._p2d

    def planes3d(self) -> tuple:
        """Contiguous (P,) float32 unit-sphere X / Y / Z planes.

        Points are (lon, lat) degrees; the chord length between unit vectors
        relates to the haversine term by ``chord² = 4h``, so great-circle
        refinement reduces to a squared euclidean distance in R³ — the
        per-point trig happens once here instead of once per candidate pair
        inside the kernel (computed in f64, stored f32).
        """
        if self._p3d is None:
            lon = np.radians(self.points[:, 0].astype(np.float64))
            lat = np.radians(self.points[:, 1].astype(np.float64))
            cl = np.cos(lat)
            self._p3d = ((cl * np.cos(lon)).astype(np.float32),
                         (cl * np.sin(lon)).astype(np.float32),
                         np.sin(lat).astype(np.float32))
        return self._p3d

    def nbytes(self) -> int:
        return self.points.nbytes + self.offsets.nbytes


def _build_geom_pool(tree: SQuadTree | None, exact_geoms: dict) -> GeomPool:
    """Per-entity geometries in tree.obj_ids order, MBR-corner fallback."""
    if tree is None:
        return GeomPool.from_lists([])
    ext = tree.extent
    if not exact_geoms:
        # all-MBR fast path (the synthetic scaling datasets): two corner
        # points per entity, built dense — bit-identical to the loop (f64
        # denormalize, then the f32 cast `from_lists` would apply)
        m = len(tree.obj_ids)
        b = tree.obj_mbr
        pts = np.empty((2 * m + 1, 2), dtype=np.float32)
        pts[0:2 * m:2, 0] = b[:, 0] * ext.width + ext.xmin
        pts[0:2 * m:2, 1] = b[:, 1] * ext.height + ext.ymin
        pts[1:2 * m:2, 0] = b[:, 2] * ext.width + ext.xmin
        pts[1:2 * m:2, 1] = b[:, 3] * ext.height + ext.ymin
        pts[2 * m] = 0.0                                    # sentinel
        offsets = np.empty(m + 2, dtype=np.int64)
        offsets[:m + 1] = np.arange(m + 1, dtype=np.int64) * 2
        offsets[m + 1] = 2 * m + 1
        return GeomPool(pts, offsets)
    pts_list = []
    for pos in range(len(tree.obj_ids)):
        e = int(tree.obj_ids[pos])
        g = exact_geoms.get(e)
        if g is None:
            bx = tree.obj_mbr[pos]
            g = np.array([
                [bx[0] * ext.width + ext.xmin, bx[1] * ext.height + ext.ymin],
                [bx[2] * ext.width + ext.xmin, bx[3] * ext.height + ext.ymin],
            ])
        pts_list.append(g)
    return GeomPool.from_lists(pts_list)


@dataclasses.dataclass
class QuadStore:
    quads: np.ndarray                   # (n, 4) int64 as (g, s, p, o)
    dictionary: Dictionary
    indexes: dict                       # order name -> sorted (n, 4) int64
    numeric: dict                       # predicate id -> NumericIndex
    tree: SQuadTree | None
    cs_of_entity: dict                  # entity id -> CS id
    cs_catalog: dict                    # cs id -> frozenset(predicate ids)
    geometry_predicate: int = 0
    exact_geoms: dict = dataclasses.field(default_factory=dict)
    geom_pool: GeomPool = dataclasses.field(default_factory=GeomPool.empty)
    block: int = DEFAULT_BLOCK
    # dense numeric-literal LUT for vectorized score lookups
    _num_ids: np.ndarray = dataclasses.field(
        default_factory=lambda: np.empty(0, dtype=np.int64))
    _num_vals: np.ndarray = dataclasses.field(
        default_factory=lambda: np.empty(0, dtype=np.float64))

    def values_of(self, ids_arr: np.ndarray) -> np.ndarray:
        """Vectorized literal-id -> float lookup (NaN for non-numeric)."""
        ids_arr = np.asarray(ids_arr, dtype=np.int64)
        out = np.full(len(ids_arr), np.nan)
        if len(self._num_ids) == 0:
            return out
        pos = np.searchsorted(self._num_ids, ids_arr)
        pos = np.clip(pos, 0, len(self._num_ids) - 1)
        hit = self._num_ids[pos] == ids_arr
        out[hit] = self._num_vals[pos[hit]]
        return out

    def geom_rows(self, entity_ids: np.ndarray) -> np.ndarray:
        """Entity ids -> geometry-pool rows (sentinel row when unknown)."""
        ids = np.asarray(entity_ids, dtype=np.int64)
        out = np.full(len(ids), self.geom_pool.sentinel_row, dtype=np.int64)
        t = self.tree
        if t is not None and len(t.obj_ids):
            pos = np.searchsorted(t.obj_ids, ids)
            pos = np.clip(pos, 0, len(t.obj_ids) - 1)
            hit = t.obj_ids[pos] == ids
            out[hit] = pos[hit]
        return out

    # ------------------------------------------------------------------
    @property
    def n_quads(self) -> int:
        return len(self.quads)

    def nbytes(self) -> int:
        total = self.quads.nbytes
        for idx in self.indexes.values():
            total += idx.nbytes
        for ni in self.numeric.values():
            total += ni.values.nbytes + ni.subjects.nbytes + ni.facts.nbytes
            total += ni.block_max.nbytes + ni.block_min.nbytes
        if self.tree is not None:
            total += self.tree.nbytes()
        total += self.geom_pool.nbytes()
        return total

    # ------------------------------------------------------------------
    def scan(self, g=None, s=None, p=None, o=None,
             return_order: bool = False):
        """Range scan: returns matching rows as an (m, 4) (g,s,p,o) array.

        With ``return_order=True`` also returns the tuple of column indices
        the result rows are lexicographically sorted by — the chosen
        permutation index's columns past the bound prefix (the prefix
        columns are constant over the result, so they carry no order).
        Residual equality filters preserve row order, so the guarantee
        survives them.
        """
        bound = {G: g, S: s, P: p, O: o}
        consts = [c for c, v in bound.items() if v is not None]
        best_name, best_prefix = "spog", 0
        for name, cols in ORDERS.items():
            k = 0
            while k < 4 and cols[k] in consts:
                k += 1
            if k > best_prefix:
                best_name, best_prefix = name, k
        idx = self.indexes[best_name]
        cols = ORDERS[best_name]
        lo, hi = 0, len(idx)
        for d in range(best_prefix):
            c = cols[d]
            v = bound[c]
            col = idx[lo:hi, c]
            lo, hi = lo + np.searchsorted(col, v, "left"), \
                lo + np.searchsorted(col, v, "right")
        rows = idx[lo:hi]
        # residual filters for bound columns not covered by the sort prefix
        prefix_cols = set(cols[:best_prefix])
        for c in consts:
            if c not in prefix_cols:
                rows = rows[rows[:, c] == bound[c]]
        if return_order:
            return rows, cols[best_prefix:]
        return rows

    def spatial_box_of(self, entity_ids: np.ndarray) -> np.ndarray:
        """Normalized MBRs for spatial entity ids (NaN rows when unknown)."""
        t = self.tree
        out = np.full((len(entity_ids), 4), np.nan)
        pos = np.searchsorted(t.obj_ids, entity_ids)
        pos = np.clip(pos, 0, len(t.obj_ids) - 1)
        hit = t.obj_ids[pos] == entity_ids
        out[hit] = t.obj_mbr[pos[hit]]
        return out


def build_store(quads: np.ndarray,
                dictionary: Dictionary,
                geometry_predicate: int,
                geometries: dict,
                exact_geoms: dict | None = None,
                block: int = DEFAULT_BLOCK,
                l_max: int = 10,
                leaf_capacity: int = 64,
                extent: geometry.Extent | None = None) -> QuadStore:
    """Assemble the full store.

    quads: (n, 4) int64 (g, s, p, o) with PRE-spatial (plain) entity ids.
    geometries: plain entity id -> (xmin, ymin, xmax, ymax) world box for
        every subject that has a `geometry_predicate` fact.
    exact_geoms: plain entity id -> (m, 2) exact point-set geometry.
    """
    quads = np.asarray(quads, dtype=np.int64)

    # --- characteristic sets over all subjects --------------------------
    subj, pred = quads[:, S], quads[:, P]
    uniq_s, cs_ids = charsets.compute_characteristic_sets(subj, pred)
    cs_of = dict(zip(uniq_s.tolist(), cs_ids.tolist()))
    catalog = charsets.cs_catalog(subj, pred)

    # --- S-QuadTree over spatial entities -------------------------------
    tree = None
    mapping: dict = {}
    if geometries:
        ent = np.array(sorted(geometries.keys()), dtype=np.int64)
        boxes = np.array([geometries[int(e)] for e in ent], dtype=np.float64)
        # the geometry pool stores points as f32; the MBR must bound the
        # STORED geometry, not the caller's f64 coordinates, or a query at
        # exactly the quantized point (e.g. within-distance, dist = 0) gets
        # MBR-pruned while exact refinement would keep it. Expand each box
        # to cover the f32 round-trip of its exact points.
        if exact_geoms:
            for i, e in enumerate(ent):
                pts = exact_geoms.get(int(e))
                if pts is None or len(pts) == 0:
                    continue
                q = np.asarray(pts, dtype=np.float32).astype(np.float64)
                boxes[i, 0] = min(boxes[i, 0], q[:, 0].min())
                boxes[i, 1] = min(boxes[i, 1], q[:, 1].min())
                boxes[i, 2] = max(boxes[i, 2], q[:, 0].max())
                boxes[i, 3] = max(boxes[i, 3], q[:, 1].max())
        cs_keys, cs_vals = _sorted_lut(cs_of)
        cs_self = lut_get(cs_keys, cs_vals, ent)
        # incoming CS: subjects s with (s, p, e); outgoing CS: objects o of
        # (e, p, o) — one sort per direction + segmented unique (identical
        # to the original per-entity loop, scale-viable at 10M+ triples)
        cs_in, cs_out = _entity_cs_csr(quads, ent, cs_keys, cs_vals)
        tree = build_tree(ent, boxes, cs_self,
                          cs_in=cs_in, cs_out=cs_out,
                          l_max=l_max, leaf_capacity=leaf_capacity,
                          extent=extent)
        mapping = dict(tree.entity_to_id)

    # --- remap plain ids -> spatial ids everywhere ----------------------
    if mapping:
        lut_keys = np.array(list(mapping.keys()), dtype=np.int64)
        lut_vals = np.array(list(mapping.values()), dtype=np.int64)
        order = np.argsort(lut_keys)
        lut_keys, lut_vals = lut_keys[order], lut_vals[order]

        def remap_col(col):
            pos = np.searchsorted(lut_keys, col)
            pos = np.clip(pos, 0, len(lut_keys) - 1)
            hit = lut_keys[pos] == col
            out = col.copy()
            out[hit] = lut_vals[pos[hit]]
            return out

        quads = quads.copy()
        for c in (G, S, P, O):
            quads[:, c] = remap_col(quads[:, c])
        dictionary.remap(mapping)
        cs_of = {mapping.get(k, k): v for k, v in cs_of.items()}

    # --- permutation indexes --------------------------------------------
    indexes = {}
    for name, cols in ORDERS.items():
        keys = tuple(quads[:, c] for c in reversed(cols))
        indexes[name] = quads[np.lexsort(keys)]

    # --- per-predicate numeric indexes -----------------------------------
    numeric: dict = {}
    numeric_ids = dictionary.numeric_value
    num_ids_sorted = np.empty(0, dtype=np.int64)
    num_vals_sorted = np.empty(0, dtype=np.float64)
    if numeric_ids:
        num_ids_sorted = np.fromiter(numeric_ids.keys(), np.int64)
        order_n = np.argsort(num_ids_sorted)
        num_ids_sorted = num_ids_sorted[order_n]
        num_vals_sorted = np.fromiter(numeric_ids.values(), np.float64)[order_n]
        is_num = np.isin(quads[:, O], num_ids_sorted)
        nq = quads[is_num]
        # value lookup through the dense LUT (same floats as the dict)
        nv = num_vals_sorted[np.searchsorted(num_ids_sorted, nq[:, O])]
        for p_id in np.unique(nq[:, P]):
            sel = nq[:, P] == p_id
            rows = nq[sel]
            numeric[int(p_id)] = _build_numeric_index(
                nv[sel], rows[:, S].copy(), rows[:, O].copy(),
                rows[:, G].copy(), block)

    # remap exact geometries to spatial ids, pack them into the CSR pool
    ex = {}
    for k, v in (exact_geoms or {}).items():
        ex[int(mapping.get(k, k))] = np.asarray(v, dtype=np.float64)
    pool = _build_geom_pool(tree, ex)

    return QuadStore(quads=quads, dictionary=dictionary, indexes=indexes,
                     numeric=numeric, tree=tree, cs_of_entity=cs_of,
                     cs_catalog=catalog,
                     geometry_predicate=int(geometry_predicate),
                     exact_geoms=ex, geom_pool=pool, block=block,
                     _num_ids=num_ids_sorted, _num_vals=num_vals_sorted)
