"""S-QuadTree: the soft-schema-aware spatial index (paper §3.1).

Construction is host-side numpy (the paper builds the index in a
pre-processing stage; "zero index creation overhead during query
processing"). The result is a struct-of-arrays tree consumed by the query
path:

- objects are assigned ``(S, Z, I, L)`` ids at the deepest fully-enclosing
  cell (level <= L_MAX) and sorted by id, so *any* subtree's objects are one
  contiguous slice — I-Range lookups are two binary searches;
- every materialized node stores I-Range, E-list, MBR, Bloom filters over
  self/incoming/outgoing characteristic sets, and per-CS cardinalities.

Phase-1 candidate-node search (`candidate_nodes`) also lives here.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import tracing
from ..kernels import ops
from . import geometry, ids, morton
from .charsets import BloomBank, NodeCSStats, PreparedKeys, build_node_cs_stats
from .geometry import Extent


# Phase-1 traversal backend: "numpy" is the host level-synchronous frontier
# (`_frontier`); "kernel" the fused descent (`ops.tree_descend`): the CUDA
# kernel on a CUDA device, its plain torch version on the CPU. "auto"
# resolves to the kernel when CUDA is available, numpy otherwise.
DESCEND_BACKENDS = ("auto", "numpy", "kernel")


def resolve_descend_backend(backend: str | None) -> str:
    b = backend or "auto"
    if b not in DESCEND_BACKENDS:
        raise ValueError(f"unknown tree-descend backend {b!r}")
    if b != "auto":
        return b
    return "kernel" if torch.cuda.is_available() else "numpy"


def csr_gather(starts: np.ndarray, cnt: np.ndarray) -> np.ndarray:
    """Flat indices of the slices [starts_i, starts_i + cnt_i), concatenated.

    The cumsum/repeat per-slice iota: equivalent to
    ``np.concatenate([np.arange(s, s + c) for s, c in zip(starts, cnt)])``
    without the python loop.
    """
    total = int(cnt.sum())
    base = np.repeat(starts - np.concatenate([[0], np.cumsum(cnt)[:-1]]), cnt)
    return base + np.arange(total)


def _bit_length(x: np.ndarray) -> np.ndarray:
    """Vectorized bit_length for non-negative int64 (branchless clz)."""
    g = x.astype(np.uint64)
    out = np.zeros(len(g), dtype=np.int64)
    for s in (32, 16, 8, 4, 2, 1):
        m = (g >> np.uint64(s)) != 0
        out[m] += s
        g[m] >>= np.uint64(s)
    return out + (g != 0)


@dataclasses.dataclass
class PackedEList:
    """Compressed E-list tier: k²-triples-style bit-packed adjacency.

    Each nonempty node's sorted id list is stored as a 64-bit base plus
    gap-encoded deltas, bit-packed at the node's own width (the bit length
    of its largest gap) into one shared uint64 word stream. When the
    tree's sorted `obj_ids` array is supplied at encode time, lists are
    first mapped to their RANKS in that array and the ranks are what gets
    gap-packed (`src` set): every E-list id is an object of the same tree,
    so the rank view is lossless, and rank gaps are positional distances
    bounded by ``bit_length(n_objects)`` bits — leaf lists that mix id
    levels (50+-bit raw-id gaps) shrink to a few bits per entry. Decoding
    is a vectorized word/shift extraction plus a segmented cumsum, then a
    gather through `src` in rank mode, done per node on the gather path
    (`SQuadTree.elist` / `filter_material`); `elist_size` stays on the raw
    CSR offsets so size-only consumers never touch this tier.
    """
    nodes: np.ndarray     # (K,) int32 sorted node indices w/ nonempty lists
    counts: np.ndarray    # (K,) int32 list length per node
    base: np.ndarray      # (K,) int64 first id (or rank, if `src`) per list
    width: np.ndarray     # (K,) uint8 bits per packed gap (1..63)
    bit_off: np.ndarray   # (K,) int64 start bit of each node's gap stream
    words: np.ndarray     # (W,) uint64 packed gaps (+ stitch padding)
    src: np.ndarray | None = None  # shared sorted obj_ids (not owned):
    #                                when set, packed values are ranks into it

    @classmethod
    def encode(cls, offsets: np.ndarray, ids_flat: np.ndarray,
               obj_ids: np.ndarray | None = None) -> "PackedEList":
        counts_all = np.diff(offsets)
        nodes = np.flatnonzero(counts_all).astype(np.int32)
        counts = counts_all[nodes.astype(np.int64)].astype(np.int32)
        k = len(nodes)
        if k == 0:
            return cls(nodes, counts, np.empty(0, np.int64),
                       np.empty(0, np.uint8), np.empty(0, np.int64),
                       np.zeros(1, np.uint64))
        starts = offsets[nodes]
        src = None
        vals = ids_flat
        if obj_ids is not None and len(obj_ids):
            r = np.searchsorted(obj_ids, ids_flat)
            r[r >= len(obj_ids)] = 0
            if np.array_equal(obj_ids[r], ids_flat):
                src, vals = obj_ids, r.astype(np.int64)
        base = vals[starts].astype(np.int64)
        # gaps between consecutive values; each list's first slot is floored
        # to 1 so it can share the per-node max without dominating it (real
        # gaps are >= 1: lists are sorted unique, ranks strictly increase)
        d = np.empty(len(vals), dtype=np.int64)
        d[0] = 1
        d[1:] = vals[1:] - vals[:-1]
        d[starts] = 1
        width = _bit_length(np.maximum.reduceat(d, starts))
        # spatial ids all carry the S bit, so gaps fit well under 2^62
        assert int(width.max()) <= 63, "E-list gap exceeds 63 bits"
        n_gaps = counts - 1
        bits = width * n_gaps
        bit_off = np.concatenate([[0], np.cumsum(bits)[:-1]]).astype(np.int64)
        words = np.zeros(int(bits.sum()) // 64 + 2, dtype=np.uint64)
        total_g = int(n_gaps.sum())
        if total_g:
            seg = np.repeat(np.arange(k), n_gaps)
            pos = csr_gather(starts + 1, n_gaps)
            local = pos - starts[seg] - 1
            p = bit_off[seg] + local * width[seg]
            w = p >> 6
            sh = (p & 63).astype(np.uint64)
            val = d[pos].astype(np.uint64)
            np.bitwise_or.at(words, w, val << sh)
            rs = (np.uint64(64) - sh) & np.uint64(63)
            hi = np.where(sh != 0, val >> rs, np.uint64(0))
            np.bitwise_or.at(words, w + 1, hi)
        return cls(nodes, counts, base, width.astype(np.uint8),
                   bit_off, words, src=src)

    def decode(self, ranks: np.ndarray) -> np.ndarray:
        """Concatenated decoded id lists for node *ranks* (indices into
        `nodes`), each list in its original sorted order."""
        ranks = np.asarray(ranks, dtype=np.int64)
        cnt = self.counts[ranks].astype(np.int64)
        total = int(cnt.sum())
        out = np.empty(total, dtype=np.int64)
        if total == 0:
            return out
        first = np.concatenate([[0], np.cumsum(cnt)[:-1]]).astype(np.int64)
        out[first] = self.base[ranks]
        n_g = cnt - 1
        total_g = int(n_g.sum())
        if total_g:
            seg = np.repeat(np.arange(len(ranks)), n_g)
            local = (np.arange(total_g)
                     - np.repeat(np.cumsum(n_g) - n_g, n_g))
            r = ranks[seg]
            wdt = self.width[r].astype(np.int64)
            p = self.bit_off[r] + local * wdt
            w = p >> 6
            sh = (p & 63).astype(np.uint64)
            rs = (np.uint64(64) - sh) & np.uint64(63)
            v = (self.words[w] >> sh) | np.where(
                sh != 0, self.words[w + 1] << rs, np.uint64(0))
            mask = (np.uint64(1) << wdt.astype(np.uint64)) - np.uint64(1)
            out[np.repeat(first, n_g) + 1 + local] = (v & mask).astype(
                np.int64)
        cs = np.cumsum(out)
        out = cs - np.repeat(cs[first] - out[first], cnt)
        return self.src[out] if self.src is not None else out

    def ranks_of(self, node_idx: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
        """(ranks, positions) for the input node indices with nonempty
        lists: ``ranks[t]`` indexes `nodes`/`counts` and ``positions[t]``
        is the index into `node_idx` it came from, so callers that align
        decoded lists against their input order can re-associate them.
        Nodes with empty E-lists yield no entry (they have no rank) —
        their absence is visible as a gap in ``positions``.
        """
        node_idx = np.asarray(node_idx, dtype=np.int64)
        if not len(self.nodes):
            return (np.empty(0, dtype=np.int64),
                    np.empty(0, dtype=np.int64))
        r = np.searchsorted(self.nodes, node_idx)
        r_c = np.minimum(r, len(self.nodes) - 1)
        hit = (self.nodes[r_c] == node_idx) & (r < len(self.nodes))
        return r_c[hit], np.flatnonzero(hit)

    def nbytes(self) -> int:
        # `src` is the tree's own obj_ids array, shared not owned — it is
        # already accounted for in `SQuadTree.nbytes`.
        return (self.nodes.nbytes + self.counts.nbytes + self.base.nbytes
                + self.width.nbytes + self.bit_off.nbytes
                + self.words.nbytes)


def _pad_box_sets(box_sets) -> np.ndarray:
    """Stack ragged per-block box sets into (B, M_max, 4) with NaN padding.

    NaN rows fail every interval comparison in `geometry.boxes_intersect`,
    so padded slots can never contribute a hit — the batched frontier sees
    exactly the real boxes of each block.
    """
    if isinstance(box_sets, np.ndarray):
        return box_sets
    m_max = max((len(b) for b in box_sets), default=0)
    out = np.full((len(box_sets), max(m_max, 1), 4), np.nan)
    for i, b in enumerate(box_sets):
        if len(b):
            out[i, :len(b)] = b
    return out


@dataclasses.dataclass
class SQuadTree:
    extent: Extent
    l_max: int
    # --- node SoA (index 0 is the root; parents precede children) ---
    node_z: np.ndarray          # (N,) int64 z-path at the node's own level
    node_level: np.ndarray      # (N,) int32
    node_parent: np.ndarray     # (N,) int32 (-1 for root)
    node_children: np.ndarray   # (N, 4) int32 (-1 = absent)
    node_cell: np.ndarray       # (N, 4) float64 normalized cell box
    node_mbr: np.ndarray        # (N, 4) float64 union of clipped object MBRs
    irange: np.ndarray          # (N, 2) int64 closed subtree id interval
    n_subtree: np.ndarray       # (N,) int64 objects in subtree (incl. own)
    elist_offsets: np.ndarray   # (N + 1,) int64 CSR offsets into elist_ids
    elist_ids: np.ndarray       # (nnz,) int64 sorted within each node
    bloom_self: BloomBank
    bloom_in: BloomBank
    bloom_out: BloomBank
    cs_stats: NodeCSStats       # self-CS cardinalities per node
    # --- object SoA, sorted by id ---
    obj_ids: np.ndarray         # (M,) int64
    obj_mbr: np.ndarray         # (M, 4) float64 normalized
    obj_entity: np.ndarray      # (M,) int64 original entity key
    entity_to_id: dict          # entity key -> spatial id
    # --- optional compressed E-list tier (replaces elist_ids when set) ---
    packed: PackedEList | None = None
    # --- derived level buckets (computed in __post_init__) ---
    # Nodes are laid out parents-before-children but levels interleave (DFS
    # build order); the CSR below buckets node indices by level so the
    # level-synchronous frontier and the node-selection DP sweep touch each
    # level's nodes with one contiguous gather instead of an O(N) rescan.
    level_order: np.ndarray = dataclasses.field(init=False)    # (N,) int64
    level_offsets: np.ndarray = dataclasses.field(init=False)  # (L + 2,)

    def __post_init__(self):
        levels = self.node_level.astype(np.int64)
        n_levels = int(levels.max()) + 1 if len(levels) else 0
        counts = np.bincount(levels, minlength=n_levels)
        self.level_order = np.argsort(levels, kind="stable").astype(np.int64)
        self.level_offsets = np.concatenate(
            [[0], np.cumsum(counts)]).astype(np.int64)

    # ------------------------------------------------------------------
    @property
    def n_nodes(self) -> int:
        return len(self.node_z)

    @property
    def n_levels(self) -> int:
        return len(self.level_offsets) - 1

    def level_nodes(self, lvl: int) -> np.ndarray:
        """Node indices at `lvl`, in parents-before-children build order."""
        return self.level_order[self.level_offsets[lvl]:
                                self.level_offsets[lvl + 1]]

    @property
    def n_objects(self) -> int:
        return len(self.obj_ids)

    def elist(self, node: int) -> np.ndarray:
        if self.packed is not None:
            ranks, _ = self.packed.ranks_of(np.array([node], dtype=np.int64))
            return (self.packed.decode(ranks) if len(ranks)
                    else np.empty(0, dtype=np.int64))
        a, b = self.elist_offsets[node], self.elist_offsets[node + 1]
        return self.elist_ids[a:b]

    def pack_elists(self) -> "SQuadTree":
        """Switch to the compressed `PackedEList` tier in place (and drop
        the raw id array). Accessors decode per node on the gather path;
        `elist_size` stays on the CSR offsets either way."""
        if self.packed is None and len(self.elist_ids):
            self.packed = PackedEList.encode(self.elist_offsets,
                                             self.elist_ids, self.obj_ids)
            self.elist_ids = np.empty(0, dtype=np.int64)
        return self

    def elist_size(self, node) -> np.ndarray:
        node = np.asarray(node)
        return self.elist_offsets[node + 1] - self.elist_offsets[node]

    def subtree_slice(self, node: int) -> slice:
        lo, hi = self.irange[node]
        a = int(np.searchsorted(self.obj_ids, lo, side="left"))
        b = int(np.searchsorted(self.obj_ids, hi, side="right"))
        return slice(a, b)

    def nbytes(self) -> int:
        total = 0
        for arr in (self.node_z, self.node_level, self.node_parent,
                    self.node_children, self.node_cell, self.node_mbr,
                    self.irange, self.n_subtree, self.elist_offsets,
                    self.elist_ids, self.obj_ids, self.obj_mbr,
                    self.obj_entity):
            total += arr.nbytes
        total += self.bloom_self.nbytes() + self.bloom_in.nbytes()
        total += self.bloom_out.nbytes() + self.cs_stats.nbytes()
        if self.packed is not None:
            total += self.packed.nbytes()
        return total

    # ------------------------------------------------------------------
    # Phase 1: candidate-node search (paper §3.2.1)
    # ------------------------------------------------------------------
    @tracing.spanned("sip.descend")
    def candidate_nodes(self, driver_boxes, dist_norm: float,
                        driven_cs: np.ndarray, which: str = "self",
                        prepared: PreparedKeys | None = None,
                        probe_backend: str | None = None,
                        descend_backend: str | None = None,
                        cs_path: np.ndarray | None = None,
                        device: torch.device | str | None = None
                        ) -> np.ndarray:
        """Boolean candidate mask(s): the connected set V per driver block.

        A node survives iff (a) its Bloom filter reports some driven-CS object
        intersecting it, and (b) its MBR expanded by the query distance
        intersects at least one driver-object MBR. `driver_boxes` may be one
        block ``(M, 4)`` -> ``(N,)`` mask, or a batch ``(B, M, 4)`` (or a
        ragged list of ``(M_i, 4)`` arrays) -> ``(B, N)`` masks computed in
        one pass.

        `prepared` hoists the driven-CS key hashing out of the call (see
        `BloomBank.prepare`). `descend_backend` selects the traversal route
        (`DESCEND_BACKENDS`): "numpy" runs the host frontier, "kernel" the
        fused descent on `device`, whose per-query root-path Bloom mask may
        be precomputed once via `cs_path_mask` and passed as `cs_path`. Both
        routes give the same masks; the kernel routes of the descent and of
        the Bloom probes (`probe_backend`) run on `device`.

        Multi-query form (the serving layer): `driven_cs` may be a LIST of
        per-block CS arrays (one per batch row, from different queries), with
        `prepared` and `cs_path` aligned lists (or None) and `dist_norm` a
        scalar or a per-block ``(B,)`` array. Blocks whose CS arrays are
        equal share one pass (one descent launch on the kernel route, whose
        row count is the group's); per-block results equal separate calls.
        Rows sharing a CS group must carry the same `cs_path` mask; a
        missing one is derived here, one Bloom probe a group.
        """
        bank = {"self": self.bloom_self, "in": self.bloom_in,
                "out": self.bloom_out}[which]
        dback = resolve_descend_backend(descend_backend)
        if isinstance(driven_cs, (list, tuple)):
            boxes = _pad_box_sets(driver_boxes)
            n_b = len(boxes)
            if len(driven_cs) != n_b:
                raise ValueError("driven_cs list must match the block batch")
            dist_arr = np.broadcast_to(
                np.asarray(dist_norm, dtype=np.float64), (n_b,))
            prep = (list(prepared) if prepared is not None else [None] * n_b)
            paths = (list(cs_path) if isinstance(cs_path, (list, tuple))
                     else [None] * n_b)
            if len(prep) != n_b or len(paths) != n_b:
                raise ValueError("prepared/cs_path lists must match the batch")
            cs_arrs = [np.asarray(c, dtype=np.int64) for c in driven_cs]
            out = np.zeros((n_b, self.n_nodes), dtype=bool)
            groups: dict[bytes, list[int]] = {}
            for i, c in enumerate(cs_arrs):
                groups.setdefault(c.tobytes(), []).append(i)
            for sel in groups.values():
                si = np.asarray(sel, dtype=np.int64)
                out[si] = self._route(boxes[si], dist_arr[si],
                                      cs_arrs[sel[0]], bank, which,
                                      prep[sel[0]], probe_backend, dback,
                                      paths[sel[0]], device)
            return out
        single = isinstance(driver_boxes, np.ndarray) and driver_boxes.ndim == 2
        boxes = driver_boxes[None] if single else _pad_box_sets(driver_boxes)
        in_v = self._route(boxes, dist_norm,
                           np.asarray(driven_cs, dtype=np.int64), bank,
                           which, prepared, probe_backend, dback, cs_path,
                           device)
        return in_v[0] if single else in_v

    def _route(self, boxes: np.ndarray, dist_norm, driven_cs: np.ndarray,
               bank: BloomBank, which: str, prepared, probe_backend,
               descend_backend: str, cs_path,
               device: torch.device | str | None) -> np.ndarray:
        """One shared-CS group -> host frontier or fused descent."""
        if descend_backend == "numpy":
            return self._frontier(boxes, dist_norm, driven_cs, bank,
                                  prepared, probe_backend, device)
        if not (len(boxes) and len(driven_cs) and boxes.shape[1]):
            return np.zeros((len(boxes), self.n_nodes), dtype=bool)
        if cs_path is None:
            cs_path = self.cs_path_mask(driven_cs, which=which,
                                        prepared=prepared,
                                        probe_backend=probe_backend,
                                        device=device)
        return self._descend(boxes, dist_norm, cs_path, device)

    def _frontier(self, boxes: np.ndarray, dist_norm, driven_cs: np.ndarray,
                  bank: BloomBank, prepared: PreparedKeys | None,
                  probe_backend: str | None,
                  device: torch.device | str | None) -> np.ndarray:
        """The batched level-synchronous frontier over one shared CS set.

        boxes (B, M, 4) NaN-padded; dist_norm scalar or per-block (B,).
        A kernel `probe_backend` probes on `device`.
        """
        n_b = len(boxes)
        in_v = np.zeros((n_b, self.n_nodes), dtype=bool)
        if n_b and len(driven_cs) and boxes.shape[1]:
            if prepared is None or prepared.nbits != bank.nbits \
                    or prepared.k != bank.k \
                    or not np.array_equal(prepared.keys, driven_cs):
                prepared = bank.prepare(driven_cs)
            d = (dist_norm if np.ndim(dist_norm) == 0
                 else np.asarray(dist_norm, dtype=np.float64)[:, None])
            expanded = geometry.expand_boxes(boxes, d)          # (B, M, 4)
            # Flat (block, node, box) triple frontier — a simultaneous
            # descent of every block's expanded driver boxes down the tree.
            # Because child MBRs nest inside their parent's (clipped unions
            # over subsets of the parent's objects), a box that misses a
            # node's MBR can never hit a descendant's, so each (block, node)
            # box list shrinks geometrically instead of re-testing all M
            # boxes at every frontier node like the looped BFS does. Runs of
            # equal (block, node) stay contiguous by construction, so
            # per-node reductions are bincount over run ids.
            m = boxes.shape[1]
            tb = np.repeat(np.arange(n_b, dtype=np.int64), m)   # block
            tx = np.tile(np.arange(m, dtype=np.int64), n_b)     # box
            keep = np.isfinite(expanded[tb, tx, 0])  # drop ragged padding
            tb, tx = tb[keep], tx[keep]
            tn = np.zeros(len(tb), dtype=np.int64)              # node (root)
            while len(tb):
                # Bloom-probe each distinct frontier node once, shared by
                # every block whose frontier reached it
                uniq_nodes = np.unique(tn)
                cs_hit = bank.contains_any_batch(uniq_nodes, prepared,
                                                 probe_backend, device)
                node_cs = cs_hit[np.searchsorted(uniq_nodes, tn)]
                tboxes = expanded[tb, tx]                       # (T, 4)
                hit = node_cs & geometry.boxes_intersect(
                    self.node_mbr[tn], tboxes)
                change = np.empty(len(tb), dtype=bool)
                change[0] = True
                change[1:] = (tb[1:] != tb[:-1]) | (tn[1:] != tn[:-1])
                run_id = np.cumsum(change) - 1
                starts = np.flatnonzero(change)
                ok_run = np.bincount(run_id, weights=hit) > 0
                in_v[tb[starts], tn[starts]] = ok_run
                # descend: surviving (block, node) groups push their
                # MBR-hitting boxes into the children whose cell they touch
                cand = ok_run[run_id] & hit
                if not cand.any():
                    break
                cb, cn, cx = tb[cand], tn[cand], tx[cand]
                cbox = tboxes[cand]
                kids = self.node_children[cn]                   # (C, 4)
                parts = []
                for q in range(4):
                    kq = kids[:, q]
                    v = np.flatnonzero(kq >= 0)
                    if not len(v):
                        continue
                    cell_hit = geometry.boxes_intersect(
                        cbox[v], self.node_cell[kq[v]])
                    vi = v[cell_hit]
                    parts.append((cb[vi], kq[vi], cx[vi]))
                if not parts:
                    break
                tb = np.concatenate([p[0] for p in parts])
                tn = np.concatenate([p[1] for p in parts])
                tx = np.concatenate([p[2] for p in parts])
        return in_v

    def cs_path_mask(self, driven_cs: np.ndarray, which: str = "self",
                     prepared: PreparedKeys | None = None,
                     probe_backend: str | None = None,
                     device: torch.device | str | None = None) -> np.ndarray:
        """(N,) bool: the Bloom verdict ANDed down each node's root path.

        The fused descent's whole per-query Bloom contribution. Because
        child MBRs nest inside their parent's exactly (clipped min/max
        unions over subsets of the parent's rows), a driver box hitting a
        node's expanded MBR hits every ancestor's too — so the traversal's
        per-node verdict factorizes as ``geo_hit(n) & cs_path(n)``, with
        this mask the only part that depends on the query's CS set. One
        batch probe over all nodes plus a per-level parent AND (parents
        precede children in the level sweep). A kernel `probe_backend`
        probes on `device`.
        """
        bank = {"self": self.bloom_self, "in": self.bloom_in,
                "out": self.bloom_out}[which]
        driven_cs = np.asarray(driven_cs, dtype=np.int64)
        n = self.n_nodes
        if n == 0 or len(driven_cs) == 0:
            return np.zeros(n, dtype=bool)
        if prepared is None or prepared.nbits != bank.nbits \
                or prepared.k != bank.k \
                or not np.array_equal(prepared.keys, driven_cs):
            prepared = bank.prepare(driven_cs)
        path = bank.contains_any_batch(np.arange(n, dtype=np.int64),
                                       prepared, probe_backend, device)
        for lvl in range(1, self.n_levels):
            nodes = self.level_nodes(lvl)
            path[nodes] &= path[self.node_parent[nodes]]
        return path

    def _node_key_planes(self, device: torch.device) -> torch.Tensor:
        """Cached (4, N) int64 sort-key planes of the node MBRs (rows
        x0, y0, x2, y3) on `device` for the fused descent — the tree is
        immutable, so the f64 -> key encoding and the upload happen once
        per tree and device."""
        cache = self.__dict__.setdefault("_node_mbr_keys", {})
        keys = cache.get(device)
        if keys is None:
            keys = ops.upload(
                ops.f64_sort_keys(np.ascontiguousarray(self.node_mbr.T)),
                device, "tree_descend")
            cache[device] = keys
        return keys

    def _descend(self, boxes: np.ndarray, dist_norm, cs_path: np.ndarray,
                 device: torch.device | str | None) -> np.ndarray:
        """The fused pass: one `ops.tree_descend` call replaces the
        per-level frontier. boxes (B, M, 4) NaN-padded; the same masks as
        `_frontier` (the box expansion and the f64 -> int64 key map are
        exact, so the kernel's integer compares reproduce the host's f64
        interval tests bit-for-bit)."""
        if device is None:
            raise ValueError("the fused descent needs a device")
        device = torch.device(device)
        d = (dist_norm if np.ndim(dist_norm) == 0
             else np.asarray(dist_norm, dtype=np.float64)[:, None])
        expanded = geometry.expand_boxes(boxes, d)          # (B, M, 4)
        keys = ops.f64_sort_keys(expanded)
        pad = ~np.isfinite(boxes[..., 0])                   # ragged padding
        if pad.any():
            keys[pad] = ops.DESCEND_PAD_BOX
        out = ops.tree_descend(
            self._node_key_planes(device),
            ops.upload(np.ascontiguousarray(cs_path, dtype=bool), device,
                       "tree_descend"),
            ops.upload(keys, device, "tree_descend"))
        return out.cpu().numpy()

    # ------------------------------------------------------------------
    # SIP filter material: id intervals + explicit ids for a node set
    # ------------------------------------------------------------------
    def filter_material(self, v_star: np.ndarray
                        ) -> tuple[np.ndarray, np.ndarray]:
        """(intervals (K,2) int64, explicit ids sorted) for SIP filtering.

        Driven-side entries survive iff their spatial id falls in one of the
        I-Range intervals or equals one of the E-list ids (paper §3.2.2).
        """
        v_star = np.asarray(v_star, dtype=np.int64)
        intervals = self.irange[v_star] if len(v_star) else np.zeros((0, 2), np.int64)
        starts = self.elist_offsets[v_star]
        cnt = self.elist_offsets[v_star + 1] - starts
        if cnt.sum() == 0:
            return intervals, np.empty(0, dtype=np.int64)
        if self.packed is not None:
            explicit = np.unique(
                self.packed.decode(self.packed.ranks_of(v_star)[0]))
        else:
            explicit = np.unique(self.elist_ids[csr_gather(starts, cnt)])
        return intervals, explicit


# ----------------------------------------------------------------------------
# Construction
# ----------------------------------------------------------------------------

def _assign_ids(boxes_norm: np.ndarray, l_max: int
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Deepest-enclosing-node assignment -> (id, zpath_own_level, level)."""
    lo = morton.encode_points(boxes_norm[:, 0:2], l_max)
    hi = morton.encode_points(boxes_norm[:, 2:4], l_max)
    level = morton.common_level(lo, hi, l_max)
    zpath = np.asarray(lo, dtype=np.int64) >> (2 * (l_max - level))
    # local ids: running counter within each (zpath, level) node
    order = np.lexsort((np.arange(len(level)), zpath, level))
    local = np.zeros(len(level), dtype=np.int64)
    z_s, l_s = zpath[order], level[order]
    same = np.zeros(len(level), dtype=np.int64)
    if len(level) > 1:
        same_prev = (z_s[1:] == z_s[:-1]) & (l_s[1:] == l_s[:-1])
        run = np.zeros(len(level), dtype=np.int64)
        # running count within equal runs
        idx_change = np.flatnonzero(~same_prev) + 1
        starts = np.concatenate([[0], idx_change])
        lengths = np.diff(np.concatenate([starts, [len(level)]]))
        run = np.arange(len(level)) - np.repeat(starts, lengths)
        same = run
    local[order] = same
    oid = ids.encode(zpath, level, local)
    return oid, zpath, level


@dataclasses.dataclass
class _BuildNode:
    z: int
    level: int
    parent: int
    elist: np.ndarray  # ids of ancestor-assigned objects overlapping this cell


def build(entity_keys: np.ndarray,
          boxes_world: np.ndarray,
          cs_self: np.ndarray,
          cs_in: tuple[np.ndarray, np.ndarray] | None = None,
          cs_out: tuple[np.ndarray, np.ndarray] | None = None,
          extent: Extent | None = None,
          l_max: int = ids.L_MAX,
          leaf_capacity: int = 64,
          bloom_words: int = 8,
          bloom_k: int = 3,
          oids: np.ndarray | None = None,
          boxes_normalized: bool = False,
          compressed: bool = False) -> SQuadTree:
    """Build the S-QuadTree over spatial entities.

    cs_in / cs_out are CSR pairs ``(offsets, cs_ids)`` aligned to
    ``entity_keys`` giving incoming/outgoing characteristic sets per entity.

    ``oids`` supplies precomputed spatial ids aligned to ``entity_keys``
    (with ``boxes_normalized=True`` and an explicit ``extent``): the shard
    builder uses this to keep GLOBAL ids in shard-local trees — re-running
    `_assign_ids` over a shard's subset would restart the per-(zpath, level)
    local counters and diverge from the single-host assignment.
    ``compressed`` packs the E-list tier (`pack_elists`) before returning.
    """
    assert l_max <= ids.L_MAX
    entity_keys = np.asarray(entity_keys, dtype=np.int64)
    boxes_world = np.asarray(boxes_world, dtype=np.float64)
    cs_self = np.asarray(cs_self, dtype=np.int64)
    m = len(entity_keys)
    if extent is None:
        assert not boxes_normalized, "normalized boxes need an explicit extent"
        extent = Extent.of(boxes_world)
    boxes = boxes_world if boxes_normalized else extent.normalize(boxes_world)

    if oids is None:
        oid, zpath, level = _assign_ids(boxes, l_max)
    else:
        oid = np.asarray(oids, dtype=np.int64)
        _, zpath, level, _ = ids.decode(oid)
    order = np.argsort(oid, kind="stable")
    oid, zpath, level = oid[order], zpath[order], level[order]
    boxes, entity_keys, cs_self = boxes[order], entity_keys[order], cs_self[order]
    inv = {int(k): int(i) for k, i in zip(entity_keys, oid)}

    orig_row = order  # post-sort position -> original row

    # ---- top-down materialization -------------------------------------
    nodes: list[_BuildNode] = []
    children_lists: list[list[int]] = []
    node_index: dict[tuple[int, int], int] = {}

    def subtree_slice(z: int, lvl: int) -> slice:
        lo, hi = ids.subtree_interval(np.int64(z), np.int64(lvl))
        return slice(int(np.searchsorted(oid, lo, "left")),
                     int(np.searchsorted(oid, hi, "right")))

    def own_slice(z: int, lvl: int) -> slice:
        lo, hi = ids.node_own_interval(np.int64(z), np.int64(lvl))
        return slice(int(np.searchsorted(oid, lo, "left")),
                     int(np.searchsorted(oid, hi, "right")))

    def cell_box(z: int, lvl: int) -> np.ndarray:
        cx, cy = morton.deinterleave2(np.uint64(z))
        size = 1.0 / (1 << lvl)
        x0, y0 = float(cx) * size, float(cy) * size
        return np.array([x0, y0, x0 + size, y0 + size])

    stack = [(_BuildNode(0, 0, -1, np.empty(0, dtype=np.int64)))]
    while stack:
        bn = stack.pop()
        my_idx = len(nodes)
        nodes.append(bn)
        children_lists.append([-1, -1, -1, -1])
        node_index[(bn.z, bn.level)] = my_idx
        if bn.parent >= 0:
            quad = bn.z & 3
            children_lists[bn.parent][quad] = my_idx
        ss = subtree_slice(bn.z, bn.level)
        n_sub = ss.stop - ss.start
        osl = own_slice(bn.z, bn.level)
        n_own = osl.stop - osl.start
        if bn.level >= l_max or n_sub <= max(leaf_capacity, n_own):
            continue  # leaf: everything below stays in this node's interval
        # split: own (straddler) objects propagate into overlapping children
        own_ids = oid[osl]
        own_boxes = boxes[osl]
        parent_elist_ids = bn.elist
        if len(parent_elist_ids):
            el_rows = np.searchsorted(oid, parent_elist_ids)
            el_boxes = boxes[el_rows]
            push_ids = np.concatenate([own_ids, parent_elist_ids])
            push_boxes = np.concatenate([own_boxes, el_boxes], axis=0)
        else:
            push_ids, push_boxes = own_ids, own_boxes
        for quad in range(4):
            cz = (bn.z << 2) | quad
            csl = subtree_slice(cz, bn.level + 1)
            cbox = cell_box(cz, bn.level + 1)
            if len(push_ids):
                hit = geometry.boxes_intersect(push_boxes, cbox[None, :])
                child_el = np.sort(push_ids[hit])
            else:
                child_el = np.empty(0, dtype=np.int64)
            if (csl.stop - csl.start) == 0 and len(child_el) == 0:
                continue  # empty quadrant: not materialized
            stack.append(_BuildNode(cz, bn.level + 1, my_idx, child_el))

    n = len(nodes)
    node_z = np.array([b.z for b in nodes], dtype=np.int64)
    node_level = np.array([b.level for b in nodes], dtype=np.int32)
    node_parent = np.array([b.parent for b in nodes], dtype=np.int32)
    node_children = np.array(children_lists, dtype=np.int32).reshape(n, 4)
    node_cell = np.stack([cell_box(b.z, b.level) for b in nodes])
    lo, hi = ids.subtree_interval(node_z, node_level.astype(np.int64))
    irange = np.stack([lo, hi], axis=1)

    # per-node intersecting objects = subtree slice + elist
    elist_offsets = np.zeros(n + 1, dtype=np.int64)
    elist_parts = []
    node_mbr = np.zeros((n, 4))
    n_subtree = np.zeros(n, dtype=np.int64)
    bloom_self = BloomBank.empty(n, bloom_words, bloom_k)
    bloom_in = BloomBank.empty(n, bloom_words, bloom_k)
    bloom_out = BloomBank.empty(n, bloom_words, bloom_k)
    stat_nodes, stat_cs = [], []

    in_off, in_vals = (cs_in if cs_in is not None
                       else (np.zeros(m + 1, dtype=np.int64), np.empty(0, np.int64)))
    out_off, out_vals = (cs_out if cs_out is not None
                         else (np.zeros(m + 1, dtype=np.int64), np.empty(0, np.int64)))
    # map post-sort rows back to original rows for the CSR lookups
    row_of_orig = np.empty(m, dtype=np.int64)
    row_of_orig[order] = np.arange(m)

    for i, bn in enumerate(nodes):
        ss = subtree_slice(bn.z, bn.level)
        n_subtree[i] = ss.stop - ss.start
        elist_offsets[i + 1] = len(bn.elist)
        elist_parts.append(bn.elist)
        rows = np.arange(ss.start, ss.stop)
        if len(bn.elist):
            rows = np.concatenate([rows, np.searchsorted(oid, bn.elist)])
        if len(rows) == 0:
            node_mbr[i] = node_cell[i]
            continue
        clipped = geometry.clip_boxes(boxes[rows], node_cell[i])
        node_mbr[i] = geometry.union_boxes(clipped)
        cs_here = cs_self[rows]
        bloom_self.add(np.full(len(rows), i), cs_here)
        stat_nodes.append(np.full(len(rows), i, dtype=np.int64))
        stat_cs.append(cs_here)
        orig = orig_row[rows]
        ins = np.concatenate([in_vals[in_off[r]:in_off[r + 1]] for r in orig]) \
            if cs_in is not None else np.empty(0, np.int64)
        outs = np.concatenate([out_vals[out_off[r]:out_off[r + 1]] for r in orig]) \
            if cs_out is not None else np.empty(0, np.int64)
        if len(ins):
            bloom_in.add(np.full(len(ins), i), ins)
        if len(outs):
            bloom_out.add(np.full(len(outs), i), outs)

    elist_offsets = np.cumsum(elist_offsets)
    elist_ids = (np.concatenate(elist_parts) if elist_parts
                 else np.empty(0, dtype=np.int64))
    cs_stats = build_node_cs_stats(
        np.concatenate(stat_nodes) if stat_nodes else np.empty(0, np.int64),
        np.concatenate(stat_cs) if stat_cs else np.empty(0, np.int64), n)

    tree = SQuadTree(
        extent=extent, l_max=l_max,
        node_z=node_z, node_level=node_level, node_parent=node_parent,
        node_children=node_children, node_cell=node_cell, node_mbr=node_mbr,
        irange=irange, n_subtree=n_subtree,
        elist_offsets=elist_offsets, elist_ids=elist_ids,
        bloom_self=bloom_self, bloom_in=bloom_in, bloom_out=bloom_out,
        cs_stats=cs_stats,
        obj_ids=oid, obj_mbr=boxes, obj_entity=entity_keys,
        entity_to_id=inv,
    )
    return tree.pack_elists() if compressed else tree


# ----------------------------------------------------------------------------
# Z-order cell-list radius join (GNN / molecular neighbor lists)
# ----------------------------------------------------------------------------

def radius_join(points_a: np.ndarray, points_b: np.ndarray, radius: float,
                include_self: bool = True) -> tuple[np.ndarray, np.ndarray]:
    """All pairs (i, j) with ||a_i - b_j|| <= radius, via Z-order cell lists.

    This is the paper's distance join specialized to point sets: the
    full-scan baseline's gist-style candidate filter (core/baselines.py),
    and the neighbour lists of cutoff graphs. O(n) cells instead of
    O(n^2) pairs. Host numpy, as index construction is.
    """
    pa = np.asarray(points_a, dtype=np.float64)
    pb = np.asarray(points_b, dtype=np.float64)
    both = np.concatenate([pa, pb], axis=0)
    ext = Extent.of(geometry.point_boxes(both))
    na = ext.normalize(geometry.point_boxes(pa))[:, :2]
    nb = ext.normalize(geometry.point_boxes(pb))[:, :2]
    # normalization is anisotropic (x / width, y / height): a radius-length
    # offset spans up to radius / min(width, height) normalized units, and
    # the ±1-cell neighborhood is only complete when one cell covers that
    # (radius / max undersizes cells on the narrower axis and drops
    # boundary pairs — caught by the differential query fuzzer)
    r_norm = radius / min(ext.width, ext.height)
    level = int(np.clip(np.floor(-np.log2(max(r_norm, 1e-9))), 0, 16))
    cell_b = morton.cell_of(nb, level)
    nside = 1 << level
    key_b = cell_b[:, 0] * nside + cell_b[:, 1]
    order_b = np.argsort(key_b, kind="stable")
    key_sorted = key_b[order_b]
    cell_a = morton.cell_of(na, level)
    out_i, out_j = [], []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            cx = np.clip(cell_a[:, 0] + dx, 0, nside - 1)
            cy = np.clip(cell_a[:, 1] + dy, 0, nside - 1)
            keys = cx * nside + cy
            lo = np.searchsorted(key_sorted, keys, "left")
            hi = np.searchsorted(key_sorted, keys, "right")
            cnt = hi - lo
            if cnt.sum() == 0:
                continue
            ii = np.repeat(np.arange(len(pa)), cnt)
            jj = order_b[csr_gather(lo, cnt)]
            d = np.sqrt(((pa[ii] - pb[jj]) ** 2).sum(axis=1))
            keep = d <= radius
            if not include_self and len(pa) == len(pb):
                keep = keep & (ii != jj)
            out_i.append(ii[keep])
            out_j.append(jj[keep])
    if not out_i:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    i = np.concatenate(out_i)
    j = np.concatenate(out_j)
    # dedupe (same pair can appear via clipped neighbor cells at the border)
    key = i * np.int64(len(pb)) + j
    _, uniq_idx = np.unique(key, return_index=True)
    return i[uniq_idx], j[uniq_idx]
