"""Characteristic sets (soft schema) and Bloom filters (paper §3.1.3).

A characteristic set (CS) of an entity is the set of predicates attached to it
[Neumann & Moerkotte '11]. STREAK stores, per S-QuadTree node, Bloom filters
over the CS ids of (a) the spatial objects intersecting the node ("self"),
(b) entities with edges *into* those objects ("incoming"), and (c) entities
reached by edges *out of* them ("outgoing") — enabling the focused traversal
of Phase 1 and the cardinality statistics of the cost model.

Bloom filters are bit-packed uint32 words; probes are pure integer math so the
query path can run them vectorized.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels import ops

# 64-bit splitmix-style avalanche.
_C1 = np.uint64(0xBF58476D1CE4E5B9)
_C2 = np.uint64(0x94D049BB133111EB)


def _mix(x: np.ndarray, seed: int) -> np.ndarray:
    with np.errstate(over="ignore"):
        x = np.asarray(x).astype(np.uint64) \
            + np.uint64(0x9E3779B97F4A7C15) * np.uint64(seed + 1)
        x ^= x >> np.uint64(30)
        x = x * _C1
        x ^= x >> np.uint64(27)
        x = x * _C2
        x ^= x >> np.uint64(31)
    return x


def hash_u64(x: np.ndarray, seed: int = 0) -> np.ndarray:
    return _mix(np.asarray(x, dtype=np.int64).view(np.uint64), seed)


# 32-bit murmur3-finalizer family. Bloom probes use THIS family so that the
# numpy path and a 32-bit device probe kernel produce identical bit
# positions.
def mix32(x: np.ndarray, seed: int) -> np.ndarray:
    with np.errstate(over="ignore"):
        x = np.asarray(x, dtype=np.uint32) \
            + np.uint32(0x9E3779B9) * np.uint32(seed + 1)
        x ^= x >> np.uint32(16)
        x = x * np.uint32(0x85EBCA6B)
        x ^= x >> np.uint32(13)
        x = x * np.uint32(0xC2B2AE35)
        x ^= x >> np.uint32(16)
    return x


def hash32(keys: np.ndarray, seed: int = 0) -> np.ndarray:
    """uint32 hash of int64 keys = mix32(lo32 ^ mix32(hi32))."""
    u = np.asarray(keys, dtype=np.int64).view(np.uint64)
    lo = (u & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (u >> np.uint64(32)).astype(np.uint32)
    return mix32(lo ^ mix32(hi, seed + 7), seed)


def cs_id_of_predicate_sets(pred_lists: list[np.ndarray]) -> np.ndarray:
    """Map each entity's sorted predicate set to a stable 63-bit CS id."""
    out = np.empty(len(pred_lists), dtype=np.int64)
    for i, preds in enumerate(pred_lists):
        preds = np.unique(np.asarray(preds, dtype=np.int64))
        h = np.uint64(0x243F6A8885A308D3)
        for p in preds:
            h = _mix(np.uint64(h) ^ np.uint64(p), 17)
        out[i] = np.int64(h & np.uint64(0x7FFFFFFFFFFFFFFF))
    return out


def _cs_ids_segmented(p: np.ndarray, starts: np.ndarray) -> np.ndarray:
    """Stable 63-bit CS ids for segments of a (within-segment sorted)
    predicate column: a hash chain over each segment's distinct predicates.

    Vectorized ACROSS segments: the hash chain is sequential in the j-th
    distinct predicate, so the loop runs over j (max distinct preds per
    subject — single digits) instead of over subjects.
    """
    n_seg = len(starts)
    out = np.full(n_seg, np.uint64(0x243F6A8885A308D3))
    if len(p) == 0 or n_seg == 0:
        return (out & np.uint64(0x7FFFFFFFFFFFFFFF)).astype(np.int64)
    p = np.asarray(p, dtype=np.int64)
    # within-segment dedup (p is sorted inside each segment; a boundary
    # repeating the previous segment's last value must survive)
    keep = np.ones(len(p), dtype=bool)
    keep[1:] = p[1:] != p[:-1]
    keep[starts] = True
    idx = np.flatnonzero(keep)
    seg = np.searchsorted(starts, idx, side="right") - 1
    cnt = np.bincount(seg, minlength=n_seg)
    first = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    for j in range(int(cnt.max(initial=0))):
        sel = cnt > j
        pj = p[idx[first[sel] + j]].astype(np.uint64)
        out[sel] = _mix(out[sel] ^ pj, 17)
    return (out & np.uint64(0x7FFFFFFFFFFFFFFF)).astype(np.int64)


def compute_characteristic_sets(subjects: np.ndarray, predicates: np.ndarray
                                ) -> tuple[np.ndarray, np.ndarray]:
    """Per-distinct-subject CS ids from (subject, predicate) columns.

    Returns (distinct_subjects_sorted, cs_ids aligned to them).
    """
    order = np.lexsort((predicates, subjects))
    s, p = subjects[order], predicates[order]
    uniq, starts = np.unique(s, return_index=True)
    return uniq, _cs_ids_segmented(p, starts)


def cs_catalog(subjects: np.ndarray, predicates: np.ndarray) -> dict:
    """cs_id -> frozenset(predicate ids). Used at query time to find every CS
    compatible with the driven sub-query's predicate set (query preds must be
    a subset of the CS)."""
    order = np.lexsort((predicates, subjects))
    s, p = subjects[order], predicates[order]
    uniq, starts = np.unique(s, return_index=True)
    ends = np.append(starts[1:], len(s))
    cs = _cs_ids_segmented(p, starts)
    catalog: dict = {}
    # one frozenset per DISTINCT CS id (subjects sharing a CS share it)
    _, firsts = np.unique(cs, return_index=True)
    for i in firsts:
        a, b = starts[i], ends[i]
        catalog[int(cs[i])] = frozenset(int(x) for x in np.unique(p[a:b]))
    return catalog


@dataclasses.dataclass(frozen=True)
class PreparedKeys:
    """Hoisted Bloom-probe material for a fixed key set.

    Phase 1 probes the same driven-CS keys against every frontier node of
    every driver block, so the double-hashing positions are query-invariant
    — the executor prepares them once per query and the level-synchronous
    frontier reuses
    them for every level of every lookahead window.
    """

    keys: np.ndarray    # (C,) int64 original keys
    word: np.ndarray    # (C, k) int64 word index per probe
    shift: np.ndarray   # (C, k) uint32 bit offset per probe
    nbits: int          # filter geometry the positions were computed for
    k: int

    def __len__(self) -> int:
        return len(self.keys)


# Probe-backend dispatch for the query path: "numpy" probes on the host;
# "kernel" runs `kernels/ops.bloom_probe_any` on the engine's device (the
# CUDA kernel on CUDA, its plain torch version on the CPU) against the bank's
# copy there. "auto" resolves to the kernel when CUDA is available, numpy
# otherwise.
PROBE_BACKENDS = ("auto", "numpy", "kernel")


def resolve_probe_backend(backend: str | None) -> str:
    b = backend or "auto"
    if b not in PROBE_BACKENDS:
        raise ValueError(f"unknown probe backend {b!r}")
    if b != "auto":
        return b
    return "kernel" if torch.cuda.is_available() else "numpy"


@dataclasses.dataclass
class BloomBank:
    """`n_filters` Bloom filters of `words * 32` bits each, k hash probes.

    The kernel probe route keeps one copy of `bits` per device, made at its
    first probe there (`ops.device_bloom_bank`) and dropped by `add`."""

    bits: np.ndarray  # (n_filters, words) uint32
    k: int = 3
    _resident: dict = dataclasses.field(default_factory=dict, init=False,
                                        repr=False, compare=False)

    @staticmethod
    def empty(n_filters: int, words: int = 8, k: int = 3) -> "BloomBank":
        return BloomBank(np.zeros((n_filters, words), dtype=np.uint32), k)

    @property
    def words(self) -> int:
        return self.bits.shape[1]

    @property
    def nbits(self) -> int:
        return self.words * 32

    def _positions(self, keys: np.ndarray) -> np.ndarray:
        """(len(keys), k) bit positions via double hashing h1 + i*h2."""
        keys = np.asarray(keys, dtype=np.int64)
        h1 = hash32(keys, 0)
        h2 = hash32(keys, 1) | np.uint32(1)
        i = np.arange(self.k, dtype=np.uint32)
        with np.errstate(over="ignore"):
            pos = (h1[:, None] + i[None, :] * h2[:, None]) \
                % np.uint32(self.nbits)
        return pos.astype(np.int64)

    def add(self, filter_idx: np.ndarray, keys: np.ndarray) -> None:
        """Insert keys[i] into filter filter_idx[i] (vectorized)."""
        pos = self._positions(keys)                      # (n, k)
        w, b = pos // 32, (pos % 32).astype(np.uint32)
        fi = np.broadcast_to(np.asarray(filter_idx)[:, None], pos.shape)
        np.bitwise_or.at(self.bits, (fi.ravel(), w.ravel()),
                         (np.uint32(1) << b.ravel()))
        self._resident.clear()     # the device copies are stale

    def device_bits(self, device: torch.device | str) -> torch.Tensor:
        """The (n_filters, words) int32 copy of `bits` kept on `device`."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        held = self._resident.get(device)
        if held is None:
            held = self._resident[device] = ops.device_bloom_bank(self.bits,
                                                                  device)
        return held

    def prepare(self, keys: np.ndarray) -> PreparedKeys:
        """Hoist the double-hashing of `keys` into a reusable PreparedKeys."""
        keys = np.asarray(keys, dtype=np.int64)
        pos = self._positions(keys)                      # (C, k)
        return PreparedKeys(keys=keys, word=pos // 32,
                            shift=(pos % 32).astype(np.uint32),
                            nbits=self.nbits, k=self.k)

    def contains_prepared(self, filter_idx: np.ndarray,
                          prep: PreparedKeys) -> np.ndarray:
        """(len(filter_idx), len(prep)) bool probe matrix, hashing hoisted."""
        assert prep.nbits == self.nbits and prep.k == self.k
        fi = np.asarray(filter_idx, dtype=np.int64)
        word = self.bits[fi[:, None, None], prep.word[None]]   # (F, C, k)
        return ((word >> prep.shift[None]) & np.uint32(1)).all(axis=-1)

    def contains_any_batch(self, filter_idx: np.ndarray, prep: PreparedKeys,
                           backend: str | None = None,
                           device: torch.device | str | None = None
                           ) -> np.ndarray:
        """Per-filter ANY over a prepared key set -> (len(filter_idx),) bool.

        This is the Phase-1 frontier probe: `backend` picks the numpy probe
        or the `bloom_probe_any` kernel on `device`, against the bank's copy
        there (see PROBE_BACKENDS). Both run the same 32-bit integer math,
        so the verdicts are identical.
        """
        fi = np.asarray(filter_idx, dtype=np.int64)
        if len(fi) == 0 or len(prep) == 0:
            return np.zeros(len(fi), dtype=bool)
        if resolve_probe_backend(backend) == "numpy":
            return self.contains_prepared(fi, prep).any(axis=-1)
        if device is None:
            raise ValueError("the kernel probe backend needs a device")
        return ops.bloom_probe_any(self.device_bits(device), fi, prep.keys,
                                   self.k)

    def nbytes(self) -> int:
        return self.bits.nbytes


@dataclasses.dataclass
class NodeCSStats:
    """Per-node CS cardinalities in CSR form (node -> [(cs_id, count)])."""

    offsets: np.ndarray   # (n_nodes + 1,) int64
    cs_ids: np.ndarray    # (nnz,) int64, sorted within each node
    counts: np.ndarray    # (nnz,) int64

    def cardinality_all(self, cs_query: np.ndarray) -> np.ndarray:
        """Vectorized per-node total count of objects whose CS is in
        `cs_query` -> (n_nodes,). One pass over the CSR; query-invariant
        across driver blocks, so the executor computes it once per query."""
        n_nodes = len(self.offsets) - 1
        if len(self.cs_ids) == 0 or len(cs_query) == 0:
            return np.zeros(n_nodes, dtype=np.int64)
        hit = np.isin(self.cs_ids, np.asarray(cs_query, dtype=np.int64))
        contrib = np.where(hit, self.counts, 0)
        csum = np.concatenate([[0], np.cumsum(contrib)])
        return csum[self.offsets[1:]] - csum[self.offsets[:-1]]

    def cardinality(self, node: int, cs_query: np.ndarray) -> int:
        """Total count of objects at `node` whose CS is in `cs_query`.

        This is C(R) of the paper's cost model when `cs_query` is the driven
        sub-query's CS set, and |CS(a)| in cost(a).
        """
        a, b = self.offsets[node], self.offsets[node + 1]
        ids, cnt = self.cs_ids[a:b], self.counts[a:b]
        idx = np.searchsorted(ids, np.asarray(cs_query, dtype=np.int64))
        idx = np.clip(idx, 0, len(ids) - 1) if len(ids) else idx
        if len(ids) == 0:
            return 0
        hit = ids[idx] == np.asarray(cs_query, dtype=np.int64)
        return int(cnt[idx][hit].sum())

    def nbytes(self) -> int:
        return self.offsets.nbytes + self.cs_ids.nbytes + self.counts.nbytes


def build_node_cs_stats(node_of_item: np.ndarray, cs_of_item: np.ndarray,
                        n_nodes: int) -> NodeCSStats:
    """Aggregate (node, cs) -> count into CSR. Items may repeat nodes."""
    if len(node_of_item) == 0:
        return NodeCSStats(np.zeros(n_nodes + 1, dtype=np.int64),
                           np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64))
    order = np.lexsort((cs_of_item, node_of_item))
    n, c = node_of_item[order], cs_of_item[order]
    key_change = np.empty(len(n), dtype=bool)
    key_change[0] = True
    key_change[1:] = (n[1:] != n[:-1]) | (c[1:] != c[:-1])
    group = np.cumsum(key_change) - 1
    counts = np.bincount(group)
    firsts = np.flatnonzero(key_change)
    gn, gc = n[firsts], c[firsts]
    offsets = np.zeros(n_nodes + 1, dtype=np.int64)
    np.add.at(offsets, gn + 1, 1)
    offsets = np.cumsum(offsets)
    return NodeCSStats(offsets, gc.astype(np.int64), counts.astype(np.int64))
