"""Vectorized relational algebra over column blocks.

A Relation is a dict of equal-length int64 numpy columns keyed by variable
name. Joins are sort-merge over composite keys, the vectorized analogue of
RDF-3X's merge joins over sorted permutation-index scans.

Every equi-join primitive here (`join`, `semijoin`, `filter_in_ranges`)
shares one machinery: `composite_keys` packs the `on` columns of both sides
into order-isomorphic int64 scalars (arithmetic range packing, with a dense
np.unique ranking fallback when the domain product would overflow), and the
two-phase rank/gather core turns the rank pass into a single call on the
`kernels/ops.merge_join_ranks` backend (numpy searchsorted on the host, or
the rank kernel on the engine's device) followed by a CSR cumsum/repeat
gather (`squadtree.csr_gather`).

Two bit-identical fast paths sit in front of the sort: relations carry
`sorted_by` (index scans report their permutation-index order, join outputs
are ordered by their `on` key), which turns the stable argsort into the
identity, and a per-relation `_keycache` replays a packing's per-column
(vmin, span) params against new partners so `_join_chain` steps that share
an `on` prefix never re-sort the big side.

The pre-rework per-pattern numpy implementations — lexsort + per-column
np.unique dense ranking + range expansion — are kept verbatim as the
`*_looped` oracles; the merge path must stay bit-identical to them
(including row order: both sort stably by the same composite key).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels import ops
from .query import TriplePattern, Var
from .squadtree import csr_gather
from .store import G, O, P, QuadStore, S

# `impl` knob for the relational primitives: "merge" is the two-phase
# rank/gather core (backend-dispatched rank pass), "looped" the pre-rework
# numpy oracle. "auto" resolves to "merge".
JOIN_IMPLS = ("auto", "merge", "looped")


def resolve_join_impl(impl: str | None) -> str:
    impl = impl or "auto"
    if impl not in JOIN_IMPLS:
        raise ValueError(f"unknown join impl {impl!r}")
    return "merge" if impl == "auto" else impl


class Relation(dict):
    """dict[str, np.ndarray] with aligned rows.

    Two derived annotations ride along for the merge-join fast paths, both
    conservatively dropped whenever a column is (re)assigned:

    - ``sorted_by``: names the rows are known to be lexicographically sorted
      by (stable ties). When a join's ``on`` tuple is a prefix of it, the
      stable sorting permutation is the identity, so the argsort — the
      dominant cost at ≥32k rows — is skipped bit-identically.
    - ``_keycache``: per-``on`` packed composite keys (packing params +
      sorted keys + permutation + the sorted keys' resident copies on the
      devices that rank against them), reused across `_join_chain` steps
      and driver blocks that re-join the same relation on the same columns.
    """

    sorted_by: tuple = ()

    def __setitem__(self, key, value):
        self.__dict__.pop("_keycache", None)
        self.__dict__.pop("sorted_by", None)  # back to the class default ()
        super().__setitem__(key, value)

    @property
    def n(self) -> int:
        return len(next(iter(self.values()), ()))

    def take(self, idx: np.ndarray) -> "Relation":
        return Relation({k: v[idx] for k, v in self.items()})

    @staticmethod
    def empty(cols: list[str]) -> "Relation":
        return Relation({c: np.empty(0, dtype=np.int64) for c in cols})


def scan_pattern(store: QuadStore, tp: TriplePattern) -> Relation:
    """Index scan for one quad pattern -> relation over its variables."""
    def const(t):
        return None if (t is None or isinstance(t, Var)) else int(t)
    rows, sort_cols = store.scan(g=const(tp.g), s=const(tp.s), p=const(tp.p),
                                 o=const(tp.o), return_order=True)
    slots = ((tp.g, G), (tp.s, S), (tp.p, P), (tp.o, O))
    var_cols: dict[str, list[int]] = {}
    for term, col in slots:
        if isinstance(term, Var):
            var_cols.setdefault(term.name, []).append(col)
    # repeated variable within one pattern -> intra-row equality filter
    mask = np.ones(len(rows), dtype=bool)
    for cols in var_cols.values():
        for c in cols[1:]:
            mask &= rows[:, cols[0]] == rows[:, c]
    if not mask.all():
        rows = rows[mask]
    rel = Relation({name: rows[:, cols[0]].copy()
                    for name, cols in var_cols.items()})
    # rows come back lexicographically sorted by `sort_cols` (the chosen
    # index's columns past the bound prefix); translate to variable names,
    # skipping bound columns (constant over the result) and repeat
    # occurrences of a variable (tied by the equality filter above) —
    # neither affects the lexicographic order of what remains
    order: list[str] = []
    for c in sort_cols:
        for name, cols in var_cols.items():
            if c in cols:
                if name not in order:
                    order.append(name)
                break
    rel.sorted_by = tuple(order)
    return rel


# ---------------------------------------------------------------------------
# shared composite-key machinery
# ---------------------------------------------------------------------------

# packed keys must stay strictly below int64-max, the rank kernel's padding
# sentinel (kernels/merge_join.py)
_KEY_SPACE = (1 << 63) - 1


def composite_keys(a: Relation, b: Relation,
                   on: list[str]) -> tuple[np.ndarray, np.ndarray, int]:
    """Order-isomorphic int64 scalar keys for the composite `on` columns,
    plus the exact key-domain bound `scale` (keys live in [0, scale))."""
    ka, kb, scale, _ = _composite_keys_meta(a, b, on)
    return ka, kb, scale


def _composite_keys_meta(a: Relation, b: Relation, on: list[str]):
    """Packed keys, scale, and the per-column (vmin, span) packing params.

    Columns are range-offset and mixed arithmetically (key = key * span +
    (v - vmin)), so the packed scalars compare exactly like the column
    tuples and no per-column sorting is needed. When the running domain
    product would leave [0, 2^63-1), the offending column — and, if still
    necessary, the accumulated prefix keys — are dense-ranked over the union
    of both sides (np.unique), which bounds every factor by the row count
    while preserving order. Both sides must be non-empty.

    The returned params are None once any dense-rank fallback fires (the
    ranking depends on both sides' value sets, so the packing can't be
    replayed against a different partner); otherwise they fully determine
    the packing, and any relation whose column values fall inside the
    per-column [vmin, vmin+span) windows packs to keys comparable with —
    and bit-identical against — this call's.
    """
    ka = np.zeros(a.n, dtype=np.int64)
    kb = np.zeros(b.n, dtype=np.int64)
    scale = 1  # python int: packed keys so far live in [0, scale)
    params: list[tuple[int, int]] | None = []
    for c in on:
        va = np.asarray(a[c], dtype=np.int64)
        vb = np.asarray(b[c], dtype=np.int64)
        vmin = int(min(va.min(), vb.min()))
        span = int(max(va.max(), vb.max())) - vmin + 1
        if scale * span > _KEY_SPACE:
            params = None
            uniq, inv = np.unique(np.concatenate([va, vb]),
                                  return_inverse=True)
            va, vb = inv[:len(va)], inv[len(va):]
            vmin, span = 0, len(uniq)
            if scale * span > _KEY_SPACE:
                uniq, inv = np.unique(np.concatenate([ka, kb]),
                                      return_inverse=True)
                ka, kb = inv[:len(ka)], inv[len(ka):]
                scale = len(uniq)
                if scale * span > _KEY_SPACE:
                    # both factors are now bounded by the combined row
                    # count, so this needs > ~3e9 rows per side — raise
                    # rather than let the packing wrap int64 silently
                    raise OverflowError(
                        f"composite key domain {scale}x{span} exceeds int64")
        if params is not None:
            params.append((vmin, span))
        ka = ka * np.int64(span) + (va - np.int64(vmin))
        kb = kb * np.int64(span) + (vb - np.int64(vmin))
        scale *= span
    return ka, kb, scale, (tuple(params) if params is not None else None)


def _pack_with_params(rel: Relation, on: list[str],
                      params: tuple) -> np.ndarray:
    """Replay a `_composite_keys_meta` packing against another relation.

    Only valid when `_params_fit` holds; then every key lands in the same
    [0, scale) domain with the same ordering, so ranks against keys packed
    by the original call are bit-identical to a joint repacking.
    """
    k = np.zeros(rel.n, dtype=np.int64)
    for c, (vmin, span) in zip(on, params):
        v = np.asarray(rel[c], dtype=np.int64)
        k = k * np.int64(span) + (v - np.int64(vmin))
    return k


def _params_fit(rel: Relation, on: list[str], params: tuple) -> bool:
    """Do `rel`'s `on` values fall inside the packing's per-column windows?"""
    for c, (vmin, span) in zip(on, params):
        v = np.asarray(rel[c], dtype=np.int64)
        if int(v.min()) < vmin or int(v.max()) >= vmin + span:
            return False
    return True


# Per-Relation `_keycache` budget. Each entry holds the packed keys plus the
# sorting permutation (two int64 arrays the length of the relation) and the
# keys' copies on the devices a kernel rank pass ran on, so an unbounded
# cache on a long-lived scan-cache relation grows with every distinct `on`
# tuple it is ever joined by. Insertion order doubles as recency order
# (hits are re-inserted at the end), so eviction is LRU.
KEYCACHE_MAX_ENTRIES = 8
KEYCACHE_MAX_BYTES = 1 << 27        # 128 MiB of cached keys, perms and
#                                     resident copies per Relation


def _cache_nbytes(ent) -> int:
    return ent[2].nbytes + ent[3].nbytes + sum(
        t.numel() * t.element_size() for t in ent[4].values())


def _evict(cache: dict) -> None:
    """Drop least-recently-used entries beyond the budget; the most recent
    entry always survives, even when alone over-budget."""
    while len(cache) > 1 and (
            len(cache) > KEYCACHE_MAX_ENTRIES
            or sum(_cache_nbytes(e) for e in cache.values())
            > KEYCACHE_MAX_BYTES):
        cache.pop(next(iter(cache)))


def _cached_pack(rel: Relation, on_t: tuple):
    cache = rel.__dict__.get("_keycache")
    if not cache:
        return None
    ent = cache.get(on_t)
    if ent is not None:             # touch: move to the recent end
        cache.pop(on_t)
        cache[on_t] = ent
    return ent


def _store_pack(rel: Relation, on_t: tuple, params, scale: int,
                ks: np.ndarray, perm: np.ndarray) -> None:
    if params is None:
        return
    cache = rel.__dict__.setdefault("_keycache", {})
    if on_t in cache:               # keep the first packing, but touch it
        cache[on_t] = cache.pop(on_t)
        return
    cache[on_t] = (params, scale, ks, perm, {})   # {}: resident copies
    _evict(cache)


def _resident_table(rel: Relation, on_t: tuple, ks: np.ndarray,
                    backend: str | None, device):
    """The copy on `device` of `rel`'s cached sorted keys `ks`, for a
    kernel rank pass there: made on first use for the entry and device,
    kept in the entry, counted in its bytes and evicted with it. None when
    the rank pass runs on the host or `ks` is not the array `rel` caches
    for `on_t` (a table built for this call)."""
    if device is None or ops.resolve_rank_backend(backend) != "kernel":
        return None
    cache = rel.__dict__.get("_keycache")
    ent = cache.get(on_t) if cache else None
    if ent is None or ent[2] is not ks:
        return None
    device = torch.device(device)
    t = ent[4].get(device)
    if t is None:
        t = ent[4][device] = ops.device_table(ks, device)
        _evict(cache)
    return t


def _sorted_keys(rel: Relation, k: np.ndarray, scale: int,
                 on_t: tuple) -> tuple[np.ndarray, np.ndarray]:
    """`_sort_with_perm`, skipping the sort when `rel`'s rows are already
    sorted by an `on_t` prefix (then the stable permutation is the
    identity and the packed keys are already in order)."""
    if rel.sorted_by[:len(on_t)] == on_t:
        return k, np.arange(rel.n, dtype=np.int64)
    return _sort_with_perm(k, scale)


def _sort_with_perm(k: np.ndarray, scale: int) -> tuple[np.ndarray,
                                                        np.ndarray]:
    """Sorted keys + the stable sorting permutation.

    When the (key, row-index) pair packs into int64 — scale tracked by
    `composite_keys` leaves ceil(log2(n)) free low bits — one vectorized
    np.sort of the packed array replaces np.argsort(kind="stable"), whose
    mergesort is ~10x slower than numpy's SIMD introsort on ints; the row
    index doubles as the tiebreaker, so stability is preserved. Falls back
    to the stable argsort when the pack would overflow.
    """
    n = len(k)
    bits = max((n - 1).bit_length(), 1)
    if scale <= (_KEY_SPACE >> bits):
        packed = np.sort((k << np.int64(bits))
                         | np.arange(n, dtype=np.int64))
        return packed >> np.int64(bits), packed & np.int64((1 << bits) - 1)
    perm = np.argsort(k, kind="stable")
    return k[perm], perm


def _ranks(table: np.ndarray, probes: np.ndarray,
           backend: str | None, side: str = "both", device=None,
           on_device=None):
    """Insertion ranks of probes in the sorted table, via the dispatched
    rank backend (a kernel backend runs on `device`, against the table's
    resident copy `on_device` when there is one); side="both" ->
    (left, right), else the one bound."""
    return ops.merge_join_ranks(table, probes, backend=backend, side=side,
                                device=device, table_on_device=on_device)


def _member_sorted(table: np.ndarray, probes: np.ndarray,
                   backend: str | None, device=None,
                   on_device=None) -> np.ndarray:
    """Membership of probes in the sorted (not necessarily unique) table:
    one left-rank pass plus a gather-compare."""
    lo = _ranks(table, probes, backend, side="left", device=device,
                on_device=on_device)
    hit = table[np.minimum(lo, len(table) - 1)] == probes
    return hit  # lo == len(table) ⇒ probe > table[-1] ⇒ compare is False


def _cartesian(a: Relation, b: Relation) -> Relation:
    na, nb = a.n, b.n
    out = Relation()
    ia = np.repeat(np.arange(na), nb)
    ib = np.tile(np.arange(nb), na)
    for k, v in a.items():
        out[k] = v[ia]
    for k, v in b.items():
        out[k] = v[ib]
    return out


# ---------------------------------------------------------------------------
# join
# ---------------------------------------------------------------------------

def join(a: Relation, b: Relation, on: list[str] | None = None,
         impl: str | None = None, backend: str | None = None,
         device=None) -> Relation:
    """Natural equi-join on shared variables (two-phase sort-merge).

    Phase 1 (rank/count): stable-sort both packed key arrays, then one
    backend call yields each probe row's [lo, hi) match range and CSR width
    `hi - lo`. Phase 2 (gather): cumsum/repeat materializes the matching
    (a-row, b-row) index pairs with static shapes and gathers the output
    columns once. Output order is bit-identical to `join_looped`. A
    kernel rank `backend` runs on `device`.
    """
    if on is None:
        on = sorted(set(a.keys()) & set(b.keys()))
    if not on:  # cartesian product
        return _cartesian(a, b)
    if a.n == 0 or b.n == 0:
        return Relation.empty(sorted(set(a) | set(b)))
    if resolve_join_impl(impl) == "looped":
        return join_looped(a, b, on)
    on_t = tuple(on)
    sides = None
    # reuse one side's cached packing when the other side's values fit its
    # per-column windows (same params ⇒ comparable keys ⇒ identical ranks);
    # prefer b's cache — in `_join_chain` b is the large per-pattern scan
    # re-joined every driver block, so its sort is the one worth skipping
    for cached, fresh, b_cached in ((b, a, True), (a, b, False)):
        ent = _cached_pack(cached, on_t)
        if ent is not None and _params_fit(fresh, on, ent[0]):
            params, scale, kcs, oc, _ = ent
            kf = _pack_with_params(fresh, on, params)
            kfs, of = _sorted_keys(fresh, kf, scale, on_t)
            _store_pack(fresh, on_t, params, scale, kfs, of)
            sides = (kfs, of, kcs, oc) if b_cached else (kcs, oc, kfs, of)
            break
    if sides is None:
        ka, kb, scale, params = _composite_keys_meta(a, b, on)
        kas, oa = _sorted_keys(a, ka, scale, on_t)
        kbs, ob = _sorted_keys(b, kb, scale, on_t)
        _store_pack(a, on_t, params, scale, kas, oa)
        _store_pack(b, on_t, params, scale, kbs, ob)
        sides = (kas, oa, kbs, ob)
    kas, oa, kbs, ob = sides
    # kbs is b's cached table unless the packing came from a's cache and b
    # already cached another one; only a cached table stays on the device
    lo, hi = _ranks(kbs, kas, backend, device=device,
                    on_device=_resident_table(b, on_t, kbs, backend, device))
    cnt = hi - lo
    ia = np.repeat(np.arange(a.n), cnt)
    ib = csr_gather(lo, cnt)
    src_a, src_b = oa[ia], ob[ib]
    out = Relation({k: v[src_a] for k, v in a.items()})
    for k, v in b.items():
        if k not in out:
            out[k] = v[src_b]
    # output rows follow a's sorted key order (stable within ties), so the
    # next chain step joining on the same prefix skips its argsort entirely
    out.sorted_by = on_t
    return out


def join_looped(a: Relation, b: Relation,
                on: list[str] | None = None) -> Relation:
    """Pre-rework numpy join (lexsort + per-column dense ranking +
    searchsorted + range expansion), kept as the bit-identical oracle."""
    if on is None:
        on = sorted(set(a.keys()) & set(b.keys()))
    if not on:  # cartesian product
        return _cartesian(a, b)
    if a.n == 0 or b.n == 0:
        return Relation.empty(sorted(set(a) | set(b)))
    # sort both sides by the composite key
    oa = _composite_key(a, on)
    ob = _composite_key(b, on)
    a_sorted = a.take(oa)
    b_sorted = b.take(ob)
    # dense-rank the key domain on the union so searchsorted works per-column
    ka = _rank_rows(a_sorted, b_sorted, on)
    kb = _rank_rows(b_sorted, a_sorted, on)
    lo = np.searchsorted(kb, ka, "left")
    hi = np.searchsorted(kb, ka, "right")
    cnt = hi - lo
    ia = np.repeat(np.arange(a_sorted.n), cnt)
    ib = _expand_ranges(lo, hi)
    out = Relation()
    for k, v in a_sorted.items():
        out[k] = v[ia]
    for k, v in b_sorted.items():
        if k not in out:
            out[k] = v[ib]
    return out


def _composite_key(rel: Relation, names: list[str]) -> np.ndarray:
    """Lexicographic rank array for the given columns (stable)."""
    cols = [rel[n] for n in names]
    order = np.lexsort(tuple(reversed(cols)))
    return order


def _rank_rows(x: Relation, other: Relation, on: list[str]) -> np.ndarray:
    """Map composite keys to comparable scalars via shared dense ranking."""
    both = [np.concatenate([x[c], other[c]]) for c in on]
    nx = x.n
    key = np.zeros(len(both[0]), dtype=np.int64)
    for col in both:
        uniq, inv = np.unique(col, return_inverse=True)
        key = key * np.int64(len(uniq)) + inv  # may wrap for huge domains;
        # domain sizes here are bounded by block cardinalities (<2^20 each)
    return key[:nx]


def _expand_ranges(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Concatenate arange(lo[i], hi[i]) for all i, vectorized."""
    cnt = hi - lo
    nz = cnt > 0
    l, c = lo[nz], cnt[nz]
    total = int(c.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    out = np.ones(total, dtype=np.int64)
    out[0] = l[0]
    if len(l) > 1:
        pos = np.cumsum(c)[:-1]
        out[pos] = l[1:] - (l[:-1] + c[:-1] - 1)
    return np.cumsum(out)


# ---------------------------------------------------------------------------
# semijoin
# ---------------------------------------------------------------------------

def semijoin(a: Relation, b: Relation, on: list[str] | None = None,
             impl: str | None = None,
             backend: str | None = None, device=None) -> Relation:
    """Rows of `a` that have at least one match in `b` (original order).

    Same machinery as `join`, but only the b side is sorted and a single
    left-rank pass drives the membership test — no gather phase.
    """
    if on is None:
        on = sorted(set(a.keys()) & set(b.keys()))
    if not on or a.n == 0:
        return a
    if b.n == 0:
        return a.take(np.empty(0, dtype=np.int64))
    if resolve_join_impl(impl) == "looped":
        return semijoin_looped(a, b, on)
    on_t = tuple(on)
    ent = _cached_pack(b, on_t)
    if ent is not None and _params_fit(a, on, ent[0]):
        kbs = ent[2]  # already sorted (stable sort == np.sort on values)
        ka = _pack_with_params(a, on, ent[0])
    else:
        ka, kb, _ = composite_keys(a, b, on)
        kbs = kb if b.sorted_by[:len(on_t)] == on_t else np.sort(kb)
    keep = _member_sorted(kbs, ka, backend, device,
                          _resident_table(b, on_t, kbs, backend, device))
    out = a.take(np.flatnonzero(keep))
    out.sorted_by = a.sorted_by  # flatnonzero keeps row order
    return out


def semijoin_looped(a: Relation, b: Relation,
                    on: list[str] | None = None) -> Relation:
    """Pre-rework numpy semijoin, kept as the bit-identical oracle."""
    if on is None:
        on = sorted(set(a.keys()) & set(b.keys()))
    if not on or a.n == 0:
        return a
    if b.n == 0:
        return a.take(np.empty(0, dtype=np.int64))
    ob = _composite_key(b, on)
    b_sorted = b.take(ob)
    ka = _rank_rows(a, b_sorted, on)
    kb = _rank_rows(b_sorted, a, on)
    kb_sorted = np.sort(kb)
    pos = np.searchsorted(kb_sorted, ka)
    pos = np.clip(pos, 0, len(kb_sorted) - 1)
    hit = kb_sorted[pos] == ka
    return a.take(np.flatnonzero(hit))


# ---------------------------------------------------------------------------
# SIP range/membership filter
# ---------------------------------------------------------------------------

def filter_in_ranges(rel: Relation, col: str, intervals: np.ndarray,
                     explicit: np.ndarray, impl: str | None = None,
                     backend: str | None = None, device=None) -> Relation:
    """SIP filter (paper §3.2.2): keep rows whose `col` id lies in any I-Range
    interval or equals an E-list id. Intervals are closed [lo, hi] rows.

    The E-list membership test is the semijoin's `_member_sorted` rank test
    against the sorted id table; the interval test uses the rank pass' upper
    bound
    against the interval starts with a running max of ends, so OVERLAPPING
    intervals are handled (v is in the union iff the max end among intervals
    starting <= v covers it). V* intervals are disjoint by construction, but
    the general case must hold too.
    """
    if rel.n == 0 or (len(intervals) == 0 and len(explicit) == 0):
        return rel if (len(intervals) or len(explicit)) else rel.take(
            np.empty(0, dtype=np.int64))
    return select_in_ranges(rel, col, intervals, explicit, impl, backend,
                            device)[0]


def select_in_ranges(rel: Relation, col: str, intervals: np.ndarray,
                     explicit: np.ndarray, impl: str | None = None,
                     backend: str | None = None, device=None,
                     index: SipIndex | None = None
                     ) -> tuple[Relation, np.ndarray | None]:
    """`filter_in_ranges`' kept relation, and on the merge impl the
    ascending indices of the rows of `rel` it kept (None on the looped
    oracle). The merge relation keeps `rel.sorted_by`. Given `index`,
    `rel`'s `SipIndex` of `col`, the merge impl ranks the filter's bounds
    and ids against it (`rows_in_index`), not `rel`'s column against
    them; the rows are the same."""
    if resolve_join_impl(impl) == "looped":
        return filter_in_ranges_looped(rel, col, intervals, explicit), None
    rows = (rows_in_ranges(rel, col, intervals, explicit, backend, device)
            if index is None
            else rows_in_index(index, intervals, explicit, backend, device))
    out = rel.take(rows)
    out.sorted_by = rel.sorted_by  # the rows keep their order
    return out, rows


def rows_in_ranges(rel: Relation, col: str, intervals: np.ndarray,
                   explicit: np.ndarray, backend: str | None = None,
                   device=None) -> np.ndarray:
    """Ascending indices of the rows of `rel` that the merge
    `filter_in_ranges` keeps."""
    if rel.n == 0 or (len(intervals) == 0 and len(explicit) == 0):
        return np.empty(0, dtype=np.int64)
    vals = rel[col]
    keep = np.zeros(rel.n, dtype=bool)
    if len(intervals):
        iv = intervals[np.argsort(intervals[:, 0])]
        starts = iv[:, 0]
        ends = np.maximum.accumulate(iv[:, 1])
        pos = _ranks(starts, vals, backend, side="right", device=device) - 1
        ok = pos >= 0
        keep[ok] = vals[ok] <= ends[np.clip(pos[ok], 0, len(ends) - 1)]
    if len(explicit):
        keep |= _member_sorted(np.asarray(explicit, dtype=np.int64), vals,
                               backend, device)
    return np.flatnonzero(keep)


@dataclasses.dataclass(frozen=True, eq=False)
class SipIndex:
    """One relation's column sorted once, for the SIP filters of that
    relation (`rows_in_index`): the column sorted stably, the row of each
    sorted entry (None: the rows are sorted by the column already), and
    the sorted column's resident copy on the device a kernel rank pass
    runs on (None on the host backend)."""
    keys: np.ndarray                 # (n,) int64, non-decreasing
    perm: np.ndarray | None          # (n,) int64 row of each key
    on_device: torch.Tensor | None

    @classmethod
    def build(cls, rel: Relation, col: str, backend: str | None = None,
              device=None) -> SipIndex:
        vals = np.asarray(rel[col], dtype=np.int64)
        if rel.sorted_by[:1] == (col,):
            keys, perm = vals, None
        else:
            perm = np.argsort(vals, kind="stable")
            keys = vals[perm]
        kernel = ops.resolve_rank_backend(backend) == "kernel"
        return cls(keys, perm, ops.device_table(keys, device)
                   if kernel and device is not None else None)


def rows_in_index(index: SipIndex, intervals: np.ndarray,
                  explicit: np.ndarray, backend: str | None = None,
                  device=None) -> np.ndarray:
    """`rows_in_ranges` of the relation `index` sorts, the other way
    round: the intervals' lower and upper bounds and the E-list ids are
    ranked against the sorted column in one call. An interval [lo, hi]
    keeps the sorted positions from lo's left rank to hi's right rank, an
    id those from its left rank to its right rank; an empty or inverted
    range keeps nothing. The kept positions mark their rows through the
    permutation, so the rows come out ascending:
    O((2I + E) log N + N + kept) against `rows_in_ranges`'
    O(N log(I + E) + N)."""
    n, ni = len(index.keys), len(intervals)
    if n == 0 or (ni == 0 and len(explicit) == 0):
        return np.empty(0, dtype=np.int64)
    iv = np.asarray(intervals, dtype=np.int64).reshape(ni, 2)
    left, right = _ranks(index.keys, np.concatenate(
        [iv[:, 0], iv[:, 1], np.asarray(explicit, dtype=np.int64)]),
        backend, device=device, on_device=index.on_device)
    pos = _expand_ranges(np.concatenate([left[:ni], left[2 * ni:]]),
                         np.concatenate([right[ni:2 * ni], right[2 * ni:]]))
    keep = np.zeros(n, dtype=bool)
    keep[pos if index.perm is None else index.perm[pos]] = True
    return np.flatnonzero(keep)


def in_ranges_mask(vals: np.ndarray, intervals: np.ndarray,
                   explicit: np.ndarray) -> np.ndarray:
    """SIP membership of the ids `vals` in closed I-Range `intervals` or
    the sorted E-list ids `explicit`, in numpy: the bool mask the looped
    filter keeps rows by (the merge filter's rank-backend twin is
    `rows_in_ranges`)."""
    keep = np.zeros(len(vals), dtype=bool)
    if len(intervals):
        iv = intervals[np.argsort(intervals[:, 0])]
        starts = iv[:, 0]
        ends = np.maximum.accumulate(iv[:, 1])
        pos = np.searchsorted(starts, vals, "right") - 1
        ok = pos >= 0
        keep[ok] = vals[ok] <= ends[np.clip(pos[ok], 0, len(ends) - 1)]
    if len(explicit):
        pos = np.searchsorted(explicit, vals)
        pos = np.clip(pos, 0, len(explicit) - 1)
        keep |= explicit[pos] == vals
    return keep


def filter_in_ranges_looped(rel: Relation, col: str, intervals: np.ndarray,
                            explicit: np.ndarray) -> Relation:
    """Pre-rework numpy SIP filter, kept as the bit-identical oracle."""
    if rel.n == 0 or (len(intervals) == 0 and len(explicit) == 0):
        return rel if (len(intervals) or len(explicit)) else rel.take(
            np.empty(0, dtype=np.int64))
    return rel.take(np.flatnonzero(in_ranges_mask(rel[col], intervals,
                                                  explicit)))
