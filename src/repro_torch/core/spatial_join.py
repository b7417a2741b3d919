"""The block spatial join: Phases 1-3 + refinement (paper §3.2).

Phase 1 (candidate nodes) lives on SQuadTree.candidate_nodes; Phase 2 is
node_select.select + SIP filter material; this module is Phase 3 — the
pairwise MBR distance join between a driver block and the SIP-filtered driven
candidates — plus the exact-geometry refinement step.

The MBR join is the compute hot spot. Three backends:

- ``numpy``  — dense broadcast via geometry.box_min_dist on the host.
- ``kernel`` — the distance-join kernel (`ops.distance_join_pairs`): tests
  the full (M, N) block on the device and brings back only the candidate
  pairs.
- ``fused``  — the streaming top-k kernel (`ops.fused_topk_join`): driven
  entities are fed in score-key order, each column batch is reduced on the
  device to per-row top-k partials under the current top-k threshold θ, and
  the (M, N) matrix never exists. `fused_stream_join` below is the driver:
  it re-reads θ between batches (so early termination prunes *inside* an
  executor block) and recovers overflowing rows densely so the candidate
  set stays exact.

The kernels run on the `device` the caller passes: the CUDA kernels on a
CUDA device, their plain torch versions on the CPU. All f32 distances use
the unfused ``sqrt(dx*dx + dy*dy)`` with every step rounded, so the matrix
kernel reproduces the fused kernel's predicate bit-for-bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels import ops
from . import geometry, topk as topk_mod
from .squadtree import csr_gather

# Phase-3 MBR-join backend registry (see module docstring). "auto" resolves
# to the dense numpy broadcast: the kernel path pays (M, N) materialization
# and the fused path only wins with real score keys + a live θ, which the
# executor supplies explicitly when configured.
JOIN_BACKENDS = ("auto", "numpy", "kernel", "fused")


def resolve_join_backend(backend: str | None) -> str:
    b = backend or "auto"
    if b not in JOIN_BACKENDS:
        raise ValueError(f"unknown spatial join backend {b!r}")
    return "numpy" if b == "auto" else b


@dataclasses.dataclass
class JoinStats:
    candidates: int = 0       # MBR-level candidate pairs emitted
    refined: int = 0          # pairs surviving exact refinement
    pairs_tested: int = 0     # full MBR pairs evaluated (block product)
    refine_skipped: int = 0   # candidate pairs never refined (θ-aware skip)
    overflow_rows: int = 0    # driver rows recovered densely (partial width
    #                           overflow in the fused kernel)
    overflow_batches: int = 0  # column batches with >= 1 overflowing row


@dataclasses.dataclass
class KcapTuner:
    """EWMA autotuner for the fused kernel's per-row partial width.

    The fixed ``min(max(k, 64), batch_cols)`` floor pays worst-case partial
    widths on every launch even when θ has tightened enough that almost no
    pairs survive. The tuner tracks an EWMA of the observed per-launch MAX
    survivor count and suggests ``headroom`` times that, quantized to the
    next power of two and
    clamped to ``[max(k, floor), min(ceiling, batch_cols)]``. Undershooting
    a survivor burst is *safe* — overflowing rows are recovered densely by
    the caller (see fused_stream_join) — it only costs recompute, which
    JoinStats.overflow_* makes observable.
    """
    alpha: float = 0.25       # EWMA smoothing weight for the newest sample
    headroom: float = 1.5     # width multiplier over the smoothed max
    floor: int = 8            # never suggest below this (absent a larger k)
    ceiling: int = 1024       # never suggest above this
    ewma: float | None = None

    def update(self, counts: np.ndarray) -> None:
        """Fold one launch's per-row survivor counts into the EWMA."""
        if len(counts) == 0:
            return
        obs = float(np.max(counts))
        self.ewma = obs if self.ewma is None else (
            self.alpha * obs + (1.0 - self.alpha) * self.ewma)

    def suggest(self, k: int, batch_cols: int) -> int:
        if self.ewma is None:               # cold start: the old fixed floor
            width = max(int(k), 64)
        else:
            width = int(np.ceil(self.ewma * self.headroom))
        width = max(width, int(k), self.floor)
        width = 1 << max(int(width - 1).bit_length(), 0)   # next pow2
        return int(max(min(width, self.ceiling, batch_cols),
                       min(self.floor, batch_cols)))


def mbr_distance_join(driver_boxes: np.ndarray, driven_boxes: np.ndarray,
                      dist_norm: float, backend: str = "numpy",
                      stats: JoinStats | None = None,
                      device: torch.device | str | None = None
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Candidate pairs (i, j) with box_min_dist <= dist (normalized space).

    The "kernel" and "fused" backends run on `device`."""
    if len(driver_boxes) == 0 or len(driven_boxes) == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    if backend == "fused":
        # pure-distance use of the streaming kernel: zero keys, θ = -inf.
        # With nothing to prune this does MORE work than the matrix paths —
        # it exists for drop-in equivalence (tests, ablations); the perf
        # path is fused_stream_join with real keys via the executor.
        pi, pj = [], []
        for bi, bj in fused_stream_join(
                driver_boxes, driven_boxes,
                np.zeros(len(driver_boxes)), np.zeros(len(driven_boxes)),
                dist_norm, k=64, stats=stats, device=device):
            pi.append(bi)
            pj.append(bj)
        i = np.concatenate(pi) if pi else np.empty(0, np.int64)
        j = np.concatenate(pj) if pj else np.empty(0, np.int64)
        order = np.lexsort((j, i))      # match the dense row-major order
        return i[order], j[order]
    if backend == "kernel":
        i, j = ops.distance_join_pairs(driver_boxes, driven_boxes,
                                       np.float32(dist_norm), device)
    else:
        d = geometry.box_min_dist(driver_boxes[:, None, :],
                                  driven_boxes[None, :, :])
        i, j = np.nonzero(d <= dist_norm)
    if stats is not None:
        stats.pairs_tested += len(driver_boxes) * len(driven_boxes)
        stats.candidates += len(i)
    return i.astype(np.int64), j.astype(np.int64)


def _f32_on(x: np.ndarray, device: torch.device | str | None) -> torch.Tensor:
    """Host array -> contiguous f32 tensor on the kernels' device, for
    the fused join."""
    if device is None:
        raise ValueError("a kernel backend needs a device")
    return ops.upload(np.ascontiguousarray(x, dtype=np.float32), device,
                      "fused_topk_join")


def _sanitize_keys(keys: np.ndarray, n: int) -> np.ndarray:
    """Per-entity score-key upper bounds as f32; NaN (no value -> the row can
    never produce a scored result) maps to -inf so the kernel drops it.

    Engine score keys are f64; round-to-nearest f32 conversion may round a
    bound *below* the true key, which would make θ pruning unsound. Nudge
    any rounded-down value one ulp toward +inf so the f32 bound stays a true
    upper bound (false survivors are harmless — scoring decides).
    """
    if keys is None:
        return np.zeros(n, dtype=np.float32)
    keys64 = np.asarray(keys, dtype=np.float64)
    k32 = keys64.astype(np.float32)
    low = k32.astype(np.float64) < keys64
    k32 = np.where(low, np.nextafter(k32, np.float32(np.inf)), k32)
    return np.where(np.isnan(k32), -np.inf, k32).astype(np.float32)


def _theta32_lower(theta: float) -> np.float32:
    """θ as f32 rounded toward -inf: the kernel must never prune with a θ
    above the true f64 threshold."""
    t32 = np.float32(theta)
    if np.isfinite(t32) and float(t32) > theta:
        t32 = np.nextafter(t32, np.float32(-np.inf))
    return t32


def _batch_pairs(idx: np.ndarray, counts: np.ndarray, kcap: int,
                 drv_t: torch.Tensor, row0: int, cols_t: torch.Tensor,
                 col0: int, ds: np.ndarray, vs_sorted: np.ndarray,
                 order: np.ndarray, start: int, dist32: np.float32,
                 theta32: np.float32, stats: JoinStats | None):
    """One query's candidate pairs from one fused launch, sorted by
    (driver row, driven row) in the original arrays' indices.

    idx/counts are this query's rows of the launch's output (its rows start
    at `row0` of `drv_t`, its columns at `col0` of the launch, where the
    kernel's query-id test keeps its survivors), `cols_t` its column span, which begins at position `start` of its key-sorted driven
    side (`vs_sorted`, `order`). Rows whose survivors overflow the width
    are recovered with the same f32 arrays, distance formula and θ the
    kernel used, so they see exactly the kernel's predicate: the distance
    join's pairs of those rows against the span, then the key bound on
    those pairs only, the same f32 add."""
    ok_rows = counts <= kcap
    sel = (idx >= 0) & ok_rows[:, None]
    pi = np.nonzero(sel)[0].astype(np.int64)
    pj_local = idx[sel].astype(np.int64) - col0
    over = np.flatnonzero(~ok_rows)
    if len(over):
        if stats is not None:
            stats.overflow_rows += len(over)
            stats.overflow_batches += 1
        over_t = ops.upload(over + row0, drv_t.device, "distance_join")
        oi, oj = ops.distance_join_pairs(drv_t.index_select(0, over_t),
                                         cols_t, dist32)
        keep = ds[over][oi] + vs_sorted[start + oj] > theta32
        pi = np.concatenate([pi, over[oi[keep]]])
        pj_local = np.concatenate([pj_local, oj[keep]])
    if len(pi) == 0:
        return pi, pi
    pj = order[start + pj_local]
    srt = np.lexsort((pj, pi))
    pi, pj = pi[srt], pj[srt]
    if stats is not None:
        stats.candidates += len(pi)
    return pi, pj


def fused_stream_join(driver_boxes: np.ndarray, driven_boxes: np.ndarray,
                      driver_keys: np.ndarray, driven_keys: np.ndarray,
                      dist_norm: float, k: int,
                      theta_fn=None, batch_cols: int = 4096,
                      stats: JoinStats | None = None,
                      tuner: KcapTuner | None = None,
                      device: torch.device | str | None = None):
    """Streaming Phase-3 join on `device`: yields (pi, pj) candidate batches.

    Driven entities are processed in descending score-key order, one
    `batch_cols`-wide column batch per fused-kernel call, so:

    - `theta_fn()` (the shared TopK threshold) is re-read before every batch
      and passed to the kernel — results the caller pushes between batches
      tighten the filter mid-block;
    - once ``max(driver_keys) + driven_keys[next] <= θ`` no later pair can
      enter the top-k (keys are sorted), and the scan stops — the paper's
      early termination applied *inside* a block;
    - peak intermediate memory is O(M * batch_cols), independent of N.

    The kernel emits fixed-width (M, k) per-row partials plus exact survivor
    counts; rows whose survivors overflow the width are recovered through
    the distance-join kernel (only those rows, only this batch), which
    computes the fused kernel's f32 distance bit-for-bit, so the candidate
    set stays exactly equal to the matrix backends'. Pairs are
    (driver row, driven row) indices into the *original* (unsorted) arrays.
    """
    m, n = len(driver_boxes), len(driven_boxes)
    if m == 0 or n == 0:
        return
    ds = _sanitize_keys(driver_keys, m)
    vs = _sanitize_keys(driven_keys, n)
    ds_max = float(ds.max()) if m else -np.inf
    order = np.argsort(-vs, kind="stable")
    vs_sorted = vs[order]
    drv_t = _f32_on(driver_boxes, device)
    dvn_t = _f32_on(driven_boxes[order], device)
    ds_t = ops.upload(ds, device, "fused_topk_join")
    vs_t = ops.upload(vs_sorted, device, "fused_topk_join")
    dist32 = np.float32(dist_norm)
    dist_t = torch.full((m,), float(dist32), dtype=torch.float32,
                        device=device)

    for start in range(0, n, batch_cols):
        theta = float(theta_fn()) if theta_fn is not None else -np.inf
        # early termination inside the block: the best remaining pair bound
        # cannot beat theta, and keys only decrease from here
        if ds_max + float(vs_sorted[start]) <= theta:
            break
        # partial width: autotuned from observed survivor counts when a
        # tuner is threaded through; otherwise the fixed floor above k
        # keeps the (rare but expensive) dense overflow recovery off the
        # common path when θ is still loose
        kcap = (tuner.suggest(int(k), batch_cols) if tuner is not None
                else min(max(int(k), 64), batch_cols))
        theta32 = _theta32_lower(theta)
        stop = min(start + batch_cols, n)
        chunk, ck = dvn_t[start:stop], vs_t[start:stop]
        _, idx_t, counts_t = ops.fused_topk_join(
            drv_t, chunk, ds_t, ck, dist_t,
            torch.full((m,), float(theta32), dtype=torch.float32,
                       device=device), k=kcap)
        idx = idx_t.cpu().numpy()
        counts = counts_t.cpu().numpy()
        if tuner is not None:
            tuner.update(counts)
        if stats is not None:
            stats.pairs_tested += m * (stop - start)

        pi, pj = _batch_pairs(idx, counts, kcap, drv_t, 0, chunk, 0, ds,
                              vs_sorted, order, start, dist32, theta32, stats)
        if len(pi):
            yield pi, pj


@dataclasses.dataclass
class StreamEntry:
    """One query's Phase-3 work registered with fused_stream_join_multi.

    `emit(pi, pj)` receives candidate-pair batches (indices into the
    original driver/driven arrays) and is expected to refine + push them
    into the query's TopK so the next `theta_fn()` read is tighter.

    `error` is the crash-isolation channel: an exception in one entry's
    per-span work (overflow recovery, emit/refine) lands here and retires
    only that entry from subsequent launches — the other entries' streams
    proceed. A faulted entry's TopK may hold a partial batch, so the owner
    must restart the query from a fresh cursor, not resume it.
    """
    driver_boxes: np.ndarray
    driven_boxes: np.ndarray
    driver_keys: np.ndarray
    driven_keys: np.ndarray
    dist_norm: float
    k: int
    theta_fn: object                  # () -> float, the query's live θ
    emit: object                      # (pi, pj) -> None
    stats: JoinStats | None = None
    error: Exception | None = None    # set ⟹ entry retired by a fault


class _StreamCursor:
    """One entry's key-sorted driven side and its position in it."""

    def __init__(self, e: StreamEntry):
        self.e = e
        self.m = len(e.driver_boxes)
        self.n = len(e.driven_boxes)
        self.ds = _sanitize_keys(e.driver_keys, self.m)
        vs = _sanitize_keys(e.driven_keys, self.n)
        self.ds_max = float(self.ds.max()) if self.m else -np.inf
        self.order = np.argsort(-vs, kind="stable")
        self.dvn = np.ascontiguousarray(e.driven_boxes[self.order],
                                        dtype=np.float32)
        self.vs = vs[self.order]
        self.drv = np.ascontiguousarray(e.driver_boxes, dtype=np.float32)
        self.pos = 0

    def live(self) -> bool:
        if self.e.error is not None:
            return False
        if self.m == 0 or self.pos >= self.n:
            return False
        theta = float(self.e.theta_fn())
        return self.ds_max + float(self.vs[self.pos]) > theta


def fused_stream_join_multi(entries: list[StreamEntry],
                            batch_cols: int = 4096,
                            tuner: KcapTuner | None = None,
                            device: torch.device | str | None = None) -> int:
    """Cross-query streaming Phase-3 join on `device`: several queries'
    driver blocks in ONE fused-kernel launch at a time.

    Each entry is the per-query state fused_stream_join would process alone;
    here the driver rows of all live entries are concatenated (tagged with a
    per-row query id, distance threshold, and θ) and each launch takes the
    next ≈ batch_cols / n_live columns from EVERY live entry's key-sorted
    driven side. The kernel's query-id test keeps pairs within their query,
    so per-query results equal fused_stream_join's run alone: same column
    order, same θ reads at batch granularity, same overflow recovery per
    (query, batch), through the distance-join kernel as there.

    Entries retire independently — when a query's remaining key bound cannot
    beat its θ (or its columns are exhausted) its rows leave the launch and
    the survivors' column share grows. A launch holds exactly the live rows
    and columns: with no compiled signatures to reuse there is nothing to
    pad to. Returns the number of kernel launches.
    """
    if device is None:          # as `_f32_on`: no silent CPU launches
        raise ValueError("a kernel backend needs a device")
    curs = [_StreamCursor(e) for e in entries]
    launches = 0
    while True:
        live = [c for c in curs if c.live()]
        if not live:
            break
        cols_per = max(1, batch_cols // len(live))
        kmax = max(int(c.e.k) for c in live)
        kcap = (tuner.suggest(kmax, batch_cols) if tuner is not None
                else min(max(kmax, 64), batch_cols))
        # pow2-quantized as the reference does, so a retiring entry
        # (shrinking kmax) moves the width a class at a time
        kcap = min(1 << max(int(kcap - 1).bit_length(), 0), batch_cols)
        # assemble the launch: driver rows / driven columns of every live
        # query, tagged with qid + per-row (dist, θ)
        drv_l, ds_l, rq_l, dist_l, th_l = [], [], [], [], []
        col_l, ck_l, cq_l = [], [], []
        spans = []                       # (cur, row_off, col_off, ncols, θ32)
        row_off = col_off = 0
        for qid, c in enumerate(live):
            ncols = min(cols_per, c.n - c.pos)
            theta32 = _theta32_lower(float(c.e.theta_fn()))
            drv_l.append(c.drv)
            ds_l.append(c.ds)
            rq_l.append(np.full(c.m, qid, np.int32))
            dist_l.append(np.full(c.m, np.float32(c.e.dist_norm)))
            th_l.append(np.full(c.m, theta32))
            col_l.append(c.dvn[c.pos:c.pos + ncols])
            ck_l.append(c.vs[c.pos:c.pos + ncols])
            cq_l.append(np.full(ncols, qid, np.int32))
            spans.append((c, row_off, col_off, ncols, theta32))
            row_off += c.m
            col_off += ncols
        try:
            drv_t, cols_t, ds_t, ck_t, dist_t, th_t, rq_t, cq_t = (
                ops.upload(np.concatenate(x), device, "fused_topk_join")
                for x in (drv_l, col_l, ds_l, ck_l, dist_l, th_l, rq_l, cq_l))
            _, idx_t, counts_t = ops.fused_topk_join(
                drv_t, cols_t, ds_t, ck_t, dist_t, th_t, k=kcap,
                row_qid=rq_t, col_qid=cq_t)
            idx = idx_t.cpu().numpy()
            counts = counts_t.cpu().numpy()
        except Exception as exc:    # noqa: BLE001 — whole-launch failure
            # the shared launch died: every rider faults (their owners
            # restart from fresh cursors); entries not in it are untouched
            for c, *_ in spans:
                c.e.error = exc
            continue
        launches += 1
        if tuner is not None:
            tuner.update(counts)
        for c, r0, c0, ncols, theta32 in spans:
            e = c.e
            try:
                if e.stats is not None:
                    e.stats.pairs_tested += c.m * ncols
                pi, pj = _batch_pairs(
                    idx[r0:r0 + c.m], counts[r0:r0 + c.m], kcap, drv_t, r0,
                    cols_t[c0:c0 + ncols], c0, c.ds, c.vs, c.order, c.pos,
                    np.float32(e.dist_norm), theta32, e.stats)
                if len(pi):
                    e.emit(pi, pj)
            except Exception as exc:    # noqa: BLE001 — per-entry isolation
                # one entry's overflow recovery / emit / refine crashed:
                # retire it (owner restarts it) and keep the others going
                e.error = exc
            c.pos += ncols
    return launches


def fused_topk_pairs(driver_boxes: np.ndarray, driven_boxes: np.ndarray,
                     driver_keys: np.ndarray, driven_keys: np.ndarray,
                     dist_norm: float, k: int, theta: float = -np.inf,
                     batch_cols: int = 4096,
                     device: torch.device | str | None = None
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Global per-row top-k of the fused join, without densifying.

    Runs the streaming kernel batch by batch on `device` and absorbs the
    per-batch (M, k) partials through topk.merge_row_partials (the
    two-level merge: tiles fold in-kernel, batches fold here). Returns
    (scores (M, k), idx (M, k) into the original driven array), -inf/-1
    padded.
    """
    m, n = len(driver_boxes), len(driven_boxes)
    ds = _sanitize_keys(driver_keys, m)
    vs = _sanitize_keys(driven_keys, n)
    kcap = max(int(k), 1)
    theta32 = _theta32_lower(float(theta))
    drv_t = _f32_on(driver_boxes, device)
    ds_t = ops.upload(ds, device, "fused_topk_join")
    dist_t = torch.full((m,), float(np.float32(dist_norm)),
                        dtype=torch.float32, device=device)
    theta_t = torch.full((m,), float(theta32), dtype=torch.float32,
                         device=device)
    parts = []
    for start in range(0, n, batch_cols):
        scores, idx, _ = ops.fused_topk_join(
            drv_t, _f32_on(driven_boxes[start:start + batch_cols], device),
            ds_t, ops.upload(vs[start:start + batch_cols], device,
                             "fused_topk_join"),
            dist_t, theta_t, k=kcap)
        idx = idx.cpu().numpy().astype(np.int64)
        parts.append((scores.cpu().numpy(),
                      np.where(idx >= 0, idx + start, -1)))
    if not parts:
        return (np.full((m, kcap), -np.inf, np.float32),
                np.full((m, kcap), -1, np.int64))
    return topk_mod.merge_row_partials(parts, kcap)


# ---------------------------------------------------------------------------
# Exact-geometry refinement on the CSR pool (paper §3.2.4), bucketed kernel
# ---------------------------------------------------------------------------

REFINE_MAX_PTS = 128        # size-class cap; larger geometries are fragmented


def _size_class(n: np.ndarray) -> np.ndarray:
    """Next power of two >= n (n in [1, REFINE_MAX_PTS])."""
    return (1 << np.ceil(np.log2(np.maximum(n, 1))).astype(np.int64)) \
        .astype(np.int64)


def core_to_dist(core: np.ndarray, metric: str) -> np.ndarray:
    """Metric *core* minima -> distances, in float64 numpy.

    The bucketed kernel reduces the metric core — squared euclid distance,
    or squared unit-sphere chord (= 4·haversine-h) — both monotone in the
    true distance, so the transform commutes with the min and runs once per
    pair here, in f64 numpy (a device f32 ``asin`` would not be exact at 0:
    a self-distance would not come back as 0).
    """
    core = np.asarray(core, dtype=np.float64)
    if metric == "haversine":
        return (2.0 * geometry.EARTH_RADIUS_KM
                * np.arcsin(np.clip(np.sqrt(core) * 0.5, 0.0, 1.0)))
    return np.sqrt(core)


def pool_min_dist(pool, rows_a: np.ndarray, rows_b: np.ndarray,
                  metric: str = "euclid",
                  device: torch.device | str | None = None,
                  max_pts: int = REFINE_MAX_PTS) -> np.ndarray:
    """Exact min distance per (rows_a[t], rows_b[t]) geometry-pool row pair.

    Pairs are grouped by padded (m_pad, n_pad) size class (next power of two
    per side), each bucket is gathered from the CSR pool's coordinate planes
    — raw x/y for euclid, unit-sphere X/Y/Z for haversine (chord² = 4h, trig
    hoisted to pool build) — into dense (B, m_pad) / (B, n_pad) tiles,
    padding replicating the entity's last point (which can never change a
    min), all packed into one buffer, and one `ops.bucketed_min_core_group`
    call on `device` computes every bucket's pairwise minima (one upload,
    one launch, one copy back). Geometries wider than `max_pts` are
    fragmented into <= max_pts chunks on both sides (min distance decomposes
    over point subsets) and min-scattered back. Returns (n_pairs,) float64
    distances (f32 cores, f64 final transform).
    """
    npairs = len(rows_a)
    out = np.full(npairs, np.inf, dtype=np.float32)
    if npairs == 0:
        return out
    rows_a = np.asarray(rows_a, dtype=np.int64)
    rows_b = np.asarray(rows_b, dtype=np.int64)
    off = pool.offsets
    cnt_a, cnt_b = pool.counts(rows_a), pool.counts(rows_b)
    na, nb = -(-cnt_a // max_pts), -(-cnt_b // max_pts)
    frags = na * nb
    if int(frags.max()) == 1:           # common case: no fragmentation
        pair_idx = np.arange(npairs, dtype=np.int64)
        start_a, len_a = off[rows_a], cnt_a
        start_b, len_b = off[rows_b], cnt_b
    else:
        pair_idx = np.repeat(np.arange(npairs, dtype=np.int64), frags)
        base = np.repeat(np.cumsum(frags) - frags, frags)
        local = np.arange(int(frags.sum()), dtype=np.int64) - base
        nb_r = nb[pair_idx]
        ca, cb = local // nb_r, local % nb_r
        start_a = off[rows_a][pair_idx] + ca * max_pts
        len_a = np.minimum(cnt_a[pair_idx] - ca * max_pts, max_pts)
        start_b = off[rows_b][pair_idx] + cb * max_pts
        len_b = np.minimum(cnt_b[pair_idx] - cb * max_pts, max_pts)
    cls_a, cls_b = _size_class(len_a), _size_class(len_b)
    planes = pool.planes3d() if metric == "haversine" else pool.planes2d()
    key = cls_a * (2 * max_pts) + cls_b
    sels = [np.flatnonzero(key == kk) for kk in np.unique(key)]
    group = ops.min_core_group(len(planes), [
        (len(sel), int(cls_a[sel[0]]), int(cls_b[sel[0]])) for sel in sels])
    buf = group.pack()
    for g, sel in enumerate(sels):
        va, vb = group.planes(buf, g)
        # clamped gather: index min(arange, len-1) replicates the last point
        ia = start_a[sel, None] + np.minimum(np.arange(va.shape[2])[None, :],
                                             (len_a[sel] - 1)[:, None])
        ib = start_b[sel, None] + np.minimum(np.arange(vb.shape[2])[None, :],
                                             (len_b[sel] - 1)[:, None])
        for d, p in enumerate(planes):
            va[d], vb[d] = p[ia], p[ib]
    # every bucket in one upload, one launch and one copy back
    core = ops.bucketed_min_core_group(
        ops.upload(buf, device, "bucketed_min_core"), group).cpu().numpy()
    for g, sel in enumerate(sels):
        np.minimum.at(out, pair_idx[sel], core[group.rows(g)])
    return core_to_dist(out, metric)


def refine(pairs_i: np.ndarray, pairs_j: np.ndarray,
           pool, rows_a: np.ndarray, rows_b: np.ndarray,
           dist_world: float, metric: str = "euclid",
           stats: JoinStats | None = None,
           device: torch.device | str | None = None) -> np.ndarray:
    """Exact-representation distance validation (paper §3.2.4), vectorized.

    rows_a / rows_b are geometry-pool rows per candidate pair (from
    ``store.geom_rows(ents[pairs_i])`` etc.). Returns a boolean keep mask.
    """
    d = pool_min_dist(pool, rows_a, rows_b, metric, device)
    # f64 compare: the threshold stays un-rounded (a f32-rounded threshold
    # could drop true survivors)
    keep = d <= float(dist_world)
    if stats is not None:
        stats.refined += int(keep.sum())
    return keep


def exact_pair_distance(pool, rows_a: np.ndarray, rows_b: np.ndarray,
                        metric: str = "euclid",
                        device: torch.device | str | None = None
                        ) -> np.ndarray:
    """Exact min distance per candidate pair, on the bucketed kernel path
    on `device` (the query shapes' Phase-3 scoring)."""
    return pool_min_dist(pool, rows_a, rows_b, metric, device)


def _pool_gather(pool, rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(point indices, owning row segment) for the given pool rows."""
    rows = np.asarray(rows, dtype=np.int64)
    cnt = pool.counts(rows)
    idx = csr_gather(pool.offsets[rows], cnt)
    seg = np.repeat(np.arange(len(rows), dtype=np.int64), cnt)
    return idx, seg


def pool_points_in_box(pool, rows: np.ndarray, box) -> np.ndarray:
    """Per pool row: does any exact point lie inside the CLOSED world box?

    ``box`` is (xmin, ymin, xmax, ymax) in world units. The boundary counts
    (consistent with `geometry.boxes_intersect`), and a zero-area box still
    matches coincident points exactly. Exact — no MBR approximation.
    """
    rows = np.asarray(rows, dtype=np.int64)
    out = np.zeros(len(rows), dtype=bool)
    if len(rows) == 0:
        return out
    idx, seg = _pool_gather(pool, rows)
    x = pool.points[idx, 0].astype(np.float64)
    y = pool.points[idx, 1].astype(np.float64)
    xmin, ymin, xmax, ymax = (float(box[0]), float(box[1]),
                              float(box[2]), float(box[3]))
    inb = (x >= xmin) & (x <= xmax) & (y >= ymin) & (y <= ymax)
    np.logical_or.at(out, seg, inb)
    return out


def pool_point_min_dist(pool, rows: np.ndarray, point,
                        metric: str = "euclid") -> np.ndarray:
    """Exact min distance from each pool row's point set to a world point.

    f64 throughout (over the pool's f32 coordinates), so coincident points
    come back as exactly 0.0 — the within-distance selection shape scores
    with this routine.
    """
    rows = np.asarray(rows, dtype=np.int64)
    out = np.full(len(rows), np.inf, dtype=np.float64)
    if len(rows) == 0:
        return out
    idx, seg = _pool_gather(pool, rows)
    pts = pool.points[idx].astype(np.float64)
    p = np.asarray(point, dtype=np.float64)
    dist_fn = (geometry.haversine_km if metric == "haversine"
               else geometry.euclid_dist)
    d = dist_fn(pts, p[None, :])
    np.minimum.at(out, seg, d)
    return out
