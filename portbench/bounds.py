"""The least time each STREAK kernel's calls need, and their recording.

The bound arithmetic is chip_smoke.py's (`bound_ms`, `pairs_bound`,
`fused_bound`, `min_core_bound`, `any_bound`, `rank_words_touched` with the
rank bound of `check_merge_join_ranks`, `descend_tests` with the bound of
`descend_replays`), frozen here and counted from what a call needs, not
from what the kernel pads: each input byte the call needs read once, each
output byte written once, the operations of the rows and points it must
test. Differences from chip_smoke.py:

- `fused_bound` counts the pairs of driver rows and driven columns of the
  same query id, not M x N: a cross-query launch tests no other pair;
- `min_core_bound` counts each pair's real point counts, not the packed
  buffer's padded size classes (`group.n_floats`), so a repacking cannot
  move it;
- `descend_tests` and the descent's bytes leave out padding rows
  (`DESCEND_PAD_BOX`);
- `any_bound`'s Bloom positions are hashed here with NumPy.

`KernelRecorder` wraps the program's kernel entry points for a traced
window and keeps what each launching call needs for its bound; `bounds()`
works the bounds out once the window has closed.
"""
from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet (dense, at its 700 W limit): HBM3 bytes/s and
# float32 operations/s outside the tensor cores (integer work counted at
# the same rate)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

STREAK_KERNELS = ("fused_topk_join", "distance_join", "bucketed_min_core",
                  "tree_descend", "bloom_probe", "merge_join_ranks")


def bound_ms(n_bytes: float, n_ops: float) -> float:
    """The larger of bytes over the HBM rate and operations over the f32
    rate, in ms."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S) * 1e3


def pairs_bound(m: int, n: int, pairs: int) -> float:
    """The boxes read once, the pairs (8 bytes each) and a count written
    once; ~15 operations a tested pair (the distance, then the compare)."""
    return bound_ms((m + n) * 16 + pairs * 8 + 8, m * n * 15)


def fused_bound(m: int, n: int, k: int, pairs: int) -> float:
    """Per pair of one query: 12 operations of distance, 1 add, 3
    compares; the inputs read once (32 bytes a driver row, 24 a driven
    column), the (M, k) partials and counts written once."""
    return bound_ms(m * 32 + n * 24 + m * k * 8 + m * 4, pairs * 16)


def min_core_bound(cnt_a: np.ndarray, cnt_b: np.ndarray, dims: int) -> float:
    """Each pair's points read once, a core written once; ~3 operations per
    dimension of a point pair."""
    cnt_a = cnt_a.astype(np.int64)
    cnt_b = cnt_b.astype(np.int64)
    return bound_ms(int((cnt_a + cnt_b).sum()) * dims * 4 + len(cnt_a) * 4,
                    int((cnt_a * cnt_b).sum()) * 3 * dims)


def descend_bound(node_keys, cs, box_keys) -> float:
    """The node planes, root-path masks and real box rows read once, the
    (B, N) masks written once; four compares a box test, for each live
    (b, node) the boxes up to its first hit, all real boxes where none
    hits."""
    import torch
    pad = box_keys[..., 0] == np.iinfo(np.int64).max       # (B, M)
    real = (~pad).sum(1)                                   # (B,)
    n = node_keys.shape[1]
    nb = box_keys.shape[0]
    hit = ((node_keys[0][None, None] <= box_keys[..., 2:3])
           & (box_keys[..., 0:1] <= node_keys[2][None, None])
           & (node_keys[1][None, None] <= box_keys[..., 3:4])
           & (box_keys[..., 1:2] <= node_keys[3][None, None]))   # (B, M, N)
    hit &= ~pad[..., None]
    first = torch.where(hit.any(1), hit.int().argmax(1) + 1, real[:, None])
    tests = int(first[:, cs].sum())
    return bound_ms(4 * n * 8 + n + int(real.sum()) * 32 + nb * n, tests * 4)


_M32 = 0xFFFFFFFF


def _mix32(x: np.ndarray, seed: int) -> np.ndarray:
    """The 32-bit murmur3 finalizer of the Bloom bank's hashing, on uint64
    arrays holding uint32 values."""
    x = (x + np.uint64((0x9E3779B9 * (seed + 1)) & _M32)) & np.uint64(_M32)
    x = x ^ (x >> np.uint64(16))
    x = (x * np.uint64(0x85EBCA6B)) & np.uint64(_M32)
    x = x ^ (x >> np.uint64(13))
    x = (x * np.uint64(0xC2B2AE35)) & np.uint64(_M32)
    return x ^ (x >> np.uint64(16))


def bloom_positions(keys: np.ndarray, k: int, nbits: int) -> np.ndarray:
    """(C, k) bit positions (h1 + i * h2) mod nbits of int64 keys, with
    h1 = mix32(lo ^ mix32(hi, 7), 0), h2 = mix32(lo ^ mix32(hi, 8), 1) | 1,
    the sum wrapped to 32 bits."""
    u = keys.astype(np.int64).view(np.uint64)
    lo, hi = u & np.uint64(_M32), (u >> np.uint64(32)) & np.uint64(_M32)
    h1 = _mix32(lo ^ _mix32(hi, 7), 0)
    h2 = _mix32(lo ^ _mix32(hi, 8), 1) | np.uint64(1)
    i = np.arange(k, dtype=np.uint64)
    return (((h1[:, None] + i[None, :] * h2[:, None]) & np.uint64(_M32))
            % np.uint64(nbits)).astype(np.int64)


def any_bound(bits: np.ndarray, fi: np.ndarray, keys: np.ndarray,
              k: int) -> float:
    """What a per-filter probe needs: the filter indices, the keys and the
    verdicts once, and per filter the words that its tested probes land
    in; ~40 integer operations to hash a key (once), ~7 a probe, for each
    filter's keys up to its first member and each key's probes up to its
    first clear bit."""
    pos = bloom_positions(keys, k, bits.shape[1] * 32)              # (C, k)
    rows = bits[fi].astype(np.int64) & _M32                         # (F, W)
    bit = (rows[:, pos // 32] >> (pos % 32)) & 1                    # (F, C, k)
    clear = bit == 0
    probes = np.where(clear.any(2), clear.argmax(2) + 1, k)
    member = ~clear.any(2)                                          # (F, C)
    keys_tested = np.where(member.any(1), member.argmax(1) + 1, len(keys))
    tested = np.arange(len(keys))[None] < keys_tested[:, None]
    n_probes = int((probes * tested).sum())
    words = len(np.unique(pos // 32))
    return bound_ms(len(fi) * (8 + 1 + words * 4) + len(keys) * 8,
                    len(keys) * 40 + n_probes * 7)


def rank_bound(table: np.ndarray, probes: np.ndarray, side: str) -> float:
    """Probes read and ranks written once, each distinct table word that a
    binary search of these probes reaches read once; ~4 integer operations
    a search step."""
    n, m = len(table), len(probes)
    sides = ("left", "right") if side == "both" else (side,)
    seen = np.zeros(n, dtype=bool)
    step0 = 1 << (n.bit_length() - 1)
    for sd in sides:
        pos = np.zeros(m, dtype=np.int64)
        step = step0
        while step:
            nxt = pos + step
            ok = nxt <= n
            idx = np.minimum(nxt - 1, n - 1)
            seen[idx[ok]] = True
            v = table[idx]
            pred = (v < probes) if sd == "left" else (v <= probes)
            pos = np.where(ok & pred, nxt, pos)
            step >>= 1
    words = int(seen.sum())
    return bound_ms(m * 8 * (1 + len(sides)) + words * 8,
                    len(sides) * m * n.bit_length() * 4)


class KernelRecorder:
    """Wraps the program's six STREAK kernel entry points while installed;
    each call that launched its kernel (`ops.LAUNCHES` moved) leaves what
    its bound needs."""

    def __init__(self):
        self.calls: dict = {k: [] for k in STREAK_KERNELS}
        self._saved: list = []

    def _wrap(self, ops, owner, attr: str, kernel: str, keep):
        fn = getattr(owner, attr)

        def recorded(*args, **kwargs):
            before = ops.LAUNCHES[kernel]
            out = fn(*args, **kwargs)
            if ops.LAUNCHES[kernel] > before:
                self.calls[kernel].append(keep(out, *args, **kwargs))
            return out
        self._saved.append((owner, attr, fn))
        setattr(owner, attr, recorded)

    def install(self) -> None:
        from repro_torch.core import spatial_join
        from repro_torch.kernels import ops

        def ranks(out, table, probes, backend=None, side="both",
                  device=None, table_on_device=None):
            return ("rank", table, probes, side)

        def descend(out, node_keys, cs_path, box_keys):
            return ("descend", node_keys, cs_path, box_keys)

        def bloom(out, bits, fi, keys, k):
            return ("any", bits, np.asarray(fi, np.int64),
                    np.asarray(keys, np.int64), k)

        def fused(out, driver, driven, dk, vk, dist, theta, k,
                  row_qid=None, col_qid=None):
            return ("fused", driver.shape[0], driven.shape[0], k, row_qid,
                    col_qid)

        def pairs(out, driver, driven, dist, device=None):
            return ("ms", pairs_bound(len(driver), len(driven), len(out[0])))

        def min_core(out, pool, rows_a, rows_b, metric="euclid",
                     device=None, **kw):
            dims = 3 if metric == "haversine" else 2
            return ("ms", min_core_bound(pool.counts(rows_a),
                                         pool.counts(rows_b), dims))

        self._wrap(ops, ops, "merge_join_ranks", "merge_join_ranks", ranks)
        self._wrap(ops, ops, "tree_descend", "tree_descend", descend)
        self._wrap(ops, ops, "bloom_probe_any", "bloom_probe", bloom)
        self._wrap(ops, ops, "fused_topk_join", "fused_topk_join", fused)
        self._wrap(ops, ops, "distance_join_pairs", "distance_join", pairs)
        self._wrap(ops, spatial_join, "pool_min_dist", "bucketed_min_core",
                   min_core)

    def remove(self) -> None:
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)
        self._saved = []

    def bounds(self) -> dict:
        """kernel -> (summed bound ms, calls recorded)."""
        import torch
        out = {}
        bits_host: dict = {}
        for kernel, calls in self.calls.items():
            total = 0.0
            for c in calls:
                if c[0] == "ms":
                    total += c[1]
                elif c[0] == "rank":
                    total += rank_bound(np.asarray(c[1], np.int64),
                                        np.asarray(c[2], np.int64), c[3])
                elif c[0] == "descend":
                    total += descend_bound(*c[1:])
                elif c[0] == "any":
                    key = id(c[1])
                    if key not in bits_host:
                        bits_host[key] = (c[1].cpu().numpy()
                                          .view(np.uint32).astype(np.int64))
                    total += any_bound(bits_host[key], c[2], c[3], c[4])
                else:
                    _, m, n, k, rq, cq = c
                    if rq is None or cq is None:
                        pairs = m * n
                    else:
                        nq = int(max(rq.max(), cq.max())) + 1 if m and n \
                            else 0
                        pairs = int((torch.bincount(rq, minlength=nq)
                                     * torch.bincount(cq, minlength=nq))
                                    .sum()) if nq else 0
                    total += fused_bound(m, n, k, pairs)
            out[kernel] = (total, len(calls))
        return out
