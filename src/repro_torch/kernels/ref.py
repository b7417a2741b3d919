"""Plain PyTorch versions of the port's CUDA kernels.

Each function here computes exactly what its kernel in `csrc/` computes, with
the same f32 operation order and no fused multiply-add, so on the same inputs
the two agree bit-for-bit. `kernels/ops.py` runs these for tensors that lie
on the CPU; the tests and `chip_smoke.py` hold each kernel against them.
"""
from __future__ import annotations

import torch


# ----------------------------------------------------------- distance join --
def distance_join_ref(driver: torch.Tensor, driven: torch.Tensor
                      ) -> torch.Tensor:
    """Pairwise min distance between boxes. driver (M, 4), driven (N, 4)
    f32 -> (M, N) f32 (0 where boxes intersect), unfused:
    ``v = dx*dx; v = v + dy*dy; sqrt(v)``, each step rounded to f32."""
    a = driver[:, None, :]
    b = driven[None, :, :]
    zero = torch.zeros((), dtype=torch.float32, device=driver.device)
    dx = torch.maximum(zero, torch.maximum(a[..., 0] - b[..., 2],
                                           b[..., 0] - a[..., 2]))
    dy = torch.maximum(zero, torch.maximum(a[..., 1] - b[..., 3],
                                           b[..., 1] - a[..., 3]))
    v = dx * dx
    v = v + dy * dy
    # torch's vectorized f32 sqrt on the CPU is not correctly rounded (it
    # differs from IEEE sqrt on about 0.6% of inputs); the f64 sqrt rounded
    # once to f32 is, on every device, as the kernel's __fsqrt_rn is
    return torch.sqrt(v.double()).float()


def distance_join_pairs_ref(driver: torch.Tensor, driven: torch.Tensor,
                            dist: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-major candidate pairs of the distance matrix: int64 (i, j) with
    ``distance_join_ref(driver, driven)[i, j] <= dist``, dist rounded to f32
    (NaN distances never pass)."""
    d = distance_join_ref(driver, driven)
    limit = torch.tensor(dist, dtype=torch.float32, device=d.device)
    return torch.nonzero(d <= limit, as_tuple=True)


# ------------------------------------------------- fused top-k distance join --
def fused_topk_join_ref(driver: torch.Tensor, driven: torch.Tensor,
                        driver_keys: torch.Tensor, driven_keys: torch.Tensor,
                        dist: torch.Tensor, theta: torch.Tensor,
                        row_qid: torch.Tensor, col_qid: torch.Tensor, k: int
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense version of the fused kernel.

    Pair (i, j) survives iff ``dist_ij <= dist[i]`` and ``driver_keys[i] +
    driven_keys[j] > theta[i]`` and ``row_qid[i] == col_qid[j]``. Per row:
    the k best survivors by key bound, ties to the lowest column, padded
    with -inf / -1, plus the total survivor count. Returns (scores (M, k)
    f32, idx (M, k) int32, counts (M,) int32).
    """
    d = distance_join_ref(driver, driven)
    bound = driver_keys[:, None] + driven_keys[None, :]
    valid = ((d <= dist[:, None]) & (bound > theta[:, None])
             & (row_qid[:, None] == col_qid[None, :]))
    m, n = d.shape
    s = torch.where(valid, bound,
                    torch.full((), float("-inf"), device=d.device))
    # stable descending sort: equal bounds keep column order (lowest first)
    top_s, pos = torch.sort(s, dim=1, descending=True, stable=True)
    kk = min(k, n)
    top_s = top_s[:, :kk]
    top_i = torch.where(top_s == float("-inf"), -1, pos[:, :kk]
                        ).to(torch.int32)
    out_s = torch.full((m, k), float("-inf"), dtype=torch.float32,
                       device=d.device)
    out_i = torch.full((m, k), -1, dtype=torch.int32, device=d.device)
    out_s[:, :kk] = top_s
    out_i[:, :kk] = top_i
    return out_s, out_i, valid.sum(dim=1, dtype=torch.int32)


# ------------------------------------------- bucketed geometry refinement --
def bucketed_min_core_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-row min over point pairs of ``sum_d (a_d - b_d)²``.

    a (dims, B, m_pad), b (dims, B, n_pad) f32 coordinate planes whose
    padding replicates real points. The sum runs ``v = d0*d0; v = v +
    d1*d1 [; v = v + d2*d2]`` with every step rounded. Returns (B,) f32.
    """
    dims, nb, m_pad = a.shape
    best = torch.full((nb,), float("inf"), dtype=torch.float32,
                      device=a.device)
    for i in range(m_pad):
        v = None
        for dd in range(dims):
            diff = a[dd, :, i:i + 1] - b[dd]               # (B, n_pad)
            v = diff * diff if v is None else v + diff * diff
        best = torch.minimum(best, v.min(dim=1).values)
    return best


def bucketed_min_core_group_ref(buf: torch.Tensor, desc, dims: int
                                ) -> torch.Tensor:
    """The grouped refinement call: `bucketed_min_core_ref` bucket by
    bucket over a packed buffer (the descriptor table's `desc.size` words,
    then the planes; see ops.MinCoreGroup). desc (G, 8) int32 rows of
    (a_off, b_off, out_off, rows, m_pad, n_pad, ...). Returns the cores,
    bucket after bucket."""
    planes = buf[desc.size:]
    outs = []
    for a_off, b_off, _, nb, m_pad, n_pad, *_ in desc.tolist():
        a = planes[a_off:a_off + dims * nb * m_pad].reshape(dims, nb, m_pad)
        b = planes[b_off:b_off + dims * nb * n_pad].reshape(dims, nb, n_pad)
        outs.append(bucketed_min_core_ref(a, b))
    return torch.cat(outs) if outs else planes.new_empty(0)


# ------------------------------------------------------------ tree descent --
def tree_descend_ref(node_keys: torch.Tensor, cs_path: torch.Tensor,
                     box_keys: torch.Tensor) -> torch.Tensor:
    """Candidate-node masks: ``in[b, n] = any_m hit(b, m, n) & cs_path[n]``.

    node_keys (4, N) int64 sort keys of the node MBRs (rows x0, y0, x2, y3);
    cs_path (N,) bool; box_keys (B, M, 4) int64 keys of the expanded driver
    boxes. A hit is the closed interval test on the keys. Returns (B, N)
    bool.
    """
    nx0, ny0, nx2, ny3 = (node_keys[c][None, :] for c in range(4))
    out = torch.empty((box_keys.shape[0], node_keys.shape[1]),
                      dtype=torch.bool, device=node_keys.device)
    for bi in range(box_keys.shape[0]):
        bx = box_keys[bi]
        hit = ((nx0 <= bx[:, 2:3]) & (bx[:, 0:1] <= nx2)
               & (ny0 <= bx[:, 3:4]) & (bx[:, 1:2] <= ny3))
        out[bi] = hit.any(dim=0) & cs_path
    return out


def tree_descend_sharded_ref(node_keys: torch.Tensor, cs_path: torch.Tensor,
                             box_keys: torch.Tensor) -> torch.Tensor:
    """Candidate-node masks of every shard against shared boxes: node_keys
    (S, 4, N) stacked key planes (pad columns never hit), cs_path (S, N)
    bool, box_keys (B, M, 4) int64 -> (S, B, N) bool, `tree_descend_ref`
    per shard."""
    return torch.stack([tree_descend_ref(node_keys[i], cs_path[i], box_keys)
                        for i in range(node_keys.shape[0])])


# ------------------------------------------------------------ bloom probe --
_M32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor, seed: int) -> torch.Tensor:
    """The 32-bit murmur3 finalizer of `core/charsets.mix32` on int64
    tensors holding uint32 values. torch's CPU uint32 has no shift, add or
    modulo, so every add and multiply runs in int64 and is masked back to
    32 bits: the low 32 bits of a wrapped int64 product are exact."""
    x = (x + ((0x9E3779B9 * (seed + 1)) & _M32)) & _M32
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & _M32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & _M32
    return x ^ (x >> 16)


def bloom_positions(keys: torch.Tensor, k: int, nbits: int) -> torch.Tensor:
    """(B, k) int64 bit positions ``(h1 + i*h2) mod nbits`` of int64 keys,
    with ``h1 = hash32(key, 0)`` and ``h2 = hash32(key, 1) | 1`` and the
    sum wrapped to 32 bits, as `core/charsets.BloomBank` places them."""
    lo = keys & _M32
    hi = (keys >> 32) & _M32
    h1 = _mix32(lo ^ _mix32(hi, 7), 0)
    h2 = _mix32(lo ^ _mix32(hi, 8), 1) | 1
    i = torch.arange(k, dtype=torch.int64, device=keys.device)
    return ((h1[:, None] + i[None, :] * h2[:, None]) & _M32) % nbits


def bloom_probe_ref(bits: torch.Tensor, keys: torch.Tensor, k: int
                    ) -> torch.Tensor:
    """Bloom membership of keys[b] in the pre-gathered filter row bits[b].

    bits (B, W) int32 or uint32 words (the uint32 bit patterns), keys (B,)
    int64. Returns (B,) bool: all k double-hashed bits set."""
    words = bits.view(torch.int32).to(torch.int64) & _M32
    pos = bloom_positions(keys, k, words.shape[1] * 32)
    word = torch.gather(words, 1, pos // 32)
    return ((word >> (pos % 32)) & 1).bool().all(dim=1)


def bloom_probe_any_ref(bits: torch.Tensor, filter_idx: torch.Tensor,
                        keys: torch.Tensor, k: int) -> torch.Tensor:
    """Per filter of a bank, ANY of a key set a member: bits (n_filters, W)
    int32 or uint32 words, filter_idx (F,) int64 rows of the bank, keys (C,)
    int64. The rows gathered F x C, probed by `bloom_probe_ref`, reduced
    over the keys. Returns (F,) bool."""
    f, c = filter_idx.shape[0], keys.shape[0]
    rows = bits.view(torch.int32)[filter_idx.repeat_interleave(c)]
    return bloom_probe_ref(rows, keys.repeat(f), k).reshape(f, c).any(dim=1)


# --------------------------------------------------- merge-join rank pass --
def merge_join_ranks_ref(table: torch.Tensor, probes: torch.Tensor,
                         side: str = "both"):
    """Insertion ranks of int64 probes in the sorted int64 table:
    ``lo = #{table < p}`` (side "left"), ``hi = #{table <= p}`` (side
    "right"); side "both" returns (lo, hi). int64 (M,) outputs."""
    if side == "left":
        return torch.searchsorted(table, probes, side="left")
    if side == "right":
        return torch.searchsorted(table, probes, side="right")
    return (torch.searchsorted(table, probes, side="left"),
            torch.searchsorted(table, probes, side="right"))


# -------------------------------------------------------------- block scan --
def block_scan_ref(scores: torch.Tensor, theta: float
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(nb, B) f32 scores -> (row max f32 (nb,), count of scores > theta
    int32 (nb,), survivor mask uint8 (nb, B)); theta is rounded to f32."""
    mask = scores > torch.tensor(theta, dtype=torch.float32)
    return (scores.max(dim=1).values, mask.sum(dim=1, dtype=torch.int32),
            mask.to(torch.uint8))


# ------------------------------------------------------------------ morton --
def _spread16(v: torch.Tensor) -> torch.Tensor:
    v = v & 0xFFFF
    v = (v | (v << 8)) & 0x00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F
    v = (v | (v << 2)) & 0x33333333
    return (v | (v << 1)) & 0x55555555


def morton_ref(cx: torch.Tensor, cy: torch.Tensor) -> torch.Tensor:
    """Interleave the low 16 bits of int32 cx, cy into int32 Morton codes.

    torch has no uint32 shifts on the CPU, so the spread runs in int64 (every
    intermediate stays below 2^32), and codes at or above 2^31 are mapped to
    their negative int32 bit pattern explicitly."""
    code = _spread16(cx.to(torch.int64)) | (_spread16(cy.to(torch.int64)) << 1)
    code = torch.where(code >= 1 << 31, code - (1 << 32), code)
    return code.to(torch.int32)


# --------------------------------------------------------- flash attention --
def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """GQA attention. q (B, Hq, S, D); k, v (B, Hkv, S, D), Hq % Hkv == 0.

    K/V repeated over each group of Hq / Hkv query heads, f32 logits scaled
    by D^-0.5, causal entries above the diagonal at -inf, softmax and the
    weighted sum in f32, cast to q's dtype."""
    s, d = q.shape[2], q.shape[3]
    g = q.shape[1] // k.shape[1]
    kk = k.repeat_interleave(g, dim=1).float()
    vv = v.repeat_interleave(g, dim=1).float()
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * d ** -0.5
    if causal:
        keep = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, float("-inf"))
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, vv).to(q.dtype)
