"""Kernel wrappers: each launches its CUDA kernel or runs its plain version.

A wrapper takes torch tensors. On CUDA tensors it checks their dtype, shape
and layout, allocates the outputs with `torch.empty`, launches its kernel on
the current stream (built from `csrc/` at first use, see `_build.py`), raises
if the launch fails, and adds one to its count in `LAUNCHES`. On CPU tensors
it runs the kernel's plain torch version from `ref.py`. Tensors on any other
device raise.

The ops the engine calls (`distance_join_pairs`, `fused_topk_join`,
`bucketed_min_core_group`, `merge_join_ranks`, `tree_descend`,
`tree_descend_sharded`, `bloom_probe_any`) run through a failover chain
(`core/fault.run_op`, under the reference's op names, so one `FaultRule`
targets the same stage in both packages): on CUDA the kernel, then the
plain version on the same card; on the CPU the plain version, then the same
function again. A chain moves on only on the fault layer's own failures (an
injected fault, a watchdog timeout, a detected corruption); every other
exception, a failed launch included, propagates. A non-primary attempt
counts in `LAUNCHES` under "<op>:<backend>", never as a kernel launch.

The host-side helpers the kernel paths need (`f64_sort_keys`,
`DESCEND_PAD_BOX`) live here too, and the calls the engine makes with host
arrays in and out, each one C call on CUDA with its inputs and outputs
staged in pinned memory: the rank pass of the relational merge join
(`merge_join_ranks`, against a table kept on the device by `device_table`),
the candidate pairs of a distance join (`distance_join_pairs`) and the
per-filter Bloom probe (`bloom_probe_any`, against a bank kept on the device
by `device_bloom_bank`).

The bytes that cross from host to device are counted in `tracing.COUNTS`:
under "h2d.copy:<op>" those copied (the round trips' staged words, the
resident tables and banks, and every host array that `upload` sends), under
"h2d.mapped:<op>" those a kernel reads in place from pinned host memory
(the rank pass's probes against a resident table).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import threading

import numpy as np
import torch

from .. import tracing
from ..core import fault
from . import _build, ref

# launches per kernel; only a launch of the CUDA kernel counts. A chain's
# non-primary attempts count under "<op>:<backend>" keys, added when one runs
LAUNCHES = {name: 0 for name in _build.KERNELS}


def reset_launch_counts() -> None:
    for name in list(LAUNCHES):
        if name in _build.KERNELS:
            LAUNCHES[name] = 0
        else:
            del LAUNCHES[name]


def upload(x: np.ndarray, device: torch.device | str, op: str
           ) -> torch.Tensor:
    """`torch.from_numpy(x).to(device)`: the host array `x` on `device`
    for a call of `op`, its bytes counted under "h2d.copy:<op>" when they
    cross to a CUDA device."""
    t = torch.from_numpy(x).to(device)
    if t.device.type == "cuda":
        tracing.count("h2d.copy:" + op, x.nbytes)
    return t


def _fallback(op: str, backend: str, fn):
    """Attempt `backend` of `op`'s chain: `fn`, counted in `LAUNCHES` under
    "<op>:<backend>" when it returns."""
    def run():
        out = fn()
        key = f"{op}:{backend}"
        LAUNCHES[key] = LAUNCHES.get(key, 0) + 1
        return out
    return run


def _chain(op: str, on_cuda: bool, kernel, plain, validate=None):
    """One call of `op` through its failover chain (core/fault.run_op): on
    CUDA the kernel, then the plain version on the same card; on the CPU
    the plain version, then the same function again ("oracle", as the
    reference retries its jitted oracle)."""
    attempts = ([("kernel", kernel), ("plain", _fallback(op, "plain", plain))]
                if on_cuda else
                [("plain", plain), ("oracle", _fallback(op, "oracle", plain))])
    return fault.run_op(op, attempts, validate)


# structural validators of the chained ops' results (the corrupt-then-detect
# hook: they run only under an installed FaultPlan)
def _v_pairs(out, m: int, n: int) -> bool:
    i, j = out
    return bool(len(i) == len(j) and (len(i) == 0 or (
        i.min() >= 0 and i.max() < m and j.min() >= 0 and j.max() < n)))


def _v_fused(out, n: int) -> bool:
    # counts are survivor totals (above k on overflow, the recovery signal),
    # so their structural bound is the column count
    scores, _, counts = out
    return bool(not torch.isnan(scores).any() and (counts >= 0).all()
                and (counts <= n).all())


def _v_min_core(out: torch.Tensor) -> bool:
    return bool(torch.isfinite(out).all() and (out >= 0).all())


def _v_ranks(out, n: int, side: str) -> bool:
    lo, hi = out if side == "both" else (out, out)
    return bool((lo >= 0).all() and (hi <= n).all() and (lo <= hi).all())


def _v_mask01(out) -> bool:
    """A bool mask's bytes are all 0 or 1 (a corrupted one holds a 2)."""
    if isinstance(out, torch.Tensor):
        return bool(out.numel() == 0 or out.view(torch.uint8).max() <= 1)
    a = np.asarray(out)
    return bool(a.size == 0 or a.view(np.uint8).max() <= 1)


def _on_cuda(name: str, *tensors: torch.Tensor) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors
    (run the plain version); all inputs must share one device."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: inputs on several devices {devices}")
    kind = next(iter(devices)).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"{name}: unsupported device {kind!r}")
    return kind == "cuda"


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           align: int = 1) -> None:
    """dtype, shape (None = any extent), contiguity and base alignment."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(
            want is not None and got != want
            for got, want in zip(t.shape, shape)):
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: tensor must be {align}-byte aligned")


def _stream(device: torch.device | None = None) -> int:
    """The raw handle of PyTorch's current stream on `device` (the current
    device when None or index-less), from torch's own internal accessor:
    the public `torch.cuda.current_stream()` builds a Python object a
    call, which costs more host time than the small kernels run."""
    index = device.index if device is not None else None
    if index is None:
        index = torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def _launch(name: str, *args) -> None:
    err = _build.launcher(name)(*args, ctypes.c_void_p(_stream()))
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    LAUNCHES[name] += 1


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


# ----------------------------------------------------------- distance join --
def distance_join(driver: torch.Tensor, driven: torch.Tensor) -> torch.Tensor:
    """(M, 4) x (N, 4) f32 boxes -> (M, N) f32 min box distances."""
    if not _on_cuda("distance_join", driver, driven):
        return ref.distance_join_ref(driver, driven)
    _check("distance_join", driver, torch.float32, (None, 4), 16)
    _check("distance_join", driven, torch.float32, (None, 4), 16)
    m, n = driver.shape[0], driven.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=driver.device)
    if m and n:
        _launch("distance_join", _ptr(driver), _ptr(driven), _ptr(out),
                ctypes.c_longlong(m), ctypes.c_longlong(n))
    return out


# pairs a pair call takes back without a retry until a larger count has
# been seen on its device
PAIRS_MIN_CAPACITY = 1 << 16
# pair calls run again because their pairs outgrew the buffer
pair_capacity_retries = 0
_DJ_COLS = 1024     # driven columns a block of csrc/distance_join.cu


def distance_join_pairs(driver, driven, dist: float,
                        device: torch.device | str | None = None
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Candidate pairs of a distance join: int64 (i, j) host arrays, in
    row-major order, of every pair with ``box_min_dist(driver[i],
    driven[j]) <= float32(dist)``, i.e. ``np.nonzero(distance_join(driver,
    driven) <= float32(dist))`` without the matrix (see
    csrc/distance_join.cu).

    driver (M, 4) and driven (N, 4) are f32 tensors on one device, or host
    arrays (rounded to f32) joined on `device`. On CUDA a call is one C call
    with one launch and one synchronise: host arrays are staged in pinned
    memory and go up in one copy; the kernel writes the pairs and their
    count into pinned memory, and the host sorts them into row-major order.
    A count above the buffer's capacity grows the buffer and runs the call
    again (`pair_capacity_retries`). On the CPU the plain version runs. One
    call of the "distance_join_matrix" chain."""
    dist32 = np.float32(dist)
    staged = None
    if isinstance(driver, np.ndarray):
        if device is None:
            raise ValueError("distance_join_pairs: host boxes need a device")
        device = torch.device(device)
        staged = (np.ascontiguousarray(driver, dtype=np.float32),
                  np.ascontiguousarray(driven, dtype=np.float32))
        for x in staged:
            if x.ndim != 2 or x.shape[1] != 4:
                raise ValueError(f"distance_join_pairs: expected (rows, 4) "
                                 f"boxes, got {x.shape}")
        if device.type != "cuda":
            driver, driven = (torch.from_numpy(x).to(device) for x in staged)
            staged = None
    on_cuda = staged is not None or _on_cuda("distance_join", driver, driven)
    m, n = (len(x) for x in (staged or (driver, driven)))
    if m == 0 or n == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)

    def plain():
        a, b = ((torch.from_numpy(x).to(device) for x in staged)
                if staged is not None else (driver, driven))
        i, j = ref.distance_join_pairs_ref(a, b, dist32)
        return i.cpu().numpy(), j.cpu().numpy()

    return _chain("distance_join_matrix", on_cuda,
                  lambda: _pairs_round_trip(driver, driven, staged, dist32,
                                            device),
                  plain, functools.partial(_v_pairs, m=m, n=n))


def _pairs_round_trip(driver, driven, staged, dist32: np.float32,
                      device: torch.device) -> tuple[np.ndarray, np.ndarray]:
    """The pair call's CUDA round trip (see `distance_join_pairs`), on the
    staged host boxes or on CUDA tensors."""
    global pair_capacity_retries
    if staged is None:
        _check("distance_join", driver, torch.float32, (None, 4), 16)
        _check("distance_join", driven, torch.float32, (None, 4), 16)
        device = driver.device
    m, n = (len(x) for x in (staged or (driver, driven)))
    if max(m, n) >= 1 << 31 or m * -(-n // _DJ_COLS) >= 1 << 31:
        raise ValueError(f"distance_join_pairs: {m} x {n} exceeds the grid")
    with _staging_lock:
        st = _staging_for(device, "pairs")
        st.fit(0 if staged is None else (m + n) * 2, PAIRS_MIN_CAPACITY + 1)
        if staged is None:
            boxes = (None, None, driver.data_ptr(), driven.data_ptr())
        else:
            f32 = st.host_in_np.view(np.float32)
            f32[:4 * m] = staged[0].ravel()
            f32[4 * m:4 * (m + n)] = staged[1].ravel()
            boxes = (*st.ptrs_in, None, None)
        while True:
            cap = st.n_out - 1
            err = _build.launcher("distance_join_pairs_round_trip")(
                *boxes, m, n, float(dist32), st.counters.data_ptr(),
                st.ptr_out, cap, _stream(device))
            if err != 0:
                raise RuntimeError(f"distance_join_pairs: CUDA round trip "
                                   f"failed with error {err}")
            LAUNCHES["distance_join"] += 1
            if staged is not None:     # the boxes went up with the call
                tracing.count("h2d.copy:distance_join", (m + n) * 16)
            count = int(st.host_out_np[0])
            if count <= cap:
                break
            pair_capacity_retries += 1
            st.fit(0, count + 1)
        words = np.sort(st.host_out_np[1:1 + count])
    return words >> 32, words & 0xFFFFFFFF


def pairs_capacity(device: torch.device | str) -> int:
    """Pairs the next pair call on CUDA `device` takes back without a
    retry."""
    with _staging_lock:
        st = _staging_for(torch.device(device), "pairs")
        st.fit(0, PAIRS_MIN_CAPACITY + 1)
        return st.n_out - 1


# ------------------------------------------------- fused top-k distance join --
FUSED_MAX_K = 8192      # a row's list must fit in a block's shared memory
FUSED_TILE = 256        # driven columns a block stages a step
FUSED_MAX_SPLITS = 8    # column splits of a row group: one portable cluster
FUSED_WAVE_BLOCKS = 264   # two waves of the H100's 132 SMs
FUSED_SMEM = 232_448    # shared memory a block may use on Hopper


def fused_plan(m: int, n: int, k: int) -> tuple[int, int, int]:
    """(rows a block, column splits, split width) of a fused launch.

    A block runs one warp a driver row and walks one column split; the
    splits of a row group form one thread-block cluster. Four rows a block
    (fewer where k-entry lists would overflow shared memory), and as many
    splits of at least `FUSED_TILE` columns, up to `FUSED_MAX_SPLITS`, as
    the grid needs to cover `FUSED_WAVE_BLOCKS`. Split widths are
    multiples of 32 columns."""
    per_row = k * 8 + 32 * 8 + 8
    rows = min(4, (FUSED_SMEM - 2 * FUSED_TILE * 24) // per_row)
    rows = 1 << (rows.bit_length() - 1)
    groups = -(-m // rows)
    splits = min(FUSED_MAX_SPLITS, max(1, n // FUSED_TILE),
                 max(1, -(-FUSED_WAVE_BLOCKS // groups)))
    if n == 0:
        return rows, 1, 0
    width = -(-(-(-n // splits)) // 32) * 32
    return rows, -(-n // width), width


def fused_topk_join(driver: torch.Tensor, driven: torch.Tensor,
                    driver_keys: torch.Tensor, driven_keys: torch.Tensor,
                    dist: torch.Tensor, theta: torch.Tensor, k: int,
                    row_qid: torch.Tensor | None = None,
                    col_qid: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Streaming per-row top-k distance join (see csrc/fused_topk_join.cu).

    driver (M, 4) / driven (N, 4) f32 boxes, driver_keys (M,) / driven_keys
    (N,) f32 score-key bounds, per-row dist / theta (M,) f32, optional int32
    query ids (absent = all zero). Returns (scores (M, k) f32, idx (M, k)
    int32, counts (M,) int32). One call of the "fused_topk_join" chain.
    """
    m, n = driver.shape[0], driven.shape[0]
    dev = driver.device
    if row_qid is None:
        row_qid = torch.zeros(m, dtype=torch.int32, device=dev)
    if col_qid is None:
        col_qid = torch.zeros(n, dtype=torch.int32, device=dev)
    args = (driver, driven, driver_keys, driven_keys, dist, theta,
            row_qid, col_qid)
    return _chain("fused_topk_join", _on_cuda("fused_topk_join", *args),
                  lambda: _fused_launch(args, k),
                  lambda: ref.fused_topk_join_ref(*args, k),
                  functools.partial(_v_fused, n=n))


def _fused_launch(args: tuple, k: int
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Check the fused join's CUDA inputs and launch its kernel."""
    driver, driven = args[0], args[1]
    m, n = driver.shape[0], driven.shape[0]
    dev = driver.device
    if not 1 <= k <= FUSED_MAX_K:
        raise ValueError(f"fused_topk_join: k={k} outside [1, {FUSED_MAX_K}]")
    for t, (dtype, shape, align) in zip(args, (
            (torch.float32, (m, 4), 16), (torch.float32, (n, 4), 16),
            (torch.float32, (m,), 4), (torch.float32, (n,), 4),
            (torch.float32, (m,), 4), (torch.float32, (m,), 4),
            (torch.int32, (m,), 4), (torch.int32, (n,), 4))):
        _check("fused_topk_join", t, dtype, shape, align)
    scores = torch.empty((m, k), dtype=torch.float32, device=dev)
    idx = torch.empty((m, k), dtype=torch.int32, device=dev)
    counts = torch.empty(m, dtype=torch.int32, device=dev)
    if m:
        rows, splits, width = fused_plan(m, n, k)
        _launch("fused_topk_join", *(_ptr(t) for t in args),
                _ptr(scores), _ptr(idx), _ptr(counts),
                *(ctypes.c_int(x) for x in (m, n, k, rows, splits, width)))
    return scores, idx, counts


# ------------------------------------------- bucketed geometry refinement --
REFINE_MAX_PAD = 128
# descriptor columns of a refinement group, as csrc/bucketed_min_core.cu
# reads them: plane offsets (floats into the planes), output offset, rows,
# m_pad, n_pad, first block, layout
MIN_CORE_DESC = ("a_off", "b_off", "out_off", "rows", "m_pad", "n_pad",
                 "first_block", "layout")
# layouts by size class: a thread a row (256 rows a block), a warp a row
# (8 rows a block), a block a row
MIN_CORE_LAYOUTS = {"thread": (0, 256), "warp": (1, 8), "block": (2, 1)}


def min_core_layout(m_pad: int, n_pad: int) -> str:
    """The kernel's layout for one size class (see
    csrc/bucketed_min_core.cu)."""
    if m_pad * n_pad <= 64 and n_pad <= 16:
        return "thread"
    if m_pad <= 32 and n_pad <= 32:
        return "warp"
    return "block"


@dataclasses.dataclass(frozen=True)
class MinCoreGroup:
    """The buckets of one grouped refinement launch, on the host.

    `desc` (G, 8) int32 holds `MIN_CORE_DESC` per bucket. A packed buffer
    (`pack`) is one f32 array: the descriptor table's int32 bits first
    (`header` words), then each bucket's a (dims, rows, m_pad) and b (dims,
    rows, n_pad) planes. The cores come out as one (n_rows,) f32 array,
    bucket after bucket."""
    dims: int
    desc: np.ndarray
    n_blocks: int
    n_rows: int
    n_floats: int

    @property
    def header(self) -> int:
        return self.desc.size

    def pack(self) -> np.ndarray:
        """An f32 buffer with the descriptor table written and the planes
        left to fill (`planes`)."""
        buf = np.empty(self.header + self.n_floats, dtype=np.float32)
        buf[:self.header].view(np.int32)[:] = self.desc.ravel()
        return buf

    def planes(self, buf, g: int):
        """Views (a, b) of bucket g's planes in a packed buffer (numpy or
        torch, header included)."""
        a_off, b_off, _, nb, m_pad, n_pad = (int(x) for x in self.desc[g, :6])
        h = self.header
        return (buf[h + a_off:h + a_off + self.dims * nb * m_pad]
                .reshape(self.dims, nb, m_pad),
                buf[h + b_off:h + b_off + self.dims * nb * n_pad]
                .reshape(self.dims, nb, n_pad))

    def rows(self, g: int) -> slice:
        """Bucket g's cores in the grouped output."""
        start = int(self.desc[g, 2])
        return slice(start, start + int(self.desc[g, 3]))


def min_core_group(dims: int, shapes) -> MinCoreGroup:
    """Lay out buckets of (rows, m_pad, n_pad) for one grouped launch."""
    if dims not in (2, 3):
        raise ValueError(f"bucketed_min_core: dims={dims} outside 2-3")
    desc = np.zeros((len(shapes), len(MIN_CORE_DESC)), dtype=np.int32)
    floats = rows = blocks = 0
    for g, (nb, m_pad, n_pad) in enumerate(shapes):
        if not (1 <= m_pad <= REFINE_MAX_PAD and 1 <= n_pad <= REFINE_MAX_PAD):
            raise ValueError(f"bucketed_min_core: m_pad={m_pad}, n_pad="
                             f"{n_pad} outside pads 1-{REFINE_MAX_PAD}")
        code, per_block = MIN_CORE_LAYOUTS[min_core_layout(m_pad, n_pad)]
        desc[g] = (floats, floats + dims * nb * m_pad, rows, nb, m_pad,
                   n_pad, blocks, code)
        floats += dims * nb * (m_pad + n_pad)
        rows += nb
        blocks += -(-nb // per_block)
    if floats >= 1 << 31:
        raise ValueError(f"bucketed_min_core: {floats} plane floats exceed "
                         "2^31")
    return MinCoreGroup(dims, desc, blocks, rows, floats)


def _min_core_launch(desc: torch.Tensor, planes: torch.Tensor,
                     group: MinCoreGroup) -> torch.Tensor:
    out = torch.empty(group.n_rows, dtype=torch.float32, device=planes.device)
    if group.n_blocks:
        _launch("bucketed_min_core", _ptr(desc), _ptr(planes), _ptr(out),
                ctypes.c_int(len(group.desc)), ctypes.c_int(group.dims),
                ctypes.c_int(group.n_blocks))
    return out


def bucketed_min_core_group(buf: torch.Tensor, group: MinCoreGroup
                            ) -> torch.Tensor:
    """Per-row min squared point distance over every bucket of a refinement
    call, in one launch (see csrc/bucketed_min_core.cu).

    buf: `group.pack()`'s 1-d f32 buffer, planes filled, on the device
    (one upload). Returns the (group.n_rows,) f32 cores, bucket after
    bucket (`group.rows(g)`). One call of the "bucketed_min_core" chain."""
    def kernel():
        _check("bucketed_min_core", buf, torch.float32,
               (group.header + group.n_floats,), 16)
        return _min_core_launch(buf[:group.header].view(torch.int32),
                                buf[group.header:], group)

    return _chain("bucketed_min_core", _on_cuda("bucketed_min_core", buf),
                  kernel, lambda: ref.bucketed_min_core_group_ref(
                      buf, group.desc, group.dims), _v_min_core)


def bucketed_min_core(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-row min squared point distance over one size-class bucket: a
    refinement group of one (see `bucketed_min_core_group`).

    a (dims, B, m_pad), b (dims, B, n_pad) f32 coordinate planes (dims 2 or
    3, pads <= 128, padding replicates real points) -> (B,) f32 cores; the
    caller applies the metric's distance transform in f64.
    """
    if not _on_cuda("bucketed_min_core", a, b):
        return ref.bucketed_min_core_ref(a, b)
    dims, nb, m_pad = a.shape
    n_pad = b.shape[2]
    group = min_core_group(dims, [(nb, m_pad, n_pad)])
    _check("bucketed_min_core", a, torch.float32, (dims, nb, m_pad), 4)
    _check("bucketed_min_core", b, torch.float32, (dims, nb, n_pad), 4)
    desc = torch.from_numpy(group.desc).to(a.device)
    return _min_core_launch(desc, torch.cat([a.reshape(-1), b.reshape(-1)]),
                            group)


# ------------------------------------------------------------ tree descent --
def f64_sort_keys(x: np.ndarray) -> np.ndarray:
    """IEEE-754 doubles -> order-isomorphic int64 sort keys (host, exact).

    The classic total-order flip: positives keep their bit pattern with the
    sign bit toggled, negatives are complemented; -0.0 is canonicalized to
    +0.0 first so the two zero encodings stay equal. int64 comparisons on
    the keys then agree bit-for-bit with f64 ``<=`` on the inputs. Finite
    inputs map strictly inside (int64-min, int64-max), so both extremes
    remain free for never-matching padding sentinels.
    """
    x = np.where(x == 0.0, 0.0, np.asarray(x, dtype=np.float64))
    u = np.asarray(x, dtype=np.float64).view(np.uint64)
    sign = np.uint64(1) << np.uint64(63)
    key_u = np.where(u & sign != 0, ~u, u | sign)
    return (key_u ^ sign).view(np.int64)


# never-intersecting padding box in f64_sort_keys space: mins above every
# real max key, maxs below every real min key (rows are x0, y0, x2, y3)
DESCEND_PAD_BOX = np.array(
    [(1 << 63) - 1, (1 << 63) - 1, -(1 << 63), -(1 << 63)], dtype=np.int64)


def tree_descend(node_keys: torch.Tensor, cs_path: torch.Tensor,
                 box_keys: torch.Tensor) -> torch.Tensor:
    """Fused Phase-1 candidate-node pass (see csrc/tree_descend.cu).

    node_keys (4, N) int64 `f64_sort_keys` planes of the node MBRs (rows
    x0, y0, x2, y3); cs_path (N,) bool root-path Bloom verdicts; box_keys
    (B, M, 4) int64 keys of the expanded driver boxes, padding rows set to
    `DESCEND_PAD_BOX`. Returns the (B, N) bool candidate masks. One call of
    the "tree_descend" chain.
    """
    return _chain("tree_descend",
                  _on_cuda("tree_descend", node_keys, cs_path, box_keys),
                  lambda: _descend_launch(node_keys, cs_path, box_keys),
                  lambda: ref.tree_descend_ref(node_keys, cs_path, box_keys),
                  _v_mask01)


def _descend_launch(node_keys: torch.Tensor, cs_path: torch.Tensor,
                    box_keys: torch.Tensor) -> torch.Tensor:
    """Check the descent's CUDA inputs and launch its kernel: (B, N)."""
    n = node_keys.shape[1]
    nb, m = box_keys.shape[0], box_keys.shape[1]
    _check("tree_descend", node_keys, torch.int64, (4, n), 8)
    _check("tree_descend", cs_path, torch.bool, (n,))
    _check("tree_descend", box_keys, torch.int64, (nb, m, 4), 8)
    if nb > 65535:
        raise ValueError(f"tree_descend: {nb} blocks exceed the grid's y axis")
    out = torch.empty((nb, n), dtype=torch.bool, device=node_keys.device)
    if n and nb:
        _launch("tree_descend", _ptr(node_keys), _ptr(cs_path),
                _ptr(box_keys), _ptr(out), ctypes.c_int(n), ctypes.c_int(nb),
                ctypes.c_int(m))
    return out


def tree_descend_sharded(node_keys: torch.Tensor, cs_path: torch.Tensor,
                         box_keys: torch.Tensor) -> torch.Tensor:
    """Phase-1 descent over every store shard in one call (see
    csrc/tree_descend.cu).

    node_keys (S, 4, N_max) int64 stacked per-shard key planes, pad columns
    set to `DESCEND_PAD_BOX`; cs_path (S, N_max) bool, False on pad
    columns; box_keys (B, M, 4) the shared driver boxes. Returns (S, B,
    N_max) bool masks.

    On CUDA the S x N_max node columns are one `tree_descend` launch: the
    planes as (4, S·N_max), a grid of ceil(S·N_max/32) x B blocks, the
    (B, S·N_max) result viewed as (S, B, N_max). A pad column is off the
    Bloom path, so its lane tests no box. Planes that are a transposed
    view of a contiguous (4, S, N_max) tensor (core/shard.py keeps them so)
    go to the kernel without a copy. One call of the
    "tree_descend_sharded" chain: the one launch (on the CPU, the plain
    version), then a loop of per-shard `tree_descend` calls, each with its
    own chain, as the reference's `shard_map` then `sequential`.
    """
    if node_keys.dim() != 3 or node_keys.shape[1] != 4 \
            or tuple(cs_path.shape) != (node_keys.shape[0],
                                        node_keys.shape[2]):
        raise ValueError(f"tree_descend_sharded: planes "
                         f"{tuple(node_keys.shape)}, cs_path "
                         f"{tuple(cs_path.shape)}; needs (S, 4, N) and (S, N)")
    s, _, n = node_keys.shape
    nb = box_keys.shape[0]
    on_cuda = _on_cuda("tree_descend", node_keys, cs_path, box_keys)
    if s == 0 or n == 0 or nb == 0:
        return torch.zeros((s, nb, n), dtype=torch.bool,
                           device=node_keys.device)

    def kernel():
        out = _descend_launch(node_keys.transpose(0, 1).reshape(4, s * n),
                              cs_path.reshape(s * n), box_keys)
        return out.view(nb, s, n).transpose(0, 1)

    def sequential():
        return torch.stack([tree_descend(node_keys[i].contiguous(),
                                         cs_path[i].contiguous(), box_keys)
                            for i in range(s)])

    first = (("kernel", kernel) if on_cuda else ("plain", lambda: (
        ref.tree_descend_sharded_ref(node_keys, cs_path, box_keys))))
    return fault.run_op("tree_descend_sharded", [
        first, ("sequential", _fallback("tree_descend_sharded", "sequential",
                                        sequential))], _v_mask01)


# ------------------------------------------------------------ bloom probe --
BLOOM_WORDS = (8, 16, 32)


def bloom_probe(bits: torch.Tensor, keys: torch.Tensor, k: int
                ) -> torch.Tensor:
    """Bloom membership of keys[b] in the pre-gathered filter row bits[b]
    (see csrc/bloom_probe.cu).

    bits (B, W) uint32 (or int32 holding the uint32 bit patterns) words,
    W in BLOOM_WORDS; keys (B,) int64; k >= 1 hash probes. Returns (B,)
    bool: all k double-hashed bits set.
    """
    if not _on_cuda("bloom_probe", bits, keys):
        return ref.bloom_probe_ref(bits, keys, k)
    nb = keys.shape[0]
    if bits.dim() != 2 or bits.shape[1] not in BLOOM_WORDS or k < 1:
        raise ValueError(f"bloom_probe: rows {tuple(bits.shape)}, k={k}; "
                         f"needs W in {BLOOM_WORDS} and k >= 1")
    if bits.dtype == torch.uint32:
        bits = bits.view(torch.int32)
    _check("bloom_probe", bits, torch.int32, (nb, bits.shape[1]), 4)
    _check("bloom_probe", keys, torch.int64, (nb,), 8)
    out = torch.empty(nb, dtype=torch.bool, device=keys.device)
    if nb:
        _launch("bloom_probe", _ptr(bits), _ptr(keys), _ptr(out),
                ctypes.c_longlong(nb), ctypes.c_int(bits.shape[1]),
                ctypes.c_int(k))
    return out


# resident Bloom banks made by `device_bloom_bank` so far, one upload each
bloom_bank_uploads = 0


def device_bloom_bank(bits: np.ndarray, device: torch.device | str
                      ) -> torch.Tensor:
    """A copy of a Bloom bank's (n_filters, W) uint32 words on `device`, as
    int32, for a bank that probes there again and keeps it
    (core/charsets.BloomBank). Counted in `bloom_bank_uploads`."""
    global bloom_bank_uploads
    bloom_bank_uploads += 1
    t = torch.from_numpy(np.ascontiguousarray(bits).view(np.int32)
                         ).to(device, copy=True)
    if t.device.type == "cuda":
        tracing.count("h2d.copy:bloom_bank", t.nbytes)
    return t


def bloom_probe_any(bits: torch.Tensor, filter_idx: np.ndarray,
                    keys: np.ndarray, k: int) -> np.ndarray:
    """Per filter of a bank, whether ANY of `keys` is a member (see
    csrc/bloom_probe.cu): the Phase-1 frontier probe.

    bits (n_filters, W) int32 (or uint32) words of the bank, on the device
    it is kept on (`device_bloom_bank`), W in BLOOM_WORDS; filter_idx (F,)
    rows of the bank and keys (C,) int64 host arrays; k >= 1 hash probes.
    Returns the (F,) bool verdicts as a host array. On CUDA a call is one C
    call: the indices and keys staged in pinned memory go up in one copy,
    one launch writes the verdicts into pinned memory, one synchronise. On
    the CPU the plain version runs. One call of the "bloom_probe" chain."""
    fi = np.asarray(filter_idx, dtype=np.int64)
    keys = np.asarray(keys, dtype=np.int64)
    if bits.dim() != 2 or bits.shape[1] not in BLOOM_WORDS or k < 1:
        raise ValueError(f"bloom_probe_any: bank {tuple(bits.shape)}, k={k}; "
                         f"needs W in {BLOOM_WORDS} and k >= 1")
    n_f, n_c = len(fi), len(keys)
    if n_f and (fi.min() < 0 or fi.max() >= bits.shape[0]):
        raise ValueError(f"bloom_probe_any: filter indices outside the "
                         f"bank's {bits.shape[0]} rows")
    if n_f == 0 or n_c == 0:
        return np.zeros(n_f, dtype=bool)

    def plain():
        return ref.bloom_probe_any_ref(
            bits, torch.from_numpy(fi).to(bits.device),
            torch.from_numpy(keys).to(bits.device), k).cpu().numpy()

    return _chain("bloom_probe", _on_cuda("bloom_probe", bits),
                  lambda: _any_round_trip(bits, fi, keys, k), plain,
                  _v_mask01)


def _any_round_trip(bits: torch.Tensor, fi: np.ndarray, keys: np.ndarray,
                    k: int) -> np.ndarray:
    """The per-filter probe's CUDA round trip (see `bloom_probe_any`)."""
    n_f, n_c = len(fi), len(keys)
    if bits.dtype == torch.uint32:
        bits = bits.view(torch.int32)
    _check("bloom_probe", bits, torch.int32, tuple(bits.shape), 4)
    if n_c >= 1 << 31:
        raise ValueError(f"bloom_probe_any: {n_c} keys exceed 2^31")
    with _staging_lock:
        st = _staging_for(bits.device, "bloom")
        st.fit(n_f + n_c, -(-n_f // 8))
        st.host_in_np[:n_f] = fi
        st.host_in_np[n_f:n_f + n_c] = keys
        err = _build.launcher("bloom_probe_any_round_trip")(
            *st.ptrs_in, bits.data_ptr(), bits.shape[1], k, n_f, n_c,
            st.ptr_out, _stream(bits.device))
        if err != 0:
            raise RuntimeError(f"bloom_probe_any: CUDA round trip failed "
                               f"with error {err}")
        LAUNCHES["bloom_probe"] += 1
        tracing.count("h2d.copy:bloom_probe", (n_f + n_c) * 8)
        return st.host_out_np.view(np.uint8)[:n_f].astype(bool)


# --------------------------------------------------- merge-join rank pass --
RANK_SIDES = {"left": 1, "right": 2, "both": 3}
# Calls of up to this many probes run one warp a probe (a 32-ary search:
# few dependent loads, and the small calls of the main path reach more
# SMs); larger ones, whose threads alone fill the card, one thread a probe.
RANK_WARP_MAX_M = 16384


def _rank_lanes(m: int) -> int:
    return 32 if m <= RANK_WARP_MAX_M else 1


def _rank_launch(table: torch.Tensor, probes: torch.Tensor,
                 out: torch.Tensor, side: str, lanes: int | None = None
                 ) -> None:
    """Launch the rank kernel on checked, non-empty CUDA inputs. out is a
    contiguous (2, M) (side "both": lo, hi) or (1, M) int64 view; `lanes`
    (32: a warp a probe, 1: a thread a probe) defaults to the choice by M."""
    m = probes.shape[0]
    _launch("merge_join_ranks", _ptr(table), _ptr(probes), _ptr(out),
            ctypes.c_longlong(table.shape[0]), ctypes.c_longlong(m),
            ctypes.c_int(RANK_SIDES[side]),
            ctypes.c_int(_rank_lanes(m) if lanes is None else lanes))


def insertion_ranks(table: torch.Tensor, probes: torch.Tensor,
                    side: str = "both"):
    """The merge-join rank kernel's wrapper (see csrc/merge_join_ranks.cu).

    table (N,) sorted int64, probes (M,) int64. Returns int64 (M,) ranks:
    ``lo = #{table < p}`` for side "left", ``hi = #{table <= p}`` for
    "right", (lo, hi) for "both". An empty table or empty probes give zeros
    without a launch.
    """
    if side not in RANK_SIDES:
        raise ValueError(f"unknown rank side {side!r}")
    if not _on_cuda("merge_join_ranks", table, probes):
        return ref.merge_join_ranks_ref(table, probes, side)
    n, m = table.shape[0], probes.shape[0]
    _check("merge_join_ranks", table, torch.int64, (n,), 8)
    _check("merge_join_ranks", probes, torch.int64, (m,), 8)
    if n >= 1 << 31:
        raise ValueError(f"merge_join_ranks: table of {n} rows exceeds 2^31")
    alloc = torch.zeros if n == 0 else torch.empty
    out = alloc((2 if side == "both" else 1, m), dtype=torch.int64,
                device=probes.device)
    if n and m:
        _rank_launch(table, probes, out, side)
    return (out[0], out[1]) if side == "both" else out[0]


# Rank-pass backends of the relational merge join (core/join.py): "numpy"
# is numpy's searchsorted on the host; "kernel" runs the rank kernel on
# the engine's device (its plain torch version on the CPU). "auto"
# resolves to the kernel when CUDA is available, numpy otherwise.
RANK_BACKENDS = ("auto", "numpy", "kernel")


def resolve_rank_backend(backend: str | None) -> str:
    b = backend or "auto"
    if b not in RANK_BACKENDS:
        raise ValueError(f"unknown merge-join rank backend {b!r}")
    if b != "auto":
        return b
    return "kernel" if torch.cuda.is_available() else "numpy"


# resident rank tables made by `device_table` so far, one upload each
rank_table_uploads = 0


def device_table(table: np.ndarray, device: torch.device | str
                 ) -> torch.Tensor:
    """A copy of the sorted int64 rank `table` on `device`, for a caller
    that ranks against it again and keeps it (core/join.py, in the key
    cache entry that holds the host keys). Counted in
    `rank_table_uploads`."""
    global rank_table_uploads
    rank_table_uploads += 1
    t = torch.from_numpy(np.ascontiguousarray(table, dtype=np.int64)
                         ).to(device, copy=True)
    if t.device.type == "cuda":
        tracing.count("h2d.copy:rank_table", t.nbytes)
    return t


class _Staging:
    """Grow-only buffers of one device's round trips of one kind (rank
    calls, pair calls, Bloom probes): pinned host memory for the words
    staged to go up (`host_in`) and for the words that come back
    (`host_out`), device memory that the staged words are copied into
    (`dev_in`), and two device counters that a pair call leaves zeroed.
    int64 words; a call views them as the type it needs. A call
    synchronises before it returns, so the next call may reuse them."""

    def __init__(self, device: torch.device):
        self.device = device
        self.n_in = self.n_out = 0
        self.counters = torch.zeros(2, dtype=torch.int64, device=device)

    def fit(self, n_in: int, n_out: int) -> None:
        if n_in > self.n_in:
            self.n_in = 1 << max(n_in - 1, 1023).bit_length()
            self.host_in = torch.empty(self.n_in, dtype=torch.int64,
                                       pin_memory=True)
            self.dev_in = torch.empty(self.n_in, dtype=torch.int64,
                                      device=self.device)
            self.host_in_np = self.host_in.numpy()
            self.ptrs_in = (self.host_in.data_ptr(), self.dev_in.data_ptr())
        if n_out > self.n_out:
            self.n_out = 1 << max(n_out - 1, 1023).bit_length()
            self.host_out = torch.empty(self.n_out, dtype=torch.int64,
                                        pin_memory=True)
            self.host_out_np = self.host_out.numpy()
            self.ptr_out = self.host_out.data_ptr()


_staging: dict[tuple[torch.device, str], _Staging] = {}
_staging_lock = threading.Lock()


def _staging_for(device: torch.device, kind: str) -> _Staging:
    """The staging of `kind` calls on CUDA `device` (the current device
    when index-less); the caller holds `_staging_lock`."""
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    st = _staging.get((device, kind))
    if st is None:
        st = _staging[device, kind] = _Staging(device)
    return st


def _cuda_round_trip(table: np.ndarray, probes: np.ndarray, side: str,
                     device: torch.device,
                     table_on_device: torch.Tensor | None) -> np.ndarray:
    """(rows, M) ranks through the kernel in one C call (see
    csrc/merge_join_ranks.cu, merge_join_ranks_round_trip): the probes
    staged in pinned memory; with a resident table the kernel reads them
    and writes the ranks into pinned memory in place, else the staged table
    and probes go up in one copy first; one synchronise."""
    n, m = len(table), len(probes)
    rows = 2 if side == "both" else 1
    if n >= 1 << 31:
        raise ValueError(f"merge_join_ranks: table of {n} rows exceeds 2^31")
    resident = None
    if table_on_device is not None:
        t = table_on_device
        if t.dtype != torch.int64 or t.dim() != 1 \
                or t.device.type != "cuda" or not t.is_contiguous():
            raise ValueError("merge_join_ranks: the resident table must be "
                             "a contiguous 1-d int64 CUDA tensor")
        resident = t.data_ptr()
    up = n if resident is None else 0
    with _staging_lock:
        st = _staging_for(device, "rank")
        st.fit(up + m, rows * m)
        if up:
            st.host_in_np[:n] = table
        st.host_in_np[up:up + m] = probes
        err = _build.launcher("merge_join_ranks_round_trip")(
            *st.ptrs_in, resident, n, m, st.ptr_out, RANK_SIDES[side],
            _rank_lanes(m), _stream(device))
        if err != 0:
            raise RuntimeError(f"merge_join_ranks: CUDA round trip failed "
                               f"with error {err}")
        LAUNCHES["merge_join_ranks"] += 1
        if up:      # the staged table and probes went up in one copy
            tracing.count("h2d.copy:merge_join_ranks", (n + m) * 8)
        else:       # the kernel read the staged probes in place
            tracing.count("h2d.mapped:merge_join_ranks", m * 8)
        return st.host_out_np[:rows * m].reshape(rows, m).copy()


def merge_join_ranks(table: np.ndarray, probes: np.ndarray,
                     backend: str | None = None, side: str = "both",
                     device: torch.device | str | None = None,
                     table_on_device: torch.Tensor | None = None):
    """Insertion ranks of `probes` in the sorted int64 `table`: with
    side="both" returns (lo, hi) int64 where lo = searchsorted-left and
    hi = searchsorted-right; side="left"/"right" returns that bound only.

    numpy arrays in and out. The "kernel" backend ranks on `device`.
    `table_on_device` is the table's resident copy there (`device_table`;
    core/join.py keeps one in the key-cache entry of each per-pattern scan
    it re-ranks every driver block), so the table crosses to the card once
    per relation. On CUDA a call is one round trip, one C call with one
    launch and one synchronise: the probes are staged in pinned host
    memory, and the kernel writes both bounds into one (2, M) pinned
    output. With the table resident the kernel reads the staged probes in
    place over the bus and no copy runs; without it the table is staged
    before the probes and both go up in one host-to-device copy. On the
    CPU the plain version runs.

    One call of the "merge_join_ranks" chain, every backend (the reference
    chains numpy too): numpy's search then the same again; the kernel, then
    the plain version on `device`. Empty tables or probes give zeros
    without a call."""
    if side not in RANK_SIDES:
        raise ValueError(f"unknown rank side {side!r}")
    backend = resolve_rank_backend(backend)
    table = np.asarray(table, dtype=np.int64)
    probes = np.asarray(probes, dtype=np.int64)
    m = len(probes)
    if len(table) == 0 or m == 0:
        z = np.zeros(m, dtype=np.int64)
        return (z, z.copy()) if side == "both" else z
    validate = functools.partial(_v_ranks, n=len(table), side=side)

    def numpy_ranks():
        if side != "both":
            return np.searchsorted(table, probes, side)
        return (np.searchsorted(table, probes, "left"),
                np.searchsorted(table, probes, "right"))

    if backend == "numpy":
        return fault.run_op("merge_join_ranks", [
            ("numpy", numpy_ranks),
            ("oracle", _fallback("merge_join_ranks", "oracle", numpy_ranks))],
            validate)
    if device is None:
        raise ValueError("the kernel rank backend needs a device")
    if not isinstance(device, torch.device):
        device = torch.device(device)
    if table_on_device is not None and len(table_on_device) != len(table):
        raise ValueError("merge_join_ranks: the resident table has "
                         f"{len(table_on_device)} rows, not {len(table)}")

    def kernel():
        out = _cuda_round_trip(table, probes, side, device, table_on_device)
        return (out[0], out[1]) if side == "both" else out[0]

    def plain():
        tab = (table_on_device if table_on_device is not None
               else torch.from_numpy(np.ascontiguousarray(table)).to(device))
        out = ref.merge_join_ranks_ref(
            tab, torch.from_numpy(np.ascontiguousarray(probes)).to(device),
            side)
        if side != "both":
            return out.cpu().numpy()
        return out[0].cpu().numpy(), out[1].cpu().numpy()

    return _chain("merge_join_ranks", device.type == "cuda", kernel, plain,
                  validate)


# -------------------------------------------------------------- block scan --
def block_scan(scores: torch.Tensor, theta: float
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One pass over (nb, B) f32 score blocks (see csrc/block_scan.cu):
    (row max f32 (nb,), count of scores > theta int32 (nb,), survivor mask
    uint8 (nb, B)). theta is rounded to f32; B >= 1."""
    if not _on_cuda("block_scan", scores):
        return ref.block_scan_ref(scores, theta)
    if scores.dim() != 2 or scores.shape[1] < 1:
        raise ValueError(f"block_scan: expected (nb, B >= 1) scores, got "
                         f"{tuple(scores.shape)}")
    nb, bsz = scores.shape
    _check("block_scan", scores, torch.float32, (nb, bsz), 16)
    dev = scores.device
    bmax = torch.empty(nb, dtype=torch.float32, device=dev)
    cnt = torch.empty(nb, dtype=torch.int32, device=dev)
    mask = torch.empty((nb, bsz), dtype=torch.uint8, device=dev)
    if nb:
        _launch("block_scan", _ptr(scores), ctypes.c_float(theta),
                _ptr(bmax), _ptr(cnt), _ptr(mask), ctypes.c_int(nb),
                ctypes.c_int(bsz))
    return bmax, cnt, mask


# ------------------------------------------------------------------ morton --
def morton_encode(cx: torch.Tensor, cy: torch.Tensor) -> torch.Tensor:
    """int32 cell coordinates cx, cy (n,) -> int32 Morton codes (n,) of their
    low 16 bits (see csrc/morton_encode.cu); codes >= 2^31 are negative."""
    if not _on_cuda("morton_encode", cx, cy):
        return ref.morton_ref(cx, cy)
    n = cx.shape[0]
    _check("morton_encode", cx, torch.int32, (n,), 4)
    _check("morton_encode", cy, torch.int32, (n,), 4)
    out = torch.empty(n, dtype=torch.int32, device=cx.device)
    if n:
        _launch("morton_encode", _ptr(cx), _ptr(cy), _ptr(out),
                ctypes.c_longlong(n))
    return out


# --------------------------------------------------------- flash attention --
FLASH_HEAD_DIMS = (32, 64, 128, 256)
_FLASH_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """GQA forward attention (see csrc/flash_attention.cu).

    q (B, Hq, S, D); k, v (B, Hkv, S, D) with Hq % Hkv == 0, all f32 or all
    bf16 and contiguous (the wrapper never copies); D in FLASH_HEAD_DIMS.
    Scale D^-0.5, optional causal mask; returns (B, Hq, S, D) in q's dtype.
    """
    if not _on_cuda("flash_attention", q, k, v):
        return ref.flash_attention_ref(q, k, v, causal)
    if q.dtype not in _FLASH_DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must all be float32 or "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4:
        raise ValueError(f"flash_attention: q must be (B, Hq, S, D), got "
                         f"{tuple(q.shape)}")
    b, hq, s, d = q.shape
    hkv = k.shape[1] if k.dim() == 4 else 0
    if hkv == 0 or hq % hkv:
        raise ValueError(f"flash_attention: Hq={hq} is not a multiple of the "
                         f"K/V heads of {tuple(k.shape)}")
    if d not in FLASH_HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in "
                         f"{FLASH_HEAD_DIMS}")
    if b * hq > 65535:
        raise ValueError(f"flash_attention: B*Hq={b * hq} exceeds the grid's "
                         "y axis")
    _check("flash_attention", q, q.dtype, (b, hq, s, d), 16)
    _check("flash_attention", k, q.dtype, (b, hkv, s, d), 16)
    _check("flash_attention", v, q.dtype, (b, hkv, s, d), 16)
    out = torch.empty_like(q)
    if b and s:
        _launch("flash_attention", _ptr(q), _ptr(k), _ptr(v), _ptr(out),
                ctypes.c_int(b), ctypes.c_int(hq), ctypes.c_int(hkv),
                ctypes.c_int(s), ctypes.c_int(d), ctypes.c_int(int(causal)),
                ctypes.c_int(_FLASH_DTYPES[q.dtype]))
    return out
