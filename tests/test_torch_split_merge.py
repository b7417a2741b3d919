"""The two kernels' designs, modelled on the CPU.

`fused_topk_join` (csrc/fused_topk_join.cu) splits a row's columns over
the blocks of a cluster; each block keeps its split's top-k list, built 32
columns at a time (append, or a warp sort and an in-place merge by rank),
and the lists merge by rank at the end; its distance test compares the
squared distance with a per-row threshold in place of the square root.
`kernel_model` below repeats that algorithm step for step in Python, with
`ops.fused_plan`'s splits or forced ones, and must give what the plain
version (`ref.fused_topk_join_ref`) and the reference's Pallas kernel
(interpret mode) give: scores, columns, tie order and counts, bit for bit.
The CUDA kernel itself runs only on the card (tests/test_torch_cuda.py).

`bucketed_min_core` runs every bucket of a refinement call in one launch
over a packed buffer (`ops.MinCoreGroup`); its plain version is held
against the reference's kernel bucket by bucket.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fused_topk_join as ftj
from repro.kernels import geom_refine as gr
from repro_torch.kernels import ops, ref
from test_torch_kernels import assert_within_ulp

LANES = 32
GARBAGE = (float("nan"), -7)     # what a list slot holds before a write


def _split_list(s_row, valid_row, lo, hi, k, paths):
    """One warp's list over columns [lo, hi): (scores, columns, count)."""
    buf = [GARBAGE] * k
    nl, count = 0, 0
    for t in range(lo, hi, LANES):
        cols = range(t, min(t + LANES, hi))
        count += int(sum(valid_row[j] for j in cols))
        worst = buf[k - 1][0] if nl == k else -np.inf
        cand = [(s_row[j], j) for j in cols
                if valid_row[j] and (nl < k or s_row[j] > worst)]
        if not cand:
            continue
        nc = len(cand)
        if any(cand[x][0] > cand[x - 1][0] for x in range(1, nc)):
            cand.sort(key=lambda e: (-e[0], e[1]))
            paths["sort"] += 1
        if nl == 0 or cand[0][0] <= buf[nl - 1][0]:
            paths["append"] += 1
            for x in range(nc):
                if nl + x < k:
                    buf[nl + x] = cand[x]
        else:
            paths["merge"] += 1
            r1 = [x + sum(buf[q][0] >= c for q in range(nl))
                  for x, (c, _) in enumerate(cand)]
            keep, top = r1[0], nl
            while top > keep:
                chunk = [q for q in range(top - LANES, top) if q >= keep]
                read = [buf[q] for q in chunk]          # all read, then write
                for q, (sq, jq) in zip(chunk, read):
                    r = q + sum(c > sq for c, _ in cand)
                    if r < k:
                        buf[r] = (sq, jq)
                top -= LANES
            for x, e in enumerate(cand):
                if r1[x] < k:
                    buf[r1[x]] = e
        nl = min(nl + nc, k)
    assert GARBAGE not in buf[:nl]
    return buf[:nl], count


F32_MAX = np.finfo(np.float32).max


def _step(m, ulps):
    return (np.float32(m).view(np.int32) + np.int32(ulps)).view(np.float32)


def sqrt_threshold(d):
    """The kernel's `sqrt_threshold`: the largest f32 m with RN sqrt(m) <=
    d (numpy's f32 sqrt is correctly rounded, as __fsqrt_rn is)."""
    d = np.float32(d)
    if np.isnan(d):
        return d
    if d < 0:
        return np.float32(-1)
    if np.isinf(d):
        return np.float32(np.inf)
    with np.errstate(over="ignore"):
        m = np.minimum(d * d, F32_MAX)
    while m > 0 and np.sqrt(m) > d:
        m = _step(m, -1)
    while m < F32_MAX and np.sqrt(_step(m, 1)) <= d:
        m = _step(m, 1)
    return m


def box_gap_sq(a, b):
    """box_min_dist before its square root, unfused f32, NaN in NaN out."""
    a, b = a[:, None, :], b[None, :, :]
    zero = np.float32(0)
    dx = np.maximum(zero, np.maximum(a[..., 0] - b[..., 2],
                                     b[..., 0] - a[..., 2]))
    dy = np.maximum(zero, np.maximum(a[..., 1] - b[..., 3],
                                     b[..., 1] - a[..., 3]))
    return dx * dx + dy * dy


def kernel_model(inputs, k, splits, width, paths=None):
    """The CUDA kernel's algorithm in Python: per row, S split lists, then
    the cluster's merge by rank."""
    a, b, dk, vk, dist, theta, rq, cq = inputs
    m, n = len(a), len(b)
    with np.errstate(invalid="ignore"):
        near = box_gap_sq(a, b) <= np.array(
            [sqrt_threshold(x) for x in dist], np.float32)[:, None]
    s = dk[:, None] + vk[None, :]                   # f32 adds
    valid = near & (s > theta[:, None]) & (rq[:, None] == cq[None, :])
    paths = {"append": 0, "sort": 0, "merge": 0} if paths is None else paths
    out_s = np.full((m, k), -np.inf, dtype=np.float32)
    out_i = np.full((m, k), -1, dtype=np.int32)
    out_c = np.zeros(m, dtype=np.int32)
    for i in range(m):
        lists = []
        for sp in range(splits):
            lo = min(n, sp * width)
            lists.append(_split_list(s[i], valid[i], lo, min(n, lo + width),
                                     k, paths))
        for sp, (entries, _) in enumerate(lists):
            for q, (v, j) in enumerate(entries):
                r = q + sum(sum(e[0] >= v if t < sp else e[0] > v
                                for e in other)
                            for t, (other, _) in enumerate(lists) if t != sp)
                if r < k:
                    out_s[i, r], out_i[i, r] = v, j
        out_c[i] = sum(c for _, c in lists)
    return out_s, out_i, out_c


def _inputs(m, n, seed, dist=0.2, theta=-np.inf, tie_levels=None,
            n_queries=1, sorted_keys=False):
    rng = np.random.default_rng(seed)
    lo_a, lo_b = rng.random((m, 2)), rng.random((n, 2))
    a = np.concatenate([lo_a, lo_a + rng.random((m, 2)) * 0.05], 1)
    b = np.concatenate([lo_b, lo_b + rng.random((n, 2)) * 0.05], 1)
    if tie_levels:
        dk = rng.integers(0, tie_levels, m) / tie_levels
        vk = rng.integers(0, tie_levels, n) / tie_levels
    else:
        dk, vk = rng.random(m), rng.random(n)
    if sorted_keys:                      # the stream join's order
        vk = -np.sort(-vk)
    return (a.astype(np.float32), b.astype(np.float32),
            dk.astype(np.float32), vk.astype(np.float32),
            np.full(m, dist, np.float32), np.full(m, theta, np.float32),
            rng.integers(0, n_queries, m).astype(np.int32),
            rng.integers(0, n_queries, n).astype(np.int32))


def _plain(inputs, k):
    return [x.numpy() for x in ref.fused_topk_join_ref(
        *(torch.from_numpy(x) for x in inputs), k)]


def _pallas(inputs, k):
    a, b, dk, vk, dist, theta, rq, cq = inputs
    return [np.asarray(x) for x in ftj.fused_topk_join(
        *(jnp.asarray(x) for x in (a, b, dk, vk, dist, theta)), k=k,
        row_qid=jnp.asarray(rq), col_qid=jnp.asarray(cq), interpret=True)]


def _assert_same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


# (M, N, k, splits, width, input options): M = 1, N below one warp step,
# ties straddling split boundaries (keys on a 1/4 grid, splits of 32 or 64
# columns), overflowed counts (k below the survivors), sorted driven keys
# (the append path) and unsorted ones, mixed qids
MODEL_CASES = {
    "one_row": (1, 90, 8, 3, 32, dict(tie_levels=4)),
    "below_one_step": (12, 20, 4, 1, 32, dict(dist=0.5)),
    "ties_across_splits": (24, 256, 16, 4, 64, dict(tie_levels=4, dist=0.4)),
    "overflow": (20, 200, 3, 3, 96, dict(dist=0.6)),
    "sorted_keys": (16, 300, 40, 2, 160, dict(sorted_keys=True, dist=0.5)),
    "unsorted_keys": (16, 300, 40, 5, 64, dict(dist=0.5)),
    "mixed_qids": (30, 180, 12, 3, 64, dict(n_queries=3, dist=0.4)),
    "k_above_n": (6, 40, 100, 2, 32, dict(dist=0.7)),
}


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_split_merge_model_equals_plain_and_pallas(case):
    m, n, k, splits, width, opts = MODEL_CASES[case]
    inputs = _inputs(m, n, seed=len(case), **opts)
    paths = {"append": 0, "sort": 0, "merge": 0}
    got = kernel_model(inputs, k, splits, width, paths)
    want = _plain(inputs, k)
    _assert_same(got, want)
    _assert_same(got, _pallas(inputs, k))
    counts = want[2]
    if case == "overflow":
        assert (counts > k).any()
    if case == "ties_across_splits":
        tied = (want[0][:, 1:] == want[0][:, :-1]) & (want[1][:, 1:] >= 0)
        crosses = (want[1][:, :-1] // width) != (want[1][:, 1:] // width)
        assert (tied & crosses).any()
    if case == "sorted_keys":
        assert paths["append"] > 0 and paths["sort"] == 0
        assert paths["merge"] == 0
    if case == "unsorted_keys":
        assert paths["sort"] > 0 and paths["merge"] > 0


def test_split_merge_model_with_per_row_theta_and_distance():
    """Per-row θ and distance, padding qids that never match, the plan's
    own splits."""
    inputs = list(_inputs(40, 500, seed=7, tie_levels=8, n_queries=2))
    rng = np.random.default_rng(8)
    inputs[4] = rng.uniform(0.05, 0.4, 40).astype(np.float32)
    inputs[5] = np.where(rng.random(40) < 0.5, -np.inf,
                         rng.uniform(0.4, 1.2, 40)).astype(np.float32)
    inputs[6][:3], inputs[7][:5] = -1, -2
    for k in (1, 7, 64):
        _, splits, width = ops.fused_plan(40, 500, k)
        want = _plain(inputs, k)
        _assert_same(kernel_model(inputs, k, splits, width), want)
        _assert_same(kernel_model(inputs, k, 8, 64), want)
        _assert_same(want, _pallas(inputs, k))


@pytest.mark.parametrize("scale", [0.0, 1e-40, 1e-25, 1e-6, 1.0, 1e6,
                                   1e19, 3e38])
def test_sqrt_threshold_is_exact(scale):
    """v <= sqrt_threshold(d) exactly when the rounded sqrt(v) <= d, for v
    at and around the threshold (a few ulps each way), 0, inf and NaN,
    over distances at every scale, with 0, -1, NaN and inf."""
    rng = np.random.default_rng(abs(int(np.log2(scale))) if scale else 0)
    with np.errstate(over="ignore"):       # 3e38 * 4 is inf: one more case
        dists = np.float32(scale) * rng.random(200).astype(np.float32) * 4
    dists = np.concatenate([dists, np.float32([0, -1, np.nan, np.inf,
                                               scale])]).astype(np.float32)
    for d in dists:
        m = sqrt_threshold(d)
        vs = [np.float32(0), np.float32(np.inf), np.float32(np.nan)]
        if np.isfinite(m) and m >= 0:
            vs += [_step(m, u) for u in range(-3, 4) if _step(m, u) >= 0]
        v = np.array(vs, np.float32)
        with np.errstate(invalid="ignore", over="ignore"):
            np.testing.assert_array_equal(np.sqrt(v) <= d, v <= m)


def test_kernel_distance_test_equals_the_plain_predicate():
    """The kernel's squared form against its threshold gives the plain
    version's `box_min_dist <= dist` on every pair, NaN boxes included."""
    rng = np.random.default_rng(21)
    for scale in (1e-30, 1e-3, 1.0, 1e30):
        lo = rng.normal(size=(300, 2)) * scale
        boxes = np.concatenate([lo, lo + rng.random((300, 2)) * scale * 0.1],
                               1).astype(np.float32)
        boxes[:5, 0] = np.nan
        a, b = boxes[:100], boxes[100:]
        dist = (rng.random(100) * scale).astype(np.float32)
        dist[:6] = [0.0, -1.0, np.nan, np.inf, 1e-30, 2.0 ** -61]
        want = ref.distance_join_ref(torch.from_numpy(a),
                                     torch.from_numpy(b)).numpy() \
            <= dist[:, None]
        with np.errstate(invalid="ignore", over="ignore"):
            got = box_gap_sq(a, b) <= np.array(
                [sqrt_threshold(x) for x in dist], np.float32)[:, None]
        np.testing.assert_array_equal(got, want)
        assert want.any() or scale != 1.0


# the shapes the STREAK main path launches (lgd and scale1m), a synthetic
# one, and the edges of k
PLAN_SHAPES = [(61, 3333, 100), (70, 2109, 100), (49, 2, 100),
               (515, 4096, 100), (2116, 338, 100), (1024, 4096, 100),
               (1, 1, 1), (1, 5000, 8192), (300, 100_000, 1024), (7, 0, 5)]


@pytest.mark.parametrize("m,n,k", PLAN_SHAPES)
def test_fused_plan_covers_the_columns_and_fits_the_card(m, n, k):
    rows, splits, width = ops.fused_plan(m, n, k)
    assert rows in (1, 2, 4) and 1 <= splits <= ops.FUSED_MAX_SPLITS
    assert 2 * ops.FUSED_TILE * 24 + rows * (k * 8 + 264) <= ops.FUSED_SMEM
    if n:
        assert width % 32 == 0 and (splits - 1) * width < n <= splits * width
        assert splits == 1 or width >= ops.FUSED_TILE - 32
    if -(-m // rows) * splits < ops.FUSED_WAVE_BLOCKS:
        # fewer blocks than two waves only where the columns allow no more
        # splits
        assert splits >= min(ops.FUSED_MAX_SPLITS,
                             max(1, n // ops.FUSED_TILE)) - 1


# ------------------------------------------------- grouped refinement ------
GROUPS = {
    2: [(33, 1, 1), (40, 2, 8), (17, 8, 8), (9, 16, 4), (11, 4, 32),
        (6, 32, 32), (5, 128, 16), (3, 128, 128), (4, 1, 128)],
    3: [(21, 1, 4), (13, 8, 8), (7, 32, 16), (3, 64, 128)],
}


def _packed(dims, seed):
    rng = np.random.default_rng(seed)
    group = ops.min_core_group(dims, GROUPS[dims])
    buf = group.pack()
    for g in range(len(GROUPS[dims])):
        for p in group.planes(buf, g):
            p[:] = rng.uniform(-1, 1, p.shape)
    return group, buf


@pytest.mark.parametrize("dims", [2, 3])
def test_grouped_refinement_matches_pallas_bucket_by_bucket(dims):
    group, buf = _packed(dims, seed=dims)
    got = ops.bucketed_min_core_group(torch.from_numpy(buf), group).numpy()
    assert got.shape == (sum(s[0] for s in GROUPS[dims]),)
    for g in range(len(GROUPS[dims])):
        a, b = group.planes(buf, g)
        want = gr.bucketed_min_core(tuple(jnp.asarray(p) for p in a),
                                    tuple(jnp.asarray(p) for p in b),
                                    bb=32, interpret=True)
        assert_within_ulp(got[group.rows(g)], np.asarray(want),
                          ulps=dims - 1)
        d = a[:, :, :, None] - b[:, :, None, :]
        v = d[0] * d[0]
        for dd in range(1, dims):
            v = v + d[dd] * d[dd]
        np.testing.assert_array_equal(got[group.rows(g)], v.min(axis=(1, 2)))


def test_grouped_refinement_layout_and_descriptors():
    group = ops.min_core_group(2, GROUPS[2])
    layouts = [ops.min_core_layout(m, n) for _, m, n in GROUPS[2]]
    assert layouts == ["thread", "thread", "thread", "thread", "warp",
                       "warp", "block", "block", "block"]
    per_block = [ops.MIN_CORE_LAYOUTS[x][1] for x in layouts]
    blocks = [-(-nb // p) for (nb, _, _), p in zip(GROUPS[2], per_block)]
    np.testing.assert_array_equal(group.desc[:, 6],
                                  np.cumsum([0] + blocks[:-1]))
    assert group.n_blocks == sum(blocks)
    assert group.n_floats == sum(2 * nb * (m + n) for nb, m, n in GROUPS[2])
    buf = group.pack()
    np.testing.assert_array_equal(
        buf[:group.header].view(np.int32).reshape(group.desc.shape),
        group.desc)
    with pytest.raises(ValueError, match="pads"):
        ops.min_core_group(2, [(4, 256, 1)])
    with pytest.raises(ValueError, match="dims"):
        ops.min_core_group(4, [(4, 1, 1)])


def test_single_bucket_is_a_group_of_one_on_the_cpu():
    rng = np.random.default_rng(9)
    a = torch.from_numpy(rng.uniform(-1, 1, (2, 50, 8)).astype(np.float32))
    b = torch.from_numpy(rng.uniform(-1, 1, (2, 50, 4)).astype(np.float32))
    group = ops.min_core_group(2, [(50, 8, 4)])
    buf = group.pack()
    pa, pb = group.planes(buf, 0)
    pa[:], pb[:] = a.numpy(), b.numpy()
    ops.reset_launch_counts()
    assert torch.equal(ops.bucketed_min_core(a, b),
                       ops.bucketed_min_core_group(torch.from_numpy(buf),
                                                   group))
    assert ops.LAUNCHES["bucketed_min_core"] == 0
