"""Port vs reference, kernel by kernel: each plain torch version in
`repro_torch.kernels.ref` against the reference's Pallas kernel run in
interpret mode, on the same numpy inputs.

Counts, indices, masks and fused scores (one f32 add) must be equal. f32
distances and refinement cores may differ by one ulp per contracted add: the
port computes ``v = a*a; v = v + b*b [; v = v + c*c]`` with every step
rounded, while XLA:CPU contracts the jitted reference into fused
multiply-adds (``fma(d0, d0, d1*d1)``), one per added term — 1 ulp for
distances and 2-d cores, 2 ulps for 3-d cores. The port's values must also
equal the unfused numpy formula exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import distance_join as dj
from repro.kernels import fused_topk_join as ftj
from repro.kernels import geom_refine as gr
from repro.kernels import ops as rops
from repro.kernels import tree_descend as td
from repro_torch.kernels import ops, ref


def _boxes(rng, n):
    pts = rng.random((n, 2)).astype(np.float32)
    wh = rng.random((n, 2)).astype(np.float32) * 0.05
    return np.concatenate([pts, pts + wh], axis=1)


def assert_within_ulp(got, want, ulps=1):
    """f32 arrays of non-negative values equal to within `ulps` units in
    the last place (order-preserving int view of the bits)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert (np.isinf(got) == np.isinf(want)).all()
    diff = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert diff.max(initial=0) <= ulps, f"max ulp diff {diff.max()}"


def _np_box_min_dist(a, b):
    """The unfused f32 formula in numpy (one rounding per step)."""
    a, b = a[:, None, :], b[None, :, :]
    dx = np.maximum(np.float32(0), np.maximum(a[..., 0] - b[..., 2],
                                              b[..., 0] - a[..., 2]))
    dy = np.maximum(np.float32(0), np.maximum(a[..., 1] - b[..., 3],
                                              b[..., 1] - a[..., 3]))
    v = dx * dx
    v = v + dy * dy
    return np.sqrt(v)


# --------------------------------------------------------- distance join ---
@pytest.mark.parametrize("m,n", [(8, 8), (100, 260), (300, 513)])
def test_distance_join_plain_matches_pallas(m, n):
    rng = np.random.default_rng(0)
    a, b = _boxes(rng, m), _boxes(rng, n)
    got = ops.distance_join(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = dj.distance_join(jnp.asarray(a), jnp.asarray(b), bm=128, bn=128,
                            interpret=True)
    assert_within_ulp(got, np.asarray(want))
    np.testing.assert_array_equal(got, _np_box_min_dist(a, b))


# ----------------------------------------------------- fused top-k join -----
def _fused_inputs(m, n, seed, dist, theta, tie_levels=None, n_queries=1):
    rng = np.random.default_rng(seed)
    a, b = _boxes(rng, m), _boxes(rng, n)
    if tie_levels:      # few distinct keys: many equal bounds per row
        dk = (rng.integers(0, tie_levels, m) / tie_levels).astype(np.float32)
        vk = (rng.integers(0, tie_levels, n) / tie_levels).astype(np.float32)
    else:
        dk = rng.random(m).astype(np.float32)
        vk = rng.random(n).astype(np.float32)
    dist_r = np.broadcast_to(np.float32(dist), (m,)).copy()
    theta_r = np.broadcast_to(np.float32(theta), (m,)).copy()
    rq = rng.integers(0, n_queries, m).astype(np.int32)
    cq = rng.integers(0, n_queries, n).astype(np.int32)
    return a, b, dk, vk, dist_r, theta_r, rq, cq


def _fused_both(inputs, k):
    a, b, dk, vk, dist, theta, rq, cq = inputs
    got = ops.fused_topk_join(*(torch.from_numpy(x) for x in inputs[:6]), k=k,
                              row_qid=torch.from_numpy(rq),
                              col_qid=torch.from_numpy(cq))
    want = ftj.fused_topk_join(
        *(jnp.asarray(x) for x in (a, b, dk, vk, dist, theta)), k=k,
        row_qid=jnp.asarray(rq), col_qid=jnp.asarray(cq), interpret=True)
    return [x.numpy() for x in got], [np.asarray(x) for x in want]


def _assert_fused_equal(got, want):
    (gs, gi, gc), (ws, wi, wc) = got, want
    np.testing.assert_array_equal(gc, wc)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gs, ws)
    assert gs.dtype == np.float32 and gi.dtype == np.int32 \
        and gc.dtype == np.int32


@pytest.mark.parametrize("m,n", [(8, 8), (100, 260), (300, 513)])
def test_fused_plain_matches_pallas_ragged(m, n):
    """M, N not multiples of the TPU tiles: padding never surfaces."""
    _assert_fused_equal(*_fused_both(
        _fused_inputs(m, n, 11, 0.15, -np.inf), k=8))


def test_fused_plain_k_exceeds_survivors():
    got, want = _fused_both(_fused_inputs(64, 64, 11, 0.1, -np.inf), k=200)
    _assert_fused_equal(got, want)
    gs, gi, gc = got
    assert gc.max() < 200
    padded = gs == -np.inf
    assert (gi[padded] == -1).all()
    np.testing.assert_array_equal((~padded).sum(axis=1), gc)


def test_fused_plain_overflow_counts():
    got, want = _fused_both(_fused_inputs(60, 500, 11, 0.5, -np.inf), k=4)
    _assert_fused_equal(got, want)
    assert (got[2] > 4).any()           # wide dist: rows overflow k


@pytest.mark.parametrize("theta", [-np.inf, 0.9, 1.6, np.inf])
def test_fused_plain_theta_sweep(theta):
    got, want = _fused_both(_fused_inputs(100, 150, 12, 0.2, theta), k=16)
    _assert_fused_equal(got, want)
    if theta == np.inf:
        assert got[2].sum() == 0 and (got[1] == -1).all()


@pytest.mark.parametrize("k", [3, 64])
def test_fused_plain_ties_go_to_lowest_column(k):
    """Quantized keys make many equal bounds; both keep column order."""
    got, want = _fused_both(
        _fused_inputs(90, 300, 13, 0.3, -np.inf, tie_levels=4), k=k)
    _assert_fused_equal(got, want)
    gs, gi, _ = got
    tied = (gs[:, 1:] == gs[:, :-1]) & (gs[:, 1:] > -np.inf)
    assert tied.any()
    assert (gi[:, 1:][tied] > gi[:, :-1][tied]).all()


def test_fused_plain_mixed_qids_and_per_row_thresholds():
    a, b, dk, vk, dist, theta, rq, cq = _fused_inputs(
        120, 400, 14, 0.2, -np.inf, n_queries=3)
    rng = np.random.default_rng(15)
    dist = rng.uniform(0.05, 0.3, 120).astype(np.float32)
    theta = np.where(rng.random(120) < 0.5, -np.inf,
                     rng.uniform(0.5, 1.5, 120)).astype(np.float32)
    rq[:5], cq[:7] = -1, -2              # padding qids never match
    got, want = _fused_both((a, b, dk, vk, dist, theta, rq, cq), k=16)
    _assert_fused_equal(got, want)
    gi = got[1]
    rows = np.nonzero(gi >= 0)[0]
    assert (rq[rows] == cq[gi[gi >= 0]]).all()


# ------------------------------------------------- bucketed geometry refine --
def _planes(rng, nb, w, dims):
    return np.stack([rng.uniform(-1, 1, (nb, w)).astype(np.float32)
                     for _ in range(dims)])


@pytest.mark.parametrize("m_pad,n_pad", [(1, 1), (4, 8), (32, 32), (8, 128)])
@pytest.mark.parametrize("dims", [2, 3])
def test_bucketed_plain_matches_pallas(m_pad, n_pad, dims):
    rng = np.random.default_rng(20)
    a, b = _planes(rng, 70, m_pad, dims), _planes(rng, 70, n_pad, dims)
    got = ops.bucketed_min_core(torch.from_numpy(a),
                                torch.from_numpy(b)).numpy()
    want = gr.bucketed_min_core(tuple(jnp.asarray(p) for p in a),
                                tuple(jnp.asarray(p) for p in b),
                                bb=32, interpret=True)
    assert_within_ulp(got, np.asarray(want), ulps=dims - 1)
    d = a[:, :, :, None] - b[:, :, None, :]          # (dims, B, m, n)
    v = d[0] * d[0]
    for dd in range(1, dims):
        v = v + d[dd] * d[dd]
    np.testing.assert_array_equal(got, v.min(axis=(1, 2)))


# ------------------------------------------------------------ tree descent --
@pytest.mark.parametrize("nb,m", [(1, 5), (3, 40), (8, 130)])
def test_tree_descend_plain_matches_pallas(nb, m):
    from repro_torch.data import synth_rdf
    tree = synth_rdf.make_lgd(n_per_class=100, seed=0).store.tree
    rng = np.random.default_rng(30)
    n = tree.n_nodes
    node_keys = ops.f64_sort_keys(np.ascontiguousarray(tree.node_mbr.T))
    lo = rng.random((nb, m, 2))
    boxes = np.concatenate([lo, lo + rng.random((nb, m, 2)) * 0.05], axis=2)
    box_keys = ops.f64_sort_keys(boxes)
    box_keys[:, ::7] = ops.DESCEND_PAD_BOX           # padding rows
    cs = rng.random(n) < 0.8
    got = ops.tree_descend(torch.from_numpy(node_keys), torch.from_numpy(cs),
                           torch.from_numpy(box_keys)).numpy()
    n_hi, n_lo = rops.split_key_planes(node_keys)
    b_hi, b_lo = rops.split_key_planes(box_keys)
    want = np.asarray(td.tree_descend(
        jnp.asarray(n_hi), jnp.asarray(n_lo), jnp.asarray(cs.astype(np.int32)),
        jnp.asarray(b_hi), jnp.asarray(b_lo), bm=64, nt=128,
        interpret=True)) != 0
    np.testing.assert_array_equal(got, want)
    assert got.any() and not got.all()


# ------------------------------------------------------- wrapper dispatch --
def test_cpu_tensors_run_the_plain_version_and_count_no_launch():
    ops.reset_launch_counts()
    rng = np.random.default_rng(40)
    a, b = torch.from_numpy(_boxes(rng, 10)), torch.from_numpy(_boxes(rng, 12))
    ops.distance_join(a, b)
    ops.fused_topk_join(a, b, torch.zeros(10), torch.zeros(12),
                        torch.full((10,), 0.1), torch.full((10,), -np.inf),
                        k=4)
    assert all(v == 0 for v in ops.LAUNCHES.values())


def test_other_devices_and_mixed_devices_raise():
    a = torch.zeros((4, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.distance_join(a, a)
    with pytest.raises(ValueError, match="several devices"):
        ops.distance_join(torch.zeros((4, 4)), a)


def test_plain_fused_is_deterministic_on_ties():
    """The plain fused version breaks ties by a stable sort, so it is
    deterministic on equal keys (torch.topk does not fix their order)."""
    inputs = _fused_inputs(32, 600, 16, 0.5, -np.inf, tie_levels=2)
    t = [torch.from_numpy(x) for x in inputs]
    first = ref.fused_topk_join_ref(*t, 50)
    second = ref.fused_topk_join_ref(*t, 50)
    for x, y in zip(first, second):
        assert torch.equal(x, y)


# ------------------------------------------- spatial-join layer, host side --
@pytest.mark.parametrize("dist", [0.02, 0.15])
@pytest.mark.parametrize("backend", ["numpy", "kernel", "fused"])
def test_mbr_distance_join_matches_reference(backend, dist):
    from repro.core import spatial_join as rsj
    from repro_torch.core import spatial_join as psj
    rng = np.random.default_rng(50)
    a = _boxes(rng, 90).astype(np.float64)
    b = _boxes(rng, 333).astype(np.float64)
    rstats, pstats = rsj.JoinStats(), psj.JoinStats()
    want = rsj.mbr_distance_join(a, b, dist, "numpy", rstats)
    got = psj.mbr_distance_join(a, b, dist, backend, pstats, device="cpu")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert pstats.candidates == rstats.candidates


def test_fused_topk_pairs_matches_reference():
    from repro.core import spatial_join as rsj
    from repro_torch.core import spatial_join as psj
    rng = np.random.default_rng(51)
    a = _boxes(rng, 70).astype(np.float64)
    b = _boxes(rng, 300).astype(np.float64)
    dk, vk = rng.random(70), rng.random(300)
    want = rsj.fused_topk_pairs(a, b, dk, vk, 0.25, k=6, batch_cols=48)
    got = psj.fused_topk_pairs(a, b, dk, vk, 0.25, k=6, batch_cols=48,
                               device="cpu")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("metric", ["euclid", "haversine"])
def test_pool_refine_matches_reference(metric):
    """Bucketed refinement over a CSR pool with fragmented geometries."""
    from repro.core import spatial_join as rsj
    from repro.core.store import GeomPool as RPool
    from repro_torch.core import spatial_join as psj
    from repro_torch.core.store import GeomPool as PPool
    rng = np.random.default_rng(52)
    sizes = rng.choice([2, 140], 60)           # > 128 points: fragmented
    geoms = [np.stack([rng.uniform(-170, 170, s), rng.uniform(-80, 80, s)],
                      axis=1) for s in sizes]
    rp, pp = RPool.from_lists(geoms), PPool.from_lists(geoms)
    ra, rb = rng.integers(0, 61, 400), rng.integers(0, 61, 400)
    want = rsj.pool_min_dist(rp, ra, rb, metric)
    got = psj.pool_min_dist(pp, ra, rb, metric, device="cpu")
    # 2 ulps of the f32 core at most (3-d), halved by the square root
    np.testing.assert_allclose(got, want, rtol=2.0 ** -22, atol=0)
    thr = float(np.median(want))
    np.testing.assert_array_equal(
        psj.refine(None, None, pp, ra, rb, thr, metric, device="cpu"),
        rsj.refine(None, None, rp, ra, rb, thr, metric))
