"""The port's CUDA kernels on the card: each one bit-identical to its plain
torch version, launch counts that move only on a kernel launch, and the
engine on CUDA answering exactly as on the CPU, top-k queries and the
Geographica shapes alike.

Every test here needs an NVIDIA GPU and nvcc; elsewhere they skip. On the
card: ``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import BackendPolicy, ExecConfig, StreakEngine, Var
from repro_torch.data import synth_rdf
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _boxes(rng, n, dev):
    lo = rng.random((n, 2))
    b = np.concatenate([lo, lo + rng.random((n, 2)) * 0.05], axis=1)
    return torch.from_numpy(b.astype(np.float32)).to(dev)


def _equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.parametrize("m,n", [(1, 1), (37, 300), (300, 1000),
                                 (33, 1027), (1024, 4096)])
def test_distance_join_kernel_matches_plain(dev, m, n):
    rng = np.random.default_rng(0)
    a, b = _boxes(rng, m, dev), _boxes(rng, n, dev)
    _equal([ops.distance_join(a, b)], [ref.distance_join_ref(a, b)])


def _pair_inputs(dev, m, n, case):
    rng = np.random.default_rng(m + 7 * n)
    a, b = _boxes(rng, m, dev), _boxes(rng, n, dev)
    dist = 0.03
    if case == "nan_boxes":
        a[::3, 2] = float("nan")
        b[1::4, 1] = float("nan")
    elif case == "none_pass":
        dist = -1.0
    elif case == "at_a_distance":      # the 1% quantile of the distances
        d = ref.distance_join_ref(a, b).flatten().sort().values
        dist = float(d[d.numel() // 100])
    return a, b, dist


@pytest.mark.parametrize("case", ["random", "at_a_distance", "nan_boxes",
                                  "none_pass"])
@pytest.mark.parametrize("m,n", [(1, 1), (31, 33), (61, 3333),
                                 (523, 8954)])
def test_distance_join_pairs_kernel_matches_plain(dev, m, n, case):
    a, b, dist = _pair_inputs(dev, m, n, case)
    launches = ops.LAUNCHES["distance_join"]
    got = ops.distance_join_pairs(a, b, dist)
    assert ops.LAUNCHES["distance_join"] == launches + 1
    want = ref.distance_join_pairs_ref(a, b, dist)
    for g, w in zip(got, want):
        assert g.dtype == np.int64
        np.testing.assert_array_equal(g, w.cpu().numpy())
    # host arrays, staged and copied up in the call, give the same pairs
    staged = ops.distance_join_pairs(a.cpu().numpy(), b.cpu().numpy(), dist,
                                     device=dev)
    for g, w in zip(staged, got):
        np.testing.assert_array_equal(g, w)
    if case == "at_a_distance":
        d = ref.distance_join_ref(a, b).cpu().numpy()
        assert len(got[0]) and (d[got] == np.float32(dist)).any()


def test_distance_join_pairs_capacity_retry(dev):
    """Every pair passes, more of them than the buffer holds: the call runs
    again with a buffer that fits, and truncates nothing."""
    n = 4096
    m = ops.pairs_capacity(dev) // n + 1
    rng = np.random.default_rng(12)
    a, b = _boxes(rng, m, dev), _boxes(rng, n, dev)
    retries = ops.pair_capacity_retries
    launches = ops.LAUNCHES["distance_join"]
    i, j = ops.distance_join_pairs(a, b, 4.0)
    assert ops.pair_capacity_retries == retries + 1
    assert ops.LAUNCHES["distance_join"] == launches + 2
    assert ops.pairs_capacity(dev) >= m * n
    np.testing.assert_array_equal(i, np.repeat(np.arange(m), n))
    np.testing.assert_array_equal(j, np.tile(np.arange(n), m))
    # the buffer now fits: no retry
    ops.distance_join_pairs(a, b, 4.0)
    assert ops.pair_capacity_retries == retries + 1


@pytest.mark.parametrize("n_keys", [1, 5, 300, 600])
@pytest.mark.parametrize("w", [8, 16, 32])
@pytest.mark.parametrize("k", [2, 3, 4])
def test_bloom_probe_any_kernel_matches_plain(dev, w, k, n_keys):
    from repro_torch.core.charsets import BloomBank
    rng = np.random.default_rng(w * k + n_keys)
    bank = BloomBank.empty(300, words=w, k=k)
    ins = rng.integers(0, 1 << 62, 900, dtype=np.int64)
    bank.add(rng.integers(0, 300, 900), ins)
    keys = np.concatenate([ins[:min(3, n_keys)], rng.integers(
        -(1 << 63), -1, n_keys - min(3, n_keys), dtype=np.int64)])
    fi = rng.integers(0, 300, 1303)
    bits = bank.device_bits(dev)
    launches = ops.LAUNCHES["bloom_probe"]
    got = ops.bloom_probe_any(bits, fi, keys, k)
    assert ops.LAUNCHES["bloom_probe"] == launches + 1
    want = ref.bloom_probe_any_ref(bits, torch.from_numpy(fi).to(dev),
                                   torch.from_numpy(keys).to(dev), k)
    np.testing.assert_array_equal(got, want.cpu().numpy())
    np.testing.assert_array_equal(got, bank.contains_any_batch(
        fi, bank.prepare(keys), "numpy"))
    assert got.any()


def test_bloom_bank_resident_copy_refreshed_after_add(dev):
    from repro_torch.core.charsets import BloomBank
    rng = np.random.default_rng(13)
    bank = BloomBank.empty(500, words=8, k=3)
    bank.add(rng.integers(0, 500, 2000), rng.integers(0, 1 << 62, 2000))
    key = np.array([(1 << 62) + 99], dtype=np.int64)
    prep = bank.prepare(key)
    uploads = ops.bloom_bank_uploads
    first = bank.contains_any_batch(np.arange(500), prep, "kernel", dev)
    bank.contains_any_batch(np.arange(500), prep, "kernel", dev)
    assert ops.bloom_bank_uploads == uploads + 1
    target = int(np.flatnonzero(~first)[0])
    bank.add(np.array([target]), key)
    after = bank.contains_any_batch(np.arange(500), prep, "kernel", dev)
    assert ops.bloom_bank_uploads == uploads + 2
    assert after[target]
    np.testing.assert_array_equal(
        after, bank.contains_any_batch(np.arange(500), prep, "numpy"))


@pytest.mark.parametrize("k", [1, 4, 100, 600])
@pytest.mark.parametrize("theta", [-np.inf, 0.8])
def test_fused_kernel_matches_plain(dev, k, theta):
    rng = np.random.default_rng(1)
    m, n = 200, 700
    a, b = _boxes(rng, m, dev), _boxes(rng, n, dev)
    dk = torch.from_numpy((rng.integers(0, 8, m) / 8).astype(np.float32))
    vk = torch.from_numpy((rng.integers(0, 8, n) / 8).astype(np.float32))
    rq = torch.from_numpy(rng.integers(0, 2, m).astype(np.int32)).to(dev)
    cq = torch.from_numpy(rng.integers(0, 2, n).astype(np.int32)).to(dev)
    args = (a, b, dk.to(dev), vk.to(dev),
            torch.full((m,), 0.2, device=dev),
            torch.full((m,), theta, device=dev))
    _equal(ops.fused_topk_join(*args, k=k, row_qid=rq, col_qid=cq),
           ref.fused_topk_join_ref(*args, rq, cq, k))


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("m_pad,n_pad", [(1, 1), (2, 64), (128, 16)])
def test_bucketed_kernel_matches_plain(dev, dims, m_pad, n_pad):
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.uniform(-1, 1, (dims, 77, m_pad))
                         .astype(np.float32)).to(dev)
    b = torch.from_numpy(rng.uniform(-1, 1, (dims, 77, n_pad))
                         .astype(np.float32)).to(dev)
    _equal([ops.bucketed_min_core(a, b)], [ref.bucketed_min_core_ref(a, b)])


def _fused_case(dev, m, n, seed, dist=0.2, tie_levels=None, sorted_keys=False,
                n_queries=1, per_row=False):
    rng = np.random.default_rng(seed)
    if tie_levels:
        dk = rng.integers(0, tie_levels, m) / tie_levels
        vk = rng.integers(0, tie_levels, n) / tie_levels
    else:
        dk, vk = rng.random(m), rng.random(n)
    if sorted_keys:                      # the stream join's order
        vk = -np.sort(-vk)
    dist_r = np.full(m, dist)
    theta = np.full(m, -np.inf)
    if per_row:
        dist_r = rng.uniform(0.5, 1.5, m) * dist
        theta = np.where(rng.random(m) < 0.5, -np.inf,
                         rng.uniform(0.3, 1.3, m))
    f32 = [torch.from_numpy(x.astype(np.float32)).to(dev)
           for x in (dk, vk, dist_r, theta)]
    rq = torch.from_numpy(rng.integers(0, n_queries, m).astype(np.int32))
    cq = torch.from_numpy(rng.integers(0, n_queries, n).astype(np.int32))
    return (_boxes(rng, m, dev), _boxes(rng, n, dev), *f32), rq.to(dev), \
        cq.to(dev)


# (M, N, k, case options): M = 1 over 8 column splits with ties on a 1/4
# key grid straddling split boundaries; N below one warp step and below one
# staged tile; the main path's largest lgd launch with sorted driven keys
# (the append path) and unsorted; k from 1 to FUSED_MAX_K with overflowed
# counts; mixed qids with per-row distance and theta
FUSED_CASES = {
    "m1_ties_across_splits": (1, 5000, 100, dict(tie_levels=4, dist=0.05)),
    "n_below_warp_step": (37, 20, 8, dict(dist=0.5)),
    "n_below_tile": (200, 250, 16, {}),
    "path_sorted": (61, 3333, 100, dict(sorted_keys=True)),
    "path_unsorted_ties": (61, 3333, 100, dict(tie_levels=8)),
    "k1_overflow": (515, 4096, 1, {}),
    "k1024_overflow": (64, 4096, 1024, dict(dist=0.6, tie_levels=16)),
    "k8192_overflow": (5, 20000, 8192, dict(dist=0.8)),
    "mixed_qids_per_row": (120, 3000, 100, dict(n_queries=3, per_row=True,
                                                 tie_levels=4)),
}


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_fused_redesign_matches_plain(dev, case):
    m, n, k, opts = FUSED_CASES[case]
    args, rq, cq = _fused_case(dev, m, n, seed=len(case), **opts)
    ops.reset_launch_counts()
    got = ops.fused_topk_join(*args, k=k, row_qid=rq, col_qid=cq)
    assert ops.LAUNCHES["fused_topk_join"] == 1
    want = ref.fused_topk_join_ref(*args, rq, cq, k)
    _equal(got, want)
    if "overflow" in case:
        assert bool((want[2] > k).any())
    if case == "m1_ties_across_splits":
        _, splits, width = ops.fused_plan(m, n, k)
        assert splits == ops.FUSED_MAX_SPLITS
        s, i = want[0][0], want[1][0]
        assert bool(((s[1:] == s[:-1]) & (i[1:] // width != i[:-1] // width)
                     & (i[1:] >= 0)).any())


REFINE_GROUPS = {   # (rows, m_pad, n_pad) buckets of one launch
    2: [(300, 1, 1), (77, 2, 8), (1024, 8, 8), (50, 16, 4), (40, 4, 32),
        (33, 32, 32), (20, 128, 16), (9, 128, 128), (12, 1, 128),
        (5, 3, 5)],
    3: [(210, 1, 4), (130, 8, 8), (70, 32, 16), (30, 64, 128)],
}


@pytest.mark.parametrize("dims", [2, 3])
def test_grouped_refinement_kernel_matches_plain(dev, dims):
    rng = np.random.default_rng(dims)
    group = ops.min_core_group(dims, REFINE_GROUPS[dims])
    buf = group.pack()
    for g in range(len(REFINE_GROUPS[dims])):
        for p in group.planes(buf, g):
            p[:] = rng.uniform(-1, 1, p.shape)
    t = torch.from_numpy(buf).to(dev)
    ops.reset_launch_counts()
    got = ops.bucketed_min_core_group(t, group)
    assert ops.LAUNCHES["bucketed_min_core"] == 1
    _equal([got], [ref.bucketed_min_core_group_ref(t, group.desc, dims)])


def test_tree_descend_kernel_matches_plain(dev):
    tree = synth_rdf.make_lgd(n_per_class=200, seed=0).store.tree
    rng = np.random.default_rng(3)
    nodes = torch.from_numpy(ops.f64_sort_keys(
        np.ascontiguousarray(tree.node_mbr.T))).to(dev)
    lo = rng.random((5, 300, 2))
    keys = ops.f64_sort_keys(np.concatenate([lo, lo + 0.03], axis=2))
    keys[:, 290:] = ops.DESCEND_PAD_BOX
    boxes = torch.from_numpy(keys).to(dev)
    cs = torch.from_numpy(rng.random(tree.n_nodes) < 0.7).to(dev)
    _equal([ops.tree_descend(nodes, cs, boxes)],
           [ref.tree_descend_ref(nodes, cs, boxes)])


def test_launch_counts_move_only_on_kernel_launches(dev):
    rng = np.random.default_rng(4)
    ops.reset_launch_counts()
    a, b = _boxes(rng, 8, dev), _boxes(rng, 9, dev)
    ops.distance_join(a, b)
    ops.distance_join(a.cpu(), b.cpu())
    assert ops.LAUNCHES["distance_join"] == 1
    with pytest.raises(ValueError, match="several devices"):
        ops.distance_join(a, b.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        ops.distance_join(a.t().contiguous().t(), b)


@pytest.mark.parametrize("w", [8, 16, 32])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_bloom_probe_kernel_matches_plain(dev, w, k):
    from repro_torch.core.charsets import BloomBank
    rng = np.random.default_rng(5)
    bank = BloomBank.empty(64, words=w, k=k)
    ins = rng.integers(0, 1 << 62, 500, dtype=np.int64)
    ins_f = rng.integers(0, 64, 500)
    bank.add(ins_f, ins)
    keys = np.concatenate([ins, rng.integers(-(1 << 63), -1, 777,
                                             dtype=np.int64)])
    fi = np.concatenate([ins_f, rng.integers(0, 64, 777)])
    rows = torch.from_numpy(bank.bits[fi]).to(dev)
    kt = torch.from_numpy(keys).to(dev)
    got = ops.bloom_probe(rows, kt, k)
    _equal([got], [ref.bloom_probe_ref(rows, kt, k)])
    assert bool(got[:500].all())


def test_bloom_probe_kernel_rejects_unsupported_rows(dev):
    keys = torch.zeros(4, dtype=torch.int64, device=dev)
    with pytest.raises(ValueError, match="W in"):
        ops.bloom_probe(torch.zeros((4, 12), dtype=torch.int32,
                                    device=dev), keys, 3)
    with pytest.raises(ValueError, match="k >= 1"):
        ops.bloom_probe(torch.zeros((4, 8), dtype=torch.int32,
                                    device=dev), keys, 0)


@pytest.mark.parametrize("side", ["both", "left", "right"])
@pytest.mark.parametrize("n,m", [(1, 1), (2, 300), (1000, 33),
                                 (4097, 4096), (100_003, 7)])
def test_rank_kernel_matches_plain(dev, n, m, side):
    rng = np.random.default_rng(n + m)
    table = np.sort(np.repeat(rng.integers(-(1 << 40), 1 << 40, n),
                              rng.integers(1, 4, n))[:n])
    probes = rng.integers(-(1 << 41), 1 << 41, m)
    probes[: m // 2] = rng.choice(table, m // 2)
    t = torch.from_numpy(table).to(dev)
    p = torch.from_numpy(probes).to(dev)
    got = ops.insertion_ranks(t, p, side)
    want = ref.merge_join_ranks_ref(t, p, side)
    _equal(got if side == "both" else [got],
           want if side == "both" else [want])


def test_rank_kernel_empty_inputs_launch_nothing(dev):
    ops.reset_launch_counts()
    empty = torch.empty(0, dtype=torch.int64, device=dev)
    probes = torch.arange(5, dtype=torch.int64, device=dev)
    lo, hi = ops.insertion_ranks(empty, probes)
    assert not lo.any() and not hi.any() and lo.shape == (5,)
    assert ops.insertion_ranks(probes, empty, "left").shape == (0,)
    lo, hi = ops.merge_join_ranks(np.array([], np.int64), np.array([2, 9]),
                                  backend="kernel", device=dev)
    assert lo.tolist() == [0, 0] and hi.tolist() == [0, 0]
    assert ops.LAUNCHES["merge_join_ranks"] == 0
    lo, hi = ops.merge_join_ranks(np.arange(4), np.array([2, 9]),
                                  backend="kernel", device=dev)
    assert lo.tolist() == [2, 4] and hi.tolist() == [3, 4]
    assert ops.LAUNCHES["merge_join_ranks"] == 1


I64_MIN, I64_MAX = -(1 << 63), (1 << 63) - 1


def _rank_edge_case(name, rng):
    """(sorted table, probes) of one edge case of the rank kernel."""
    if name == "run_past_gallop_window":
        table = np.sort(np.concatenate([rng.integers(-500, 500, 3000),
                                        np.full(1000, 7), np.full(40, -3)]))
        probes = np.array([7, 6, 8, -3, -4, -2, 0, 499, -501, 501] * 7)
    elif name == "one_repeated_key":
        table = np.full(5000, 42)
        probes = np.array([42, 41, 43, I64_MIN, I64_MAX, 42, 42])
    elif name == "n_1":
        table = np.array([5])
        probes = np.arange(-40, 50, 3)
    elif name == "m_1":
        table = np.sort(rng.integers(-100, 100, 777))
        probes = np.array([table[300]])
    elif name == "m_below_32":
        table = np.sort(rng.integers(-100, 100, 777))
        probes = rng.integers(-120, 120, 17)
    elif name == "int64_extremes":
        table = np.sort(np.concatenate([
            [I64_MIN, I64_MIN, I64_MAX, I64_MAX, I64_MAX],
            rng.integers(I64_MIN, I64_MAX, 500, dtype=np.int64)]))
        probes = np.array([I64_MIN, I64_MIN + 1, I64_MAX, I64_MAX - 1, 0,
                           -1, 1] * 5)
    else:                   # "sorted_probes" / "unsorted_probes"
        table = np.sort(np.repeat(rng.integers(-5000, 5000, 6000),
                                  rng.integers(1, 5, 6000))[:6000])
        probes = rng.integers(-5100, 5100, 300)
        probes[:100] = rng.choice(table, 100)
        probes = np.sort(probes) if name == "sorted_probes" \
            else rng.permutation(probes)
    return table.astype(np.int64), probes.astype(np.int64)


RANK_EDGE_CASES = ["run_past_gallop_window", "one_repeated_key", "n_1",
                   "m_1", "m_below_32", "int64_extremes", "sorted_probes",
                   "unsorted_probes"]


@pytest.mark.parametrize("lanes", [1, 32, None])
@pytest.mark.parametrize("side", ["both", "left", "right"])
@pytest.mark.parametrize("case", RANK_EDGE_CASES)
def test_rank_kernel_edge_cases_match_plain(dev, case, side, lanes):
    """Both layouts of the rank kernel (a thread a probe, a warp a probe)
    and the wrapper's own choice, bit-for-bit against the plain version."""
    table, probes = _rank_edge_case(case, np.random.default_rng(7))
    t = torch.from_numpy(table).to(dev)
    p = torch.from_numpy(probes).to(dev)
    want = ref.merge_join_ranks_ref(t, p, side)
    want = list(want) if side == "both" else [want]
    if lanes is None:
        got = ops.insertion_ranks(t, p, side)
        got = list(got) if side == "both" else [got]
    else:
        out = torch.full((len(want), len(probes)), -7, dtype=torch.int64,
                         device=dev)
        ops._rank_launch(t, p, out, side, lanes)
        got = list(out)
    _equal(got, want)


@pytest.mark.parametrize("m", [1, 300, ops.RANK_WARP_MAX_M + 1])
def test_rank_round_trip_matches_numpy(dev, m):
    """`ops.merge_join_ranks` on CUDA (numpy in and out, one launch a
    call), with the table resident on the card and with it uploaded
    beside the probes."""
    rng = np.random.default_rng(m)
    table = np.sort(rng.integers(-(1 << 40), 1 << 40, 20_000))
    table[5000:5100] = table[5000]
    probes = rng.integers(-(1 << 41), 1 << 41, m)
    probes[: m // 2] = rng.choice(table, m // 2)
    resident = ops.device_table(table, dev)
    for side in ("both", "left", "right"):
        want = ops.merge_join_ranks(table, probes, "numpy", side)
        want = list(want) if side == "both" else [want]
        for on_dev in (resident, None):
            before = ops.LAUNCHES["merge_join_ranks"]
            got = ops.merge_join_ranks(table, probes, "kernel", side, dev,
                                       table_on_device=on_dev)
            got = list(got) if side == "both" else [got]
            assert ops.LAUNCHES["merge_join_ranks"] == before + 1
            for g, w in zip(got, want):
                assert isinstance(g, np.ndarray) and g.dtype == np.int64
                np.testing.assert_array_equal(g, w)


def _far_boxes(rng, nb, m):
    """(nb, m, 4) f64 boxes far outside the LGD tree's unit square."""
    lo = rng.random((nb, m, 2)) + 10.0
    return np.concatenate([lo, lo + 0.01], axis=2)


@pytest.fixture(scope="module")
def small_tree():
    return synth_rdf.make_lgd(n_per_class=200, seed=0).store.tree


@pytest.mark.parametrize("case", ["m_45", "m_1027", "m_2500",
                                  "only_padding", "no_live_node",
                                  "hit_by_last_box"])
def test_tree_descend_kernel_edge_cases_match_plain(dev, small_tree, case):
    tree = small_tree
    rng = np.random.default_rng(11)
    n = tree.n_nodes
    nodes = torch.from_numpy(ops.f64_sort_keys(
        np.ascontiguousarray(tree.node_mbr.T))).to(dev)
    cs_np = rng.random(n) < 0.8
    nb, m = 3, 300
    if case.startswith("m_"):
        m = int(case[2:])
        lo = rng.random((nb, m, 2))
        boxes = np.concatenate([lo, lo + 0.002], axis=2)
        boxes[:, m // 2:] += 10.0          # half the boxes hit nothing
    else:
        boxes = _far_boxes(rng, nb, m)
    keys = ops.f64_sort_keys(boxes)
    if case == "only_padding":
        keys[1] = ops.DESCEND_PAD_BOX
    if case == "no_live_node":
        cs_np[:] = False
        boxes = np.concatenate([rng.random((nb, m, 2))] * 2, axis=2)
        keys = ops.f64_sort_keys(boxes + np.array([0, 0, 0.05, 0.05]))
    if case == "hit_by_last_box":
        # a leaf's MBR is the last box of block 0; everything else is far
        leaf = int(np.flatnonzero(cs_np)[-1])
        keys[0, -1] = ops.f64_sort_keys(tree.node_mbr[leaf])
    cs = torch.from_numpy(cs_np).to(dev)
    boxes_t = torch.from_numpy(keys).to(dev)
    got = ops.tree_descend(nodes, cs, boxes_t)
    want = ref.tree_descend_ref(nodes, cs, boxes_t)
    _equal([got], [want])
    if case == "only_padding":
        assert not bool(got[1].any())
    if case == "no_live_node":
        assert not bool(got.any())
    if case == "hit_by_last_box":
        assert bool(got[0, leaf]) and not bool(got[1:].any())
    if case.startswith("m_"):
        assert bool(got.any())


@pytest.mark.parametrize("join", ["fused", "kernel"])
@pytest.mark.parametrize("probe_rank", ["numpy", "kernel"])
def test_engine_on_cuda_equals_cpu(dev, join, probe_rank, monkeypatch):
    """... and one refinement launch for each refinement call on the card
    that has pairs to refine."""
    from repro_torch.core import spatial_join
    ds = synth_rdf.make_lgd(n_per_class=300, seed=0)
    cfg = ExecConfig(policy=BackendPolicy(
        join=join, descend="kernel", probe=probe_rank, rank=probe_rank))
    refine_calls = [0]
    pool_min_dist = spatial_join.pool_min_dist

    def counting(pool, rows_a, rows_b, metric="euclid", device=None,
                 **kwargs):
        refine_calls[0] += len(rows_a) > 0 and torch.device(device).type \
            == "cuda"
        return pool_min_dist(pool, rows_a, rows_b, metric, device, **kwargs)

    monkeypatch.setattr(spatial_join, "pool_min_dist", counting)
    ops.reset_launch_counts()
    for q in ds.queries:
        got = StreakEngine(ds.store, cfg).execute(q)
        want = StreakEngine(ds.store, cfg, device="cpu").execute(q)
        np.testing.assert_array_equal(got[0], want[0])
        for c in want[1]:
            np.testing.assert_array_equal(got[1][c], want[1][c])
        assert dataclasses.asdict(got[2]) == dataclasses.asdict(want[2])
    assert ops.LAUNCHES["tree_descend"] > 0
    assert ops.LAUNCHES["bucketed_min_core"] == refine_calls[0] > 0
    assert ops.LAUNCHES["fused_topk_join" if join == "fused"
                        else "distance_join"] > 0
    for name in ("bloom_probe", "merge_join_ranks"):
        assert (ops.LAUNCHES[name] > 0) == (probe_rank == "kernel")


def test_full_scan_on_cuda_equals_cpu(dev, monkeypatch):
    """The full-scan oracle on the card answers as on the CPU over lgd
    Q1-Q8, refining through the grouped refinement kernel; its largest
    refinement launch, replayed, equals the plain version bit for bit."""
    from repro_torch.core.baselines import FullScanEngine
    ds = synth_rdf.make_lgd(n_per_class=600, seed=0, block=1024)
    group_call = ops.bucketed_min_core_group
    largest = {}

    def recording(buf, group):
        if group.n_rows > largest.get("rows", -1):
            largest.update(rows=group.n_rows, buf=buf.clone(), group=group)
        return group_call(buf, group)

    monkeypatch.setattr(ops, "bucketed_min_core_group", recording)
    ops.reset_launch_counts()
    for q in ds.queries:
        got = FullScanEngine(ds.store).execute(q)
        want = FullScanEngine(ds.store, device="cpu").execute(q)
        np.testing.assert_array_equal(got[0], want[0])
        for c in want[1]:
            np.testing.assert_array_equal(got[1][c], want[1][c])
        assert dataclasses.asdict(got[2]) == dataclasses.asdict(want[2])
    assert ops.LAUNCHES["bucketed_min_core"] > 0
    assert ops.LAUNCHES["merge_join_ranks"] == 0      # host ranks
    buf, group = largest["buf"], largest["group"]
    assert buf.is_cuda and largest["rows"] > 1000
    _equal([group_call(buf, group)],
           [ref.bucketed_min_core_group_ref(buf, group.desc, group.dims)])


@pytest.mark.parametrize("which", ["sync_rtree", "fixed_n", "fixed_s"])
def test_baseline_engines_on_cuda_equal_cpu(dev, which):
    from repro_torch.core.baselines import SyncRTreeEngine, fixed_plan_engine
    ds = synth_rdf.make_lgd(n_per_class=600, seed=0, block=1024)
    cfg = ExecConfig(policy=BackendPolicy(probe="kernel", rank="kernel",
                                          descend="kernel"))
    make = {"sync_rtree": lambda **kw: SyncRTreeEngine(ds.store, cfg, **kw),
            "fixed_n": lambda **kw: fixed_plan_engine(ds.store, "N", cfg,
                                                      **kw),
            "fixed_s": lambda **kw: fixed_plan_engine(ds.store, "S", cfg,
                                                      **kw)}[which]
    ops.reset_launch_counts()
    for q in ds.queries:
        got = make().execute(q)
        want = make(device="cpu").execute(q)
        np.testing.assert_array_equal(got[0], want[0])
        for c in want[1]:
            np.testing.assert_array_equal(got[1][c], want[1][c])
        assert dataclasses.asdict(got[2]) == dataclasses.asdict(want[2])
    assert ops.LAUNCHES["bucketed_min_core"] > 0
    assert ops.LAUNCHES["merge_join_ranks"] > 0


SHAPE_FILTERS = {      # hotels <-> parks, as in tests/test_torch_shapes.py
    "range": dict(b=None, window=(15.0, 10.0, 70.0, 60.0)),
    "within": dict(b=None, dist=18.0, center=(50.0, 30.0)),
    "join": dict(b=Var("g2"), dist=5.0),
    "knn4": dict(b=Var("g2"), knn=4),
    "knn_over": dict(b=Var("g2"), knn=10 ** 7),
}


def _shape_query(ds, name):
    ns, TP = ds.ns, repro_torch.TriplePattern
    pa, pb = Var("place"), Var("nplace")
    patterns = (
        TP(pa, Var("typePred1"), ns["class:hotel"], g=Var("r")),
        TP(Var("r"), ns["hasConfidence"], Var("conf")),
        TP(pa, ns["hasGeometry"], Var("g1")),
        TP(pb, Var("typePred2"), ns["class:park"], g=Var("r1")),
        TP(Var("r1"), ns["hasConfidence"], Var("conf1")),
        TP(pb, ns["hasGeometry"], Var("g2")))
    return repro_torch.Query(
        select=(pa, pb), patterns=patterns, ranking=None,
        spatial=repro_torch.SpatialFilter(Var("g1"), **SHAPE_FILTERS[name]))


@pytest.mark.parametrize("join", ["fused", "kernel", "numpy"])
def test_shapes_on_cuda_equal_cpu(dev, join):
    ds = synth_rdf.make_lgd(n_per_class=300, seed=0)
    cfg = ExecConfig(policy=BackendPolicy(
        join=join, descend="kernel", probe="kernel", rank="kernel"))
    ops.reset_launch_counts()
    for name in SHAPE_FILTERS:
        q = _shape_query(ds, name)
        got = StreakEngine(ds.store, cfg).execute(q)
        want = StreakEngine(ds.store, cfg, device="cpu").execute(q)
        np.testing.assert_array_equal(got[0], want[0])
        assert sorted(got[1].keys()) == sorted(want[1].keys())
        for c in want[1].keys():
            np.testing.assert_array_equal(got[1][c], want[1][c])
        assert dataclasses.asdict(got[2]) == dataclasses.asdict(want[2])
    for name in ("tree_descend", "bloom_probe", "merge_join_ranks",
                 "bucketed_min_core"):
        assert ops.LAUNCHES[name] > 0


# ----------------------------------------------- the serving loop's launches --
def test_fused_multi_qid_launch_with_sentinels_matches_plain(dev):
    """A cross-query launch as the serving loop builds it, with sentinel
    rows (dist -1, θ +inf, qid -1) and columns (key -inf, qid -2) beside
    three queries' rows and column spans: equal to the plain version, and
    the sentinels never survive."""
    rng = np.random.default_rng(12)
    parts = [(50, 300), (7, 300), (120, 200)]
    m_pad, n_pad = 23, 29
    m = sum(p[0] for p in parts) + m_pad
    n = sum(p[1] for p in parts) + n_pad
    a, b = _boxes(rng, m, dev), _boxes(rng, n, dev)
    rq = np.concatenate([np.full(r, q, np.int32)
                         for q, (r, _) in enumerate(parts)]
                        + [np.full(m_pad, -1, np.int32)])
    cq = np.concatenate([np.full(c, q, np.int32)
                         for q, (_, c) in enumerate(parts)]
                        + [np.full(n_pad, -2, np.int32)])
    dist = np.concatenate([np.full(r, 0.05 * (q + 1), np.float32)
                           for q, (r, _) in enumerate(parts)]
                          + [np.full(m_pad, -1.0, np.float32)])
    theta = np.concatenate([np.full(r, 0.3 * q, np.float32)
                            for q, (r, _) in enumerate(parts)]
                           + [np.full(m_pad, np.inf, np.float32)])
    dk = rng.random(m).astype(np.float32)
    dk[-m_pad:] = -np.inf
    vk = rng.random(n).astype(np.float32)
    vk[-n_pad:] = -np.inf
    args = (a, b) + tuple(torch.from_numpy(x).to(dev)
                          for x in (dk, vk, dist, theta))
    rq_t, cq_t = (torch.from_numpy(x).to(dev) for x in (rq, cq))
    for k in (8, 64, 256):
        got = ops.fused_topk_join(*args, k=k, row_qid=rq_t, col_qid=cq_t)
        _equal(got, ref.fused_topk_join_ref(*args, rq_t, cq_t, k))
        idx, counts = got[1].cpu().numpy(), got[2].cpu().numpy()
        assert (counts[-m_pad:] == 0).all()
        assert not np.isin(idx, np.arange(n - n_pad, n)).any()
        assert counts[:-m_pad].max() > 0


def test_pooled_candidate_nodes_two_cs_groups_match_per_block(dev):
    """The serving loop's pooled Phase 1: rows of two queries with
    different driven-CS sets in one call, one descent a group on the card,
    each row equal to its own call."""
    from repro_torch.core.planner import plan_query
    ds = synth_rdf.make_lgd(n_per_class=300, seed=0)
    tree = ds.store.tree
    plans = [plan_query(ds.store, q) for q in (ds.queries[0],
                                               ds.queries[3])]
    assert not np.array_equal(plans[0].driven_cs, plans[1].driven_cs)
    rng = np.random.default_rng(13)
    rows = [0, 1, 1, 0, 0, 1]
    boxes = [tree.obj_mbr[rng.integers(0, tree.n_objects, 3 + i)]
             for i in range(len(rows))]
    dists = np.array([plans[r].dist_norm for r in rows])
    paths = [tree.cs_path_mask(p.driven_cs, probe_backend="kernel",
                               device=dev) for p in plans]
    launches = ops.LAUNCHES["tree_descend"]
    got = tree.candidate_nodes(boxes, dists,
                               [plans[r].driven_cs for r in rows],
                               descend_backend="kernel", probe_backend="kernel",
                               cs_path=[paths[r] for r in rows], device=dev)
    assert ops.LAUNCHES["tree_descend"] == launches + 2
    assert got.any()
    for i, r in enumerate(rows):
        for device in (dev, "cpu"):
            np.testing.assert_array_equal(got[i], tree.candidate_nodes(
                boxes[i], float(dists[i]), plans[r].driven_cs,
                descend_backend="kernel", probe_backend="kernel",
                device=device))


@pytest.mark.parametrize("join", ["fused", "kernel"])
def test_hotq_serve_on_cuda_equals_cpu(dev, join):
    """Eight tenants on the hot query with per-tenant k through the serving
    loop on the card: every request and every counter equal to the CPU
    serve, every request equal to serial CUDA execution."""
    from repro_torch.serve.spatial import SpatialServeEngine
    ds = synth_rdf.make_lgd(n_per_class=300, seed=0)
    cfg = ExecConfig(policy=BackendPolicy(
        join=join, descend="kernel", probe="kernel", rank="kernel",
        kcap="auto" if join == "fused" else "fixed"))
    hot = [dataclasses.replace(ds.queries[0], k=k)
           for k in (5, 10, 20, 40, 60, 80, 100, 120)]
    ops.reset_launch_counts()
    srv = SpatialServeEngine(ds.store, cfg, max_slots=8)
    reqs = srv.serve(hot)
    launches = dict(ops.LAUNCHES)
    cpu = SpatialServeEngine(ds.store, cfg, max_slots=8, device="cpu")
    want = cpu.serve(hot)
    assert dataclasses.asdict(srv.stats) == dataclasses.asdict(cpu.stats)
    assert srv.stats.faults == srv.stats.failed_requests == 0
    for got, w, q in zip(reqs, want, hot):
        assert got.error is None and w.error is None
        np.testing.assert_array_equal(got.scores, w.scores)
        assert list(got.rows) == list(w.rows)
        for c in w.rows:
            np.testing.assert_array_equal(got.rows[c], w.rows[c])
        assert dataclasses.asdict(got.stats) == dataclasses.asdict(w.stats)
        serial = StreakEngine(ds.store, cfg).execute(q)
        np.testing.assert_array_equal(got.scores, serial[0])
    assert launches["tree_descend"] > 0
    assert launches["fused_topk_join" if join == "fused"
                    else "distance_join"] > 0
    if join == "fused":
        assert srv.stats.join_launches > 0



# ------------------------------------------ sharded descent and failover --
def _stacked(dev, sizes, nb, m, seed=0):
    """Stacked per-shard node planes (pad columns `DESCEND_PAD_BOX`, their
    root-path bits False), as core/shard keeps them: a transposed view of
    a contiguous (4, S, N_max) tensor; shared box keys with ragged
    padding rows."""
    rng = np.random.default_rng(seed)
    n_max = max(sizes)
    planes = np.empty((4, len(sizes), n_max), dtype=np.int64)
    planes[:] = ops.DESCEND_PAD_BOX[:, None, None]
    cs = np.zeros((len(sizes), n_max), dtype=bool)
    for si, n in enumerate(sizes):
        lo = rng.random((n, 2))
        mbr = np.concatenate([lo, lo + 0.1 * rng.random((n, 2))], axis=1)
        planes[:, si, :n] = ops.f64_sort_keys(np.ascontiguousarray(mbr.T))
        cs[si, :n] = rng.random(n) < 0.9
    lo = rng.random((nb, m, 2))
    boxes = np.concatenate([lo, lo + 0.004], axis=2)
    boxes[:, m // 2:] += 10.0              # half the boxes hit nothing
    keys = ops.f64_sort_keys(boxes)
    keys[:, m - 7:] = ops.DESCEND_PAD_BOX
    return (torch.from_numpy(planes).to(dev).transpose(0, 1),
            torch.from_numpy(cs).to(dev), torch.from_numpy(keys).to(dev))


# shard tree sizes of `make_lgd(n_per_class=6000)`'s sharded stores (S = 8
# and 2) and of a set with a one-node shard
SHARDED_SHAPES = {"lgd_s8": ((135, 151, 160, 171, 178, 185, 190, 197), 8,
                             230),
                  "lgd_s2": ((648, 661), 8, 1024),
                  "one_node_shard": ((1, 40, 33), 3, 45)}


@pytest.mark.parametrize("case", sorted(SHARDED_SHAPES))
def test_tree_descend_sharded_one_launch_matches_plain(dev, case):
    sizes, nb, m = SHARDED_SHAPES[case]
    args = _stacked(dev, sizes, nb, m)
    launches = ops.LAUNCHES["tree_descend"]
    got = ops.tree_descend_sharded(*args)
    assert ops.LAUNCHES["tree_descend"] == launches + 1
    want = ref.tree_descend_sharded_ref(*args)
    _equal([got], [want])
    assert got.shape == (len(sizes), nb, max(sizes))
    for si, n in enumerate(sizes):
        assert not bool(got[si, :, n:].any())
        _equal([got[si]], [ops.tree_descend(args[0][si].contiguous(),
                                            args[1][si].contiguous(),
                                            args[2])])
    assert bool(got.any())


def test_engine_on_a_sharded_store_on_cuda_equals_cpu(dev):
    """Every stage on its kernel over a four-shard store: one launch a
    sharded descent, answers equal to the CPU run's."""
    from repro_torch.core import fault
    ds = synth_rdf.make_lgd(n_per_class=300, seed=0)
    store = repro_torch.shard_store(ds.store, 4)
    cfg = ExecConfig(policy=BackendPolicy(join="fused", descend="kernel",
                                          probe="kernel", rank="kernel"))
    plan = fault.FaultPlan()
    launches = ops.LAUNCHES["tree_descend"]
    with fault.fault_plan(plan):
        got = [StreakEngine(store, cfg).execute(q) for q in ds.queries]
    assert ops.LAUNCHES["tree_descend"] - launches == \
        plan.calls["tree_descend_sharded"] > 0
    assert "tree_descend" not in plan.calls
    cpu = StreakEngine(store, cfg, device="cpu")
    for g, q in zip(got, ds.queries):
        w = cpu.execute(q)
        np.testing.assert_array_equal(g[0], w[0])
        assert list(g[1]) == list(w[1])
        for c in w[1]:
            np.testing.assert_array_equal(g[1][c], w[1][c])
        assert dataclasses.asdict(g[2]) == dataclasses.asdict(w[2])


def test_shard_mesh_over_every_card_equals_one_card(dev):
    """With two or more cards: the engine over a four-shard store laid over
    `make_shard_mesh(4)` across every card (each position's planes resident
    on its card, one launch there a descent) answers as on one card, and
    both sharded retrievals over `make_host_mesh(1, n)` equal the
    unsharded scans."""
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        pytest.skip("needs two or more cards")
    from repro_torch.launch import mesh as pmesh
    from repro_torch.serve import retrieval
    ds = synth_rdf.make_lgd(n_per_class=300, seed=0)
    store = repro_torch.shard_store(ds.store, 4)
    mesh = pmesh.make_shard_mesh(4)
    assert mesh.shape["shard"] >= 2
    cfg = ExecConfig(policy=BackendPolicy(join="fused", descend="kernel",
                                          probe="kernel", rank="kernel"))
    one = StreakEngine(store, cfg)
    spread_store = store.on_mesh(mesh)
    spread = StreakEngine(spread_store, cfg)
    launches = ops.LAUNCHES["tree_descend"]
    got = [spread.execute(q) for q in ds.queries]
    assert ops.LAUNCHES["tree_descend"] > launches
    assert {k[0] for k in spread_store.tree_shards.planes} == \
        set(mesh.devices.flat)
    for g, q in zip(got, ds.queries):
        w = one.execute(q)
        np.testing.assert_array_equal(g[0], w[0])
        assert list(g[1]) == list(w[1])
        for c in w[1]:
            np.testing.assert_array_equal(g[1][c], w[1][c])
    rng = np.random.default_rng(3)
    n_items, block = 64 * 8 * n_cards, 64
    items = torch.from_numpy(rng.normal(size=(n_items, 16)).astype(
        np.float32)).to(dev)
    state = torch.from_numpy(rng.normal(size=(5, 16)).astype(
        np.float32)).to(dev)
    srt, order = retrieval.sort_items_by_norm(items, block)
    bounds = retrieval.block_bounds(srt, block)
    host = pmesh.make_host_mesh(1, n_cards)
    assert len({d for d in host.devices.flat}) == n_cards
    s, i, _ = retrieval.streak_topk_sharded(state, srt, order, bounds, host,
                                            k=8, block=block)
    ws, wi, _ = retrieval.streak_topk(state, srt, order, bounds, k=8,
                                      block=block)
    assert torch.equal(s.cpu(), ws.cpu()) and torch.equal(i.cpu(), wi.cpu())
    s, i = retrieval.blocked_topk_sharded(state, items, host, k=8,
                                          block=block)
    ws, wi = retrieval.blocked_topk(state, items, k=8, block=block)
    assert torch.equal(s.cpu(), ws.cpu()) and torch.equal(i.cpu(), wi.cpu())


def _op_call(op, dev):
    """A call of one chained op on card inputs, and its kernel's name."""
    rng = np.random.default_rng(5)
    a, b = _boxes(rng, 40, dev), _boxes(rng, 300, dev)
    if op == "distance_join_matrix":
        return lambda: ops.distance_join_pairs(a, b, 0.03), "distance_join"
    if op == "fused_topk_join":
        dk = torch.from_numpy(rng.random(40).astype(np.float32)).to(dev)
        vk = torch.from_numpy(rng.random(300).astype(np.float32)).to(dev)
        dist = torch.full((40,), 0.05, device=dev)
        theta = torch.full((40,), 0.5, device=dev)
        return (lambda: ops.fused_topk_join(a, b, dk, vk, dist, theta, 16),
                op)
    if op == "bucketed_min_core":
        group = ops.min_core_group(2, [(30, 4, 8), (5, 32, 2)])
        buf = group.pack()
        buf[group.header:] = rng.random(group.n_floats)
        buf_t = torch.from_numpy(buf).to(dev)
        return lambda: ops.bucketed_min_core_group(buf_t, group), op
    if op == "merge_join_ranks":
        table = np.sort(rng.integers(0, 1000, 500))
        probes = rng.integers(0, 1000, 64)
        return (lambda: ops.merge_join_ranks(table, probes, "kernel",
                                             device=dev), op)
    if op == "bloom_probe":
        bits = torch.from_numpy(rng.integers(0, 1 << 31, (20, 8)).astype(
            np.int32)).to(dev)
        fi, keys = np.arange(20), rng.integers(0, 1 << 40, 4)
        return lambda: ops.bloom_probe_any(bits, fi, keys, 3), op
    planes, cs, keys = _stacked(dev, (30, 21), 2, 40)
    if op == "tree_descend":
        nk = planes[0].contiguous()
        return lambda: ops.tree_descend(nk, cs[0].contiguous(), keys), op
    return lambda: ops.tree_descend_sharded(planes, cs, keys), "tree_descend"


def _as_list(out) -> list:
    out = out if isinstance(out, tuple) else (out,)
    return [torch.as_tensor(x).cpu() for x in out]


@pytest.mark.parametrize("op", ["distance_join_matrix", "fused_topk_join",
                                "bucketed_min_core", "merge_join_ranks",
                                "tree_descend", "tree_descend_sharded",
                                "bloom_probe"])
def test_planted_fault_on_the_card_falls_back_to_plain(dev, op):
    """A fault injected into the kernel attempt of each chained op: the
    plain version on the card answers alike, counted under "<op>:plain"
    (the sharded descent's per-shard loop under ":sequential"), and the
    kernel does not launch for that attempt."""
    from repro_torch.core import fault
    call, kernel = _op_call(op, dev)
    want = _as_list(call())
    fault.STATE.reset()
    ops.reset_launch_counts()
    plan = fault.FaultPlan(rules=(fault.FaultRule(op=op, call=0),))
    try:
        with fault.fault_plan(plan):
            got = _as_list(call())
        takeover = "sequential" if op == "tree_descend_sharded" else "plain"
        assert plan.injected == 1 and fault.STATE.stats.fallbacks == 1
        assert ops.LAUNCHES[f"{op}:{takeover}"] == 1
        # the per-shard loop launches the kernel once a shard
        assert ops.LAUNCHES[kernel] == (2 if takeover == "sequential" else 0)
        _equal(got, want)
    finally:
        fault.STATE.reset()
        ops.reset_launch_counts()

# ------------------------------------ block scan, Morton, flash attention --
@pytest.mark.parametrize("nb,bsz", [(1, 1), (3, 7), (64, 1024), (17, 4100)])
@pytest.mark.parametrize("theta", [-1e30, 0.5])
def test_block_scan_kernel_matches_plain(dev, nb, bsz, theta):
    rng = np.random.default_rng(nb + bsz)
    s = torch.from_numpy(rng.normal(0.5, 0.5, (nb, bsz))
                         .astype(np.float32)).to(dev)
    _equal(ops.block_scan(s, theta), ref.block_scan_ref(s, theta))


def test_morton_kernel_matches_plain(dev):
    rng = np.random.default_rng(9)
    cx = rng.integers(-(1 << 31), (1 << 31) - 1, 100_003).astype(np.int32)
    cy = rng.integers(-(1 << 31), (1 << 31) - 1, 100_003).astype(np.int32)
    cx[:4], cy[:4] = [0, 0xFFFF, 0xFFFF, 0x8000], [0, 0, 0xFFFF, 0x8000]
    x, y = torch.from_numpy(cx).to(dev), torch.from_numpy(cy).to(dev)
    got = ops.morton_encode(x, y)
    _equal([got], [ref.morton_ref(x, y)])
    assert got[:4].tolist() == [0, 0x55555555, -1, -(1 << 31) + (1 << 30)]


def _qkv(dev, dtype, b, hq, hkv, s, d, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(b, h, s, d)).astype(
        np.float32)).to(dev, dtype) for h in (hq, hkv, hkv)]


@pytest.mark.parametrize("b,hq,hkv,s,d", [
    (1, 2, 2, 128, 64), (1, 4, 2, 128, 64), (2, 8, 1, 256, 32),
    (1, 6, 2, 200, 128), (1, 2, 1, 64, 256), (1, 4, 1, 520, 256)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 2e-4, 2e-4),
                                             (torch.bfloat16, 2 ** -7, 1e-3)])
def test_flash_kernel_matches_plain(dev, b, hq, hkv, s, d, causal, dtype,
                                    rtol, atol):
    """f32 at the reference's 2e-4 (tests/test_kernels.py). bf16 at one
    rounding step, |got - want| <= 2^-7 |want| + 1e-3, inside the
    reference's 5e-2: the plain version computes in f32, the kernel sums in
    f32 with P kept to ~16 bits (bf16 hi + lo, see
    tests/test_torch_flash_numerics.py), and both round once to bf16.
    S = 200 and 520 are not multiples of the kernel's tiles; 520 spans
    five query tiles."""
    q, k, v = _qkv(dev, dtype, b, hq, hkv, s, d)
    got = ops.flash_attention(q, k, v, causal)
    want = ref.flash_attention_ref(q, k, v, causal)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


def test_flash_wrapper_rejects_what_the_kernel_does_not_take(dev):
    q, k, v = _qkv(dev, torch.float32, 1, 4, 2, 128, 64)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                            k, v)
    with pytest.raises(ValueError, match="multiple"):
        ops.flash_attention(*_qkv(dev, torch.float32, 1, 4, 3, 128, 64))
    with pytest.raises(TypeError, match="bfloat16"):
        ops.flash_attention(*_qkv(dev, torch.float16, 1, 4, 2, 128, 64))
    with pytest.raises(TypeError, match="bfloat16"):
        ops.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(*_qkv(dev, torch.float32, 1, 2, 2, 128, 48))


def test_flash_launch_count_moves_only_on_launches(dev):
    q, k, v = _qkv(dev, torch.bfloat16, 1, 2, 1, 128, 64)
    ops.reset_launch_counts()
    ops.flash_attention(q, k, v)
    ops.flash_attention(q.cpu(), k.cpu(), v.cpu())
    with pytest.raises(ValueError):
        ops.flash_attention(q, k[:, :, :64].contiguous(), v)
    assert ops.LAUNCHES["flash_attention"] == 1
    assert sum(ops.LAUNCHES.values()) == 1


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


def test_lm_prefill_and_decode_on_cuda_equal_cpu(dev):
    """gemma-7b's smoke config (f32): flash prefill at S = 128, then three
    decode steps through the prefilled cache, on the card and on the CPU,
    within 1e-4 (f32 products summed in other orders; TF32 would fail)."""
    from repro_torch.configs import registry
    from repro_torch.models import transformer as ttr
    cfg = dataclasses.replace(registry.get("gemma-7b").smoke, use_flash=True)
    params = ttr.init_params(cfg, seed=3, device="cpu")
    rng = np.random.default_rng(1)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 128)))
    nxt = torch.from_numpy(rng.integers(0, cfg.vocab, (3, 2)))
    runs = []
    for d in (dev, torch.device("cpu")):
        ops.reset_launch_counts()
        p = _to(params, d)
        logits, pre = ttr.forward_with_cache(p, tok.to(d), cfg)
        if d.type == "cuda":
            assert ops.LAUNCHES["flash_attention"] == cfg.n_layers
        cache = ttr.init_cache(cfg, 2, 160, device=d)
        for n in ("k", "v"):
            cache[n][:, :, :128] = pre[n]
        out = [logits]
        for i in range(3):
            pos = torch.full((2,), 128 + i, dtype=torch.int32, device=d)
            step_logits, cache = ttr.decode_step(p, cache, nxt[i].to(d), pos,
                                                 cfg)
            out.append(step_logits)
        runs.append([o.cpu() for o in out] + [cache["k"].cpu()])
    for got, want in zip(*runs):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch,flash", [("qwen2-moe-a2.7b", True),
                                        ("qwen3-moe-30b-a3b", False)])
def test_moe_prefill_decode_and_loss_on_cuda_equal_cpu(dev, arch, flash):
    """The MoE smokes (f32): prefill at S = 128 (qwen2's head dim 32 takes
    the flash kernel, qwen3's 16 the plain attention), three decode steps
    and `lm_loss`, on the card and on the CPU, within 1e-4."""
    from repro_torch.configs import registry
    from repro_torch.models import moe
    cfg = dataclasses.replace(registry.get(arch).smoke, use_flash=flash)
    params = moe.init_params(cfg, seed=3, device="cpu")
    rng = np.random.default_rng(1)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 128)))
    nxt = torch.from_numpy(rng.integers(0, cfg.vocab, (3, 2)))
    runs = []
    for d in (dev, torch.device("cpu")):
        ops.reset_launch_counts()
        p = _to(params, d)
        logits, pre = moe.forward_with_cache(p, tok.to(d), cfg)
        if d.type == "cuda":
            assert ops.LAUNCHES["flash_attention"] == (
                cfg.n_layers if flash else 0)
        cache = moe.init_cache(cfg, 2, 160, device=d)
        for n in ("k", "v"):
            cache[n][:, :, :128] = pre[n]
        out = [logits]
        for i in range(3):
            pos = torch.full((2,), 128 + i, dtype=torch.int32, device=d)
            step_logits, cache = moe.decode_step(p, cache, nxt[i].to(d), pos,
                                                 cfg)
            out.append(step_logits)
        plain = dataclasses.replace(cfg, use_flash=False)
        out.append(moe.lm_loss(p, tok[:, :65].to(d), plain))
        runs.append([o.detach().cpu() for o in out] + [cache["k"].cpu()])
    for got, want in zip(*runs):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_trainer_on_cuda_equals_cpu_and_resumes_bit_for_bit(dev, tmp_path):
    """The tiny preset: three steps on the card and on the CPU from the same
    weights (drawn on the CPU) and batches (losses within 1e-4), then on the
    card, under deterministic algorithms, a run saved at step 2 and resumed
    in a new trainer gives the uninterrupted run's losses bit for bit."""
    import os
    from repro_torch.data.tokens import TokenStream
    from repro_torch.launch import train_lm
    from repro_torch.models import transformer
    from repro_torch.train import loop, optim
    preset = train_lm.PRESETS["tiny"]
    cfg = preset["cfg"]
    params = transformer.init_params(cfg, seed=0, device="cpu")
    stream = TokenStream(cfg.vocab, preset["seq"], preset["batch"], seed=0)

    def copy(tree, d):         # the trainer updates its weights in place
        return {k: copy(v, d) if isinstance(v, dict) else v.to(d, copy=True)
                for k, v in tree.items()}

    def trainer(d, ckpt_dir):
        tr = loop.Trainer(lambda p, b: transformer.lm_loss(p, b, cfg),
                          copy(params, d),
                          loop.TrainerConfig(ckpt_dir=str(tmp_path / ckpt_dir),
                                             log_every=1000),
                          optim.AdamWConfig(warmup_steps=5, total_steps=50))
        return tr, lambda s: (torch.from_numpy(stream.batch(s)).to(d),)

    hist = []
    for d in (dev, torch.device("cpu")):
        tr, batches = trainer(d, f"run-{d.type}")
        hist.append(tr.fit(batches, n_steps=3))
    np.testing.assert_allclose(hist[0], hist[1], rtol=1e-4, atol=1e-4)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        full, batches = trainer(dev, "full")
        want = full.fit(batches, n_steps=4)
        part, batches = trainer(dev, "part")
        part.fit(batches, n_steps=2)
        resumed, batches = trainer(dev, "part")
        assert resumed.maybe_restore() and resumed.step == 2
        got = resumed.fit(batches, n_steps=4)
    finally:
        torch.use_deterministic_algorithms(False)
    assert got == want[2:]


# ------------------------------------------- recsys and the GNN family ---
def _popular_catalog(n, d, seed):
    """Item rows with popularity-skewed norms, as the serve launcher's."""
    rng = np.random.default_rng(seed)
    items = rng.normal(size=(n, d)) / np.sqrt(d) \
        * np.log1p(rng.zipf(1.4, n).clip(1, 1000))[:, None]
    return torch.from_numpy(items.astype(np.float32))


@pytest.mark.parametrize("b,k,block", [(1, 100, 1250), (64, 100, 937),
                                       (8, 10, 64), (3, 100, 5000)])
def test_retrieval_on_cuda_equals_cpu(dev, b, k, block):
    """streak_topk and blocked_topk on the card against the CPU: blocks
    read equal, ids equal, scores within 1e-5 relative (f32 dot products
    of 16 terms summed in other orders)."""
    from repro_torch.serve import retrieval
    items = _popular_catalog(20_000, 16, b)
    state = torch.from_numpy(np.random.default_rng(7).normal(
        size=(b, 16)).astype(np.float32))
    runs = []
    for d in (dev, torch.device("cpu")):
        items_s, order = retrieval.sort_items_by_norm(items.to(d), block)
        bounds = retrieval.block_bounds(items_s, block)
        s, i, read = retrieval.streak_topk(state.to(d), items_s, order,
                                           bounds, k, block)
        fs, fi = retrieval.blocked_topk(state.to(d), items.to(d), k, block)
        runs.append((s.cpu(), i.cpu(), read, fs.cpu(), fi.cpu()))
    (gs, gi, gr, gfs, gfi), (cs, ci, cr, cfs, cfi) = runs
    assert gr == cr and gr < -(-20_000 // block)
    assert torch.equal(gi, ci) and torch.equal(gfi, cfi)
    assert torch.equal(gi, gfi)
    for got, want in ((gs, cs), (gfs, cfs)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_sasrec_loss_and_grads_on_cuda_equal_cpu(dev):
    from repro_torch import pytree
    from repro_torch.configs import registry
    from repro_torch.data.recsys import InteractionStream
    from repro_torch.models import sasrec
    cfg = registry.get("sasrec").smoke
    params = sasrec.init_params(cfg, seed=0, device="cpu")
    batch = InteractionStream(cfg.n_items, cfg.seq_len, 16, seed=0).batch(0)
    runs = []
    for d in (dev, torch.device("cpu")):
        leaves = [x.to(d).requires_grad_(True)
                  for x in pytree.leaves(params)]
        loss = sasrec.bpr_loss(pytree.unflatten(params, leaves),
                               *(torch.from_numpy(x).to(d) for x in batch),
                               cfg)
        runs.append([loss.detach().cpu()] + [
            g.cpu() for g in torch.autograd.grad(loss, leaves)])
    for got, want in zip(*runs):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_embedding_bag_on_cuda_equals_cpu(dev, mode):
    from repro_torch.data.recsys import embedding_bag
    rng = np.random.default_rng(1)
    table = torch.from_numpy(rng.normal(size=(20, 5)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 20, 11))
    off = torch.tensor([0, 3, 3, 7, 11])            # bags 1 and 4 empty
    w = torch.from_numpy(rng.normal(size=11).astype(np.float32))
    got = embedding_bag(table.to(dev), idx.to(dev), off.to(dev), mode,
                        w.to(dev)).cpu()
    want = embedding_bag(table, idx, off, mode, w)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    if mode == "max":
        assert torch.isneginf(got[[1, 4]]).all()


@pytest.mark.parametrize("arch,agg", [("gcn", "mean"), ("sage", "mean"),
                                      ("sage", "max")])
def test_gnn_on_cuda_equals_cpu(dev, arch, agg):
    """Logits and gradients on the card against the CPU (f32 segment sums
    added by atomics in another order: 1e-5 relative); the max aggregate
    of a node without in-edges is -inf on both."""
    from repro_torch import pytree
    from repro_torch.models import gnn
    cfg = gnn.GNNConfig(arch=arch, n_layers=2, d_in=12, d_hidden=16,
                        d_out=5, aggregator=agg)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(60, 12)).astype(np.float32))
    e = torch.from_numpy(rng.integers(1, 60, (2, 300)).astype(np.int32))
    labels = torch.from_numpy(rng.integers(0, 5, 60).astype(np.int32))
    mask = torch.arange(60) > 0                     # node 0 has no in-edges
    params = gnn.init_params(cfg, seed=0, device="cpu")
    runs = []
    for d in (dev, torch.device("cpu")):
        leaves = [p.to(d).requires_grad_(True) for p in pytree.leaves(params)]
        p = pytree.unflatten(params, leaves)
        out = gnn.forward(p, x.to(d), e.to(d), cfg)
        loss = gnn.nll_loss(p, x.to(d), e.to(d), labels.to(d), mask.to(d),
                            cfg)
        runs.append([out.detach().cpu(), loss.detach().cpu()] + [
            g.cpu() for g in torch.autograd.grad(loss, leaves)])
    for got, want in zip(*runs):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5,
                                   equal_nan=True)
    if agg == "max":
        assert not torch.isfinite(runs[0][0][0]).any()


def test_graphcast_and_nequip_on_cuda_equal_cpu(dev):
    """The f32 GraphCast smoke (remat on, gradients taken) and the NequIP
    smoke: card against CPU within 1e-4 relative (f32 segment sums and
    products in other orders through 2 layers)."""
    from repro_torch import pytree
    from repro_torch.configs import registry
    from repro_torch.models import equivariant, graphcast
    gcfg = dataclasses.replace(registry.get("graphcast").smoke, remat=True)
    ncfg = registry.get("nequip").smoke
    rng = np.random.default_rng(5)
    gx = torch.from_numpy(rng.normal(size=(40, gcfg.n_vars))
                          .astype(np.float32))
    g2m = torch.from_numpy(np.stack([rng.integers(0, 40, 90),
                                     rng.integers(0, 12, 90)]))
    me = torch.from_numpy(rng.integers(0, 12, (2, 50)))
    m2g = torch.from_numpy(np.stack([rng.integers(0, 12, 90),
                                     rng.integers(0, 40, 90)]))
    pos = torch.from_numpy(rng.normal(size=(10, 3)).astype(np.float32) * 2)
    d2 = torch.cdist(pos, pos)
    edges = torch.nonzero((d2 < ncfg.cutoff) & (d2 > 0)).T
    species = torch.from_numpy(rng.integers(0, ncfg.n_species, 10))
    gp = graphcast.init_params(gcfg, seed=0, device="cpu")
    npar = equivariant.init_params(ncfg, seed=0, device="cpu")
    runs = []
    for d in (dev, torch.device("cpu")):
        leaves = [p.to(d).requires_grad_(True) for p in pytree.leaves(gp)]
        loss = graphcast.mse_loss(pytree.unflatten(gp, leaves), gx.to(d),
                                  gx.to(d), g2m.to(d), me.to(d), m2g.to(d),
                                  12, gcfg)
        energy = equivariant.forward(
            pytree.tree_map(lambda t: t.to(d), npar), species.to(d),
            pos.to(d), edges.to(d), ncfg)
        runs.append([loss.detach().cpu(), energy.cpu()] + [
            g.cpu() for g in torch.autograd.grad(loss, leaves)])
    for got, want in zip(*runs):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
