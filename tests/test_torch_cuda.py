"""The port's CUDA kernels on the card: each one bit-identical to its plain
torch version, launch counts that move only on a kernel launch, and the
engine on CUDA answering exactly as on the CPU.

Every test here needs an NVIDIA GPU and nvcc; elsewhere they skip. On the
card: ``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import BackendPolicy, ExecConfig, StreakEngine
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


@pytest.mark.parametrize("m,n", [(1, 1), (37, 300), (300, 1000)])
def test_distance_join_kernel_matches_plain(dev, m, n):
    rng = np.random.default_rng(0)
    a, b = _boxes(rng, m, dev), _boxes(rng, n, dev)
    _equal([ops.distance_join(a, b)], [ref.distance_join_ref(a, b)])


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


@pytest.mark.parametrize("join", ["fused", "kernel"])
def test_engine_on_cuda_equals_cpu(dev, join):
    ds = synth_rdf.make_lgd(n_per_class=300, seed=0)
    cfg = ExecConfig(policy=BackendPolicy(
        join=join, descend="kernel", probe="numpy", rank="numpy"))
    ops.reset_launch_counts()
    for q in ds.queries:
        got = StreakEngine(ds.store, cfg).execute(q)
        want = StreakEngine(ds.store, cfg, device="cpu").execute(q)
        np.testing.assert_array_equal(got[0], want[0])
        for c in want[1]:
            np.testing.assert_array_equal(got[1][c], want[1][c])
        assert dataclasses.asdict(got[2]) == dataclasses.asdict(want[2])
    assert ops.LAUNCHES["tree_descend"] > 0
    assert ops.LAUNCHES["bucketed_min_core"] > 0
    assert ops.LAUNCHES["fused_topk_join" if join == "fused"
                        else "distance_join"] > 0
