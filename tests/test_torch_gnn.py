"""Port vs reference: GCN, GraphSAGE, the graph data and the GNN and
recsys branches of the training launcher, on the CPU.

The same seeded numpy inputs, and the reference's weights carried over by
`interop.params_from_state`, go through the reference (JAX on the CPU) and
the port (`device="cpu"`); the graph generators and the neighbour sampler
are copies and must draw the reference's graphs and blocks exactly.

Tolerances: f32 outputs and losses 1e-5 relative and 1e-6 absolute;
gradients 1e-4 relative and 1e-5 absolute (f32 products and segment sums
added in other orders, as tests/test_torch_train.py); loss histories of
two trainers 1e-4. Integer graphs, CSR arrays and sampled blocks: equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.data import graphs as rgraphs
from repro.launch import train as rlaunch
from repro.models import gnn as rgnn
from repro.models import graphcast as rgc
from repro.train import loop as rloop
from repro.train import optim as roptim
from repro_torch import pytree
from repro_torch.configs import registry
from repro_torch.data import graphs
from repro_torch.interop import params_from_state
from repro_torch.launch import train as launch_train
from repro_torch.models import gnn, graphcast
from repro_torch.train import loop, optim

TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
HIST_TOL = dict(rtol=1e-4, atol=1e-4)
PORT_CONFIG = {rgnn.GNNConfig: gnn.GNNConfig,
               rgc.GraphCastConfig: graphcast.GraphCastConfig}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(
        np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                   else got, dtype=np.float32),
        np.asarray(want, dtype=np.float32), **tol)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _port(ref_cfg):
    return PORT_CONFIG[type(ref_cfg)](**dataclasses.asdict(ref_cfg))


def _carry(ref_params, ref_cfg):
    return params_from_state(jax.tree.map(np.asarray, ref_params),
                             _port(ref_cfg), "cpu")


def _grads(loss_fn, params, *args):
    leaves = [x.detach().clone().requires_grad_(True)
              for x in pytree.leaves(params)]
    loss = loss_fn(pytree.unflatten(params, leaves), *args)
    return loss.detach(), torch.autograd.grad(loss, leaves)


# ------------------------------------------------------------- registry ---
GNN_ARCHS = ["gcn-cora", "graphsage-reddit", "graphcast"]


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_arch_matches_the_reference_config(arch):
    mod = ref_registry.get(arch)
    a = registry.get(arch)
    assert a.family == mod.FAMILY
    assert dataclasses.asdict(a.config) == dataclasses.asdict(mod.CONFIG)
    assert dataclasses.asdict(a.smoke) == dataclasses.asdict(mod.SMOKE)
    assert a.config.n_params() == mod.CONFIG.n_params()
    module = registry.model_module(a.config)
    assert module is (graphcast if arch == "graphcast" else gnn)
    for cfg, ref_cfg in ((a.config, mod.CONFIG), (a.smoke, mod.SMOKE)):
        want = jax.tree.map(lambda x: tuple(x.shape), jax.eval_shape(
            lambda c=ref_cfg: mod_init(arch)(jax.random.PRNGKey(0), c)))
        assert module.param_shapes(cfg) == want
    got = module.init_params(a.smoke, seed=0, device="cpu")
    assert pytree.tree_map(lambda x: tuple(x.shape), got) == \
        module.param_shapes(a.smoke)
    assert registry.GNN_SHAPES == ref_registry.GNN_SHAPES


def mod_init(arch):
    return rgc.init_params if arch == "graphcast" else rgnn.init_params


def test_init_params_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch in GNN_ARCHS:
        a = registry.get(arch)
        with pytest.raises(RuntimeError, match="CUDA"):
            registry.model_module(a.smoke).init_params(a.smoke)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_train.main(["--arch", "gcn-cora", "--smoke", "--steps", "1"])


# ------------------------------------------------------------------ gnn ---
def _rand_graph(rng, n=50, e=200, f=8):
    x = rng.normal(size=(n, f)).astype(np.float32)
    edges = rng.integers(0, n, size=(2, e)).astype(np.int32)
    return x, edges


@pytest.mark.parametrize("arch,agg", [("gcn", "mean"), ("sage", "mean"),
                                      ("sage", "sum"), ("sage", "max")])
def test_gnn_forward_loss_and_grads_match(arch, agg):
    """Twin of tests/test_models.py::test_gnn_forward_and_grad, with every
    aggregator of GraphSAGE."""
    rng = np.random.default_rng(0)
    x, edges = _rand_graph(rng)
    labels = rng.integers(0, 4, size=50).astype(np.int32)
    mask = rng.random(50) < 0.7
    ref_cfg = rgnn.GNNConfig(arch=arch, n_layers=3, d_in=8, d_hidden=16,
                             d_out=4, aggregator=agg)
    cfg = _port(ref_cfg)
    ref_params = rgnn.init_params(jax.random.PRNGKey(0), ref_cfg)
    params = _carry(ref_params, ref_cfg)
    want = rgnn.forward(ref_params, jnp.asarray(x), jnp.asarray(edges),
                        ref_cfg)
    got = gnn.forward(params, _t(x), _t(edges), cfg)
    assert got.shape == (50, 4)
    _close(got, want)
    rargs = (jnp.asarray(x), jnp.asarray(edges), jnp.asarray(labels),
             jnp.asarray(mask))
    want_l, ref_g = jax.value_and_grad(rgnn.nll_loss)(ref_params, *rargs,
                                                      ref_cfg)
    loss, grads = _grads(lambda p, *a: gnn.nll_loss(p, *a, cfg), params,
                         _t(x), _t(edges), _t(labels), _t(mask))
    _close(loss, want_l)
    for g, w in zip(grads, jax.tree.leaves(ref_g), strict=True):
        _close(g, w, GRAD_TOL)


def test_gcn_explicit_edge_norm_matches():
    rng = np.random.default_rng(1)
    x, edges = _rand_graph(rng, n=30, e=90, f=6)
    norm = rng.random(90).astype(np.float32)
    ref_cfg = rgnn.GNNConfig(arch="gcn", n_layers=2, d_in=6, d_hidden=8,
                             d_out=3)
    ref_params = rgnn.init_params(jax.random.PRNGKey(2), ref_cfg)
    want = rgnn.forward(ref_params, jnp.asarray(x), jnp.asarray(edges),
                        ref_cfg, jnp.asarray(norm))
    got = gnn.forward(_carry(ref_params, ref_cfg), _t(x), _t(edges),
                      _port(ref_cfg), _t(norm))
    _close(got, want)


def test_gcn_isolated_node_keeps_self_features():
    """Twin of tests/test_models.py::
    test_gcn_isolated_node_keeps_self_features."""
    ref_cfg = rgnn.GNNConfig(arch="gcn", n_layers=1, d_in=4, d_hidden=4,
                             d_out=4)
    ref_params = rgnn.init_params(jax.random.PRNGKey(0), ref_cfg)
    edges = np.array([[1], [2]], dtype=np.int32)     # node 0 isolated
    want = rgnn.forward(ref_params, jnp.eye(4), jnp.asarray(edges), ref_cfg)
    got = gnn.forward(_carry(ref_params, ref_cfg), torch.eye(4), _t(edges),
                      _port(ref_cfg))
    assert float(got[0].abs().sum()) > 0
    _close(got, want)


def test_sage_max_isolated_node_gets_minus_inf_as_the_reference():
    """A node without in-edges: the segment max is -inf, so its aggregate
    row carries -inf into the product (inf - inf = NaN where the weights
    take both signs), in both packages alike."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(6, 3)).astype(np.float32)
    edges = np.array([[1, 2, 3, 4, 5], [2, 3, 4, 5, 1]], dtype=np.int32)
    ref_cfg = rgnn.GNNConfig(arch="sage", n_layers=1, d_in=3, d_hidden=4,
                             d_out=4, aggregator="max")
    ref_params = rgnn.init_params(jax.random.PRNGKey(4), ref_cfg)
    params = _carry(ref_params, ref_cfg)
    agg = gnn._aggregate(_t(x)[_t(edges[0]).long()], _t(edges[1]).long(),
                         6, "max")
    assert torch.isneginf(agg[0]).all() and torch.isfinite(agg[1:]).all()
    want = np.asarray(rgnn.forward(ref_params, jnp.asarray(x),
                                   jnp.asarray(edges), ref_cfg))
    got = gnn.forward(params, _t(x), _t(edges), _port(ref_cfg)).numpy()
    assert not np.isfinite(want[0]).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    _close(np.nan_to_num(got[1:]), np.nan_to_num(want[1:]))


@pytest.mark.parametrize("arch", ["gcn-cora", "graphsage-reddit"])
def test_arch_smoke_forward_matches(arch):
    """Twin of tests/test_arch_smoke.py's gnn branch."""
    ref_cfg = ref_registry.get(arch).SMOKE
    ref_params = rgnn.init_params(jax.random.PRNGKey(0), ref_cfg)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(40, ref_cfg.d_in)).astype(np.float32)
    edges = rng.integers(0, 40, (2, 120)).astype(np.int32)
    want = rgnn.forward(ref_params, jnp.asarray(x), jnp.asarray(edges),
                        ref_cfg)
    got = gnn.forward(_carry(ref_params, ref_cfg), _t(x), _t(edges),
                      registry.get(arch).smoke)
    assert got.shape == (40, ref_cfg.d_out)
    _close(got, want)


# ----------------------------------------------------------- graph data ---
@pytest.mark.parametrize("n,deg,seed", [(500, 6, 1), (2708, 1, 0),
                                        (300, 8, 5)])
def test_power_law_graph_and_csr_equal_the_reference(n, deg, seed):
    want = rgraphs.random_power_law_graph(n, deg, seed=seed)
    got = graphs.random_power_law_graph(n, deg, seed=seed)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    for a, b in zip(graphs.to_csr(got, n), rgraphs.to_csr(want, n),
                    strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fanouts", [(5, 3), (25, 10)])
def test_neighbor_sampler_draws_equal_the_reference(fanouts):
    """Twin of tests/test_substrate.py::
    test_neighbor_sampler_shapes_and_locality: two blocks in a row from one
    sampler, every field equal (the sampler's rng advances alike)."""
    edges = rgraphs.random_power_law_graph(500, 6, seed=1)
    feats = np.random.default_rng(0).normal(size=(500, 8)).astype(np.float32)
    labels = np.random.default_rng(1).integers(0, 5, 500).astype(np.int32)
    edges[1, :40] = 7            # a node with many in-edges; others none
    ref = rgraphs.NeighborSampler(edges, 500, feats, labels, fanouts, seed=3)
    port = graphs.NeighborSampler(edges, 500, feats, labels, fanouts, seed=3)
    for seeds in (np.arange(16), np.array([7, 499, 0, 250, 3])):
        want, got = ref.sample(seeds), port.sample(seeds)
        for f in ("nodes", "feats", "edges", "labels", "mask"):
            a, b = getattr(got, f), getattr(want, f)
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b)
    assert got.mask.sum() == 5
    assert got.edges.max() < (got.nodes >= 0).sum()


def test_spatial_graph_and_grid_mesh_edges_equal_the_reference():
    """Twin of tests/test_substrate.py::test_spatial_graph_matches_bruteforce
    and the GraphCast grid->mesh edges."""
    rng = np.random.default_rng(2)
    pos = rng.normal(size=(80, 3)) * 3
    got = graphs.spatial_graph(pos, cutoff=2.0)
    np.testing.assert_array_equal(got, rgraphs.spatial_graph(pos, 2.0))
    d = np.sqrt(((pos[:, None] - pos[None]) ** 2).sum(-1))
    expect = {(i, j) for i, j in zip(*np.nonzero(d <= 2.0)) if i != j}
    assert set(zip(got[0].tolist(), got[1].tolist())) == expect
    grid = rng.random((300, 2)) * 10
    mesh = rng.random((40, 2)) * 10
    np.testing.assert_array_equal(graphs.grid_mesh_edges(grid, mesh, 1.5),
                                  rgraphs.grid_mesh_edges(grid, mesh, 1.5))


# ------------------------------------------------------------- launcher ---
@pytest.mark.parametrize("arch", ["gcn-cora", "graphsage-reddit", "sasrec"])
def test_train_launcher_setup_is_the_reference_one(arch, tmp_path):
    """The launcher's data and loss on carried weights equal the reference
    launcher's, and three Trainer steps of each package agree."""
    ref_cfg = ref_registry.get(arch).SMOKE
    cfg = registry.get(arch).smoke
    if arch == "sasrec":
        ref_params, ref_loss, ref_batches = rlaunch._sasrec_setup(ref_cfg, 4)
        _, loss_fn, batches = launch_train.sasrec_setup(cfg, 4, "cpu")
        for step in (0, 3):
            for a, b in zip(batches(step), ref_batches(step), strict=True):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    else:
        ref_params, ref_loss, ref_batches = rlaunch._gnn_setup(ref_cfg)
        _, loss_fn, batches = launch_train.gnn_setup(cfg, "cpu")
    params = params_from_state(jax.tree.map(np.asarray, ref_params), cfg,
                               "cpu")
    _close(loss_fn(params, *batches(0)),
           ref_loss(ref_params, *ref_batches(0)))
    hist = []
    for pkg, lf, p, b in ((rloop, ref_loss, ref_params, ref_batches),
                          (loop, loss_fn, params, batches)):
        opt = roptim if pkg is rloop else optim
        tr = pkg.Trainer(lf, p, pkg.TrainerConfig(
            ckpt_dir=str(tmp_path / pkg.__name__), ckpt_every=10 ** 6,
            log_every=100), opt.AdamWConfig(warmup_steps=5, total_steps=50))
        hist.append(tr.fit(b, n_steps=3))
    _close(hist[1], hist[0], HIST_TOL)


def test_graphsage_fanouts_differ_from_the_minibatch_shape():
    """Both packages: the config samples (25, 10), its shape says (15, 10)
    (ROADMAP §3); the port's sampler blocks follow the config."""
    for cfg, shapes in ((ref_registry.get("graphsage-reddit").CONFIG,
                         ref_registry.GNN_SHAPES),
                        (registry.get("graphsage-reddit").config,
                         registry.GNN_SHAPES)):
        assert cfg.sample_sizes == (25, 10)
        assert shapes["minibatch_lg"]["fanout"] == (15, 10)
