"""Port vs reference: the NequIP-style equivariant potential on the CPU.

The Gaunt tensors and the path list are float64 numpy copies and must equal
the reference's exactly. The model takes the reference's weights through
`interop.params_from_state` and the same seeded molecules.

Tolerances: spherical harmonics and the Bessel basis 1e-6 relative and
1e-7 absolute (the same f32 elementwise formulas; sin/cos may differ by an
ulp); energies 1e-5 relative and 1e-6 absolute, gradients 1e-4 and 1e-5
(f32 tensor products and segment sums added in other orders, as
tests/test_torch_train.py); rotation, translation and permutation
invariance at the reference's own rtol 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.models import equivariant as req
from repro_torch import pytree
from repro_torch.configs import registry
from repro_torch.data import graphs
from repro_torch.interop import params_from_state
from repro_torch.models import equivariant

TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
ELEM_TOL = dict(rtol=1e-6, atol=1e-7)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(
        np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                   dtype=np.float32), np.asarray(want, dtype=np.float32),
        **tol)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _port(ref_cfg):
    return equivariant.NequIPConfig(**dataclasses.asdict(ref_cfg))


def _carry(ref_params, ref_cfg):
    return params_from_state(jax.tree.map(np.asarray, ref_params),
                             _port(ref_cfg), "cpu")


def _random_molecule(rng, n=12):
    pos = rng.normal(size=(n, 3)).astype(np.float32) * 2.0
    species = rng.integers(0, 4, size=n).astype(np.int32)
    d = np.sqrt(((pos[:, None] - pos[None]) ** 2).sum(-1))
    i, j = np.nonzero((d < 5.0) & (d > 0))
    return species, pos, np.stack([i, j]).astype(np.int32)


def _rotation(rng):
    a = rng.normal(size=(3, 3))
    q, _ = np.linalg.qr(a)
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q.astype(np.float32)


# ---------------------------------------------------------- coefficients ---
@pytest.mark.parametrize("l_max", [1, 2, 3])
def test_paths_and_gaunt_tensors_equal_the_reference(l_max):
    paths = equivariant.allowed_paths(l_max)
    assert paths == req.allowed_paths(l_max)
    for p in paths:
        if max(p) <= 2:
            got, want = equivariant.gaunt(*p), req.gaunt(*p)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_gaunt_selection_rules():
    """Twin of tests/test_models.py::test_gaunt_selection_rules."""
    assert np.abs(equivariant.gaunt(1, 1, 1)).max() < 1e-8
    assert np.abs(equivariant.gaunt(1, 1, 2)).max() > 0.1
    np.testing.assert_allclose(np.linalg.norm(equivariant.gaunt(1, 1, 0)),
                               1.0, rtol=1e-6)


@pytest.mark.parametrize("l", [0, 1, 2])
def test_spherical_harmonics_and_bessel_basis_match(l):
    rng = np.random.default_rng(l)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    _close(equivariant.real_sph_harm(_t(v), l),
           req.real_sph_harm(jnp.asarray(v), l), ELEM_TOL)
    np.testing.assert_array_equal(
        equivariant._real_sph_np(v.astype(np.float64), l),
        req._real_sph_np(v.astype(np.float64), l))
    r = np.concatenate([[0.0, 1e-12, 5.0, 7.0],
                        rng.random(60) * 6]).astype(np.float32)
    _close(equivariant.bessel_basis(_t(r), 8, 5.0),
           req.bessel_basis(jnp.asarray(r), 8, 5.0), ELEM_TOL)


def test_nequip_arch_matches_the_reference_config():
    mod = ref_registry.get("nequip")
    a = registry.get("nequip")
    assert a.family == mod.FAMILY == "nequip"
    assert dataclasses.asdict(a.config) == dataclasses.asdict(mod.CONFIG)
    assert dataclasses.asdict(a.smoke) == dataclasses.asdict(mod.SMOKE)
    assert a.config.n_params() == mod.CONFIG.n_params()
    assert registry.model_module(a.config) is equivariant
    for cfg, ref_cfg in ((a.config, mod.CONFIG), (a.smoke, mod.SMOKE)):
        want = jax.tree.map(lambda x: tuple(x.shape), jax.eval_shape(
            lambda c=ref_cfg: req.init_params(jax.random.PRNGKey(0), c)))
        assert equivariant.param_shapes(cfg) == want
    got = equivariant.init_params(a.smoke, seed=0, device="cpu")
    assert pytree.tree_map(lambda x: tuple(x.shape), got) == \
        equivariant.param_shapes(a.smoke)


def test_init_params_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        equivariant.init_params(registry.get("nequip").smoke)


# ----------------------------------------------------------------- model ---
def test_forward_energy_and_grads_match():
    """Twin of tests/test_models.py::test_nequip_forward_finite, with the
    energy loss's gradients."""
    rng = np.random.default_rng(2)
    species, pos, edges = _random_molecule(rng)
    ref_cfg = req.NequIPConfig(n_layers=1, n_channels=8)
    ref_params = req.init_params(jax.random.PRNGKey(0), ref_cfg)
    params, cfg = _carry(ref_params, ref_cfg), _port(ref_cfg)
    rargs = (jnp.asarray(species), jnp.asarray(pos), jnp.asarray(edges))
    want = req.forward(ref_params, *rargs, ref_cfg)
    got = equivariant.forward(params, _t(species), _t(pos), _t(edges), cfg)
    assert got.shape == () and torch.isfinite(got)
    _close(got, want)
    want_l, ref_g = jax.value_and_grad(req.energy_loss)(
        ref_params, *rargs, 0.5, ref_cfg)
    leaves = [x.clone().requires_grad_(True) for x in pytree.leaves(params)]
    loss = equivariant.energy_loss(pytree.unflatten(params, leaves),
                                   _t(species), _t(pos), _t(edges), 0.5, cfg)
    _close(loss, want_l)
    for g, w in zip(torch.autograd.grad(loss, leaves),
                    jax.tree.leaves(ref_g), strict=True):
        _close(g, w, GRAD_TOL)


@pytest.mark.parametrize("seed", range(3))
def test_energy_rotation_invariant(seed):
    """Twin of tests/test_models.py::test_nequip_energy_rotation_invariant,
    each energy also against the reference's."""
    rng = np.random.default_rng(seed)
    species, pos, edges = _random_molecule(rng)
    ref_cfg = req.NequIPConfig(n_layers=3, n_channels=8)
    ref_params = req.init_params(jax.random.PRNGKey(seed), ref_cfg)
    params, cfg = _carry(ref_params, ref_cfg), _port(ref_cfg)
    r = _rotation(rng)
    pos2 = pos @ r.T + rng.normal(size=(1, 3)).astype(np.float32)
    e = [equivariant.forward(params, _t(species), _t(p), _t(edges), cfg)
         for p in (pos, pos2)]
    np.testing.assert_allclose(float(e[0]), float(e[1]), rtol=1e-4)
    _close(e[1], req.forward(ref_params, jnp.asarray(species),
                             jnp.asarray(pos2), jnp.asarray(edges), ref_cfg))


def test_permutation_invariant():
    """Twin of tests/test_models.py::test_nequip_permutation_invariant."""
    rng = np.random.default_rng(5)
    species, pos, edges = _random_molecule(rng)
    ref_cfg = req.NequIPConfig(n_layers=2, n_channels=8)
    ref_params = req.init_params(jax.random.PRNGKey(1), ref_cfg)
    params, cfg = _carry(ref_params, ref_cfg), _port(ref_cfg)
    perm = rng.permutation(len(species))
    inv = np.argsort(perm)
    e1 = equivariant.forward(params, _t(species), _t(pos), _t(edges), cfg)
    e2 = equivariant.forward(params, _t(species[perm]), _t(pos[perm]),
                             _t(inv[edges]), cfg)
    np.testing.assert_allclose(float(e1), float(e2), rtol=1e-4)


def test_forward_batched_and_its_loss_match():
    """Three molecules in one block-diagonal batch, their cutoff graphs from
    the STREAK radius join (`graphs.spatial_graph`)."""
    rng = np.random.default_rng(7)
    ref_cfg = req.NequIPConfig(n_layers=2, n_channels=8, l_max=2, n_rbf=4)
    species, pos, edges, gid = [], [], [], []
    n0 = 0
    for g in range(3):
        p = (rng.normal(size=(9, 3)) * 1.5).astype(np.float32)
        species.append(rng.integers(0, 8, 9).astype(np.int32))
        pos.append(p)
        edges.append(graphs.spatial_graph(p.astype(np.float64), 5.0) + n0)
        gid.append(np.full(9, g, np.int32))
        n0 += 9
    species, pos, edges, gid = (np.concatenate(species), np.concatenate(pos),
                                np.concatenate(edges, axis=1),
                                np.concatenate(gid))
    targets = rng.normal(size=3).astype(np.float32)
    ref_params = req.init_params(jax.random.PRNGKey(3), ref_cfg)
    params, cfg = _carry(ref_params, ref_cfg), _port(ref_cfg)
    rargs = tuple(jnp.asarray(a) for a in (species, pos, edges, gid))
    args = tuple(_t(a) for a in (species, pos, edges, gid))
    want = req.forward_batched(ref_params, *rargs, 3, ref_cfg)
    got = equivariant.forward_batched(params, *args, 3, cfg)
    assert got.shape == (3,)
    _close(got, want)
    _close(got[1], equivariant.forward(params, args[0][9:18],
                                       args[1][9:18],
                                       args[2][:, (edges[0] >= 9)
                                               & (edges[0] < 18)] - 9, cfg))
    _close(equivariant.batched_energy_loss(params, *args, _t(targets), cfg),
           req.batched_energy_loss(ref_params, *rargs, jnp.asarray(targets),
                                   ref_cfg))


def test_arch_smoke_energy_matches():
    """Twin of tests/test_arch_smoke.py's nequip branch."""
    ref_cfg = ref_registry.get("nequip").SMOKE
    ref_params = req.init_params(jax.random.PRNGKey(0), ref_cfg)
    rng = np.random.default_rng(0)
    pos = rng.normal(size=(10, 3)).astype(np.float32) * 2
    d = np.sqrt(((pos[:, None] - pos[None]) ** 2).sum(-1))
    i, j = np.nonzero((d < ref_cfg.cutoff) & (d > 0))
    species = rng.integers(0, ref_cfg.n_species, 10).astype(np.int32)
    edges = np.stack([i, j]).astype(np.int32)
    want = req.forward(ref_params, jnp.asarray(species), jnp.asarray(pos),
                       jnp.asarray(edges), ref_cfg)
    got = equivariant.forward(_carry(ref_params, ref_cfg), _t(species),
                              _t(pos), _t(edges), registry.get("nequip").smoke)
    _close(got, want)
