"""Port vs reference: GraphCast's encoder-processor-decoder on the CPU.

The same seeded numpy inputs and edge sets, and the reference's weights
carried over by `interop.params_from_state` (the processor's stacked
(L, ...) weights as they are), go through the reference (JAX on the CPU)
and the port (`device="cpu"`), with and without recomputed blocks.

Tolerances: f32 outputs and losses 1e-5 relative and 1e-6 absolute;
gradients 1e-4 relative and 1e-5 absolute (f32 products and segment sums
added in other orders, as tests/test_torch_train.py). In bf16 (the
published dtype): the port against the reference's bf16 forward within
2e-2 relative RMS, the bf16 rounding of ~4 chained layers (each 2^-8
relative) summed in other orders; the port against its own f32 run within
the same bound.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.models import graphcast as rgc
from repro_torch import pytree
from repro_torch.configs import registry
from repro_torch.interop import params_from_state
from repro_torch.models import graphcast

TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_RMS = 2e-2


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(
        np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                   else got, dtype=np.float32),
        np.asarray(want, dtype=np.float32), **tol)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _port(ref_cfg):
    return graphcast.GraphCastConfig(**dataclasses.asdict(ref_cfg))


def _carry(ref_params, ref_cfg):
    return params_from_state(jax.tree.map(np.asarray, ref_params),
                             _port(ref_cfg), "cpu")


def _grads(loss_fn, params, *args):
    leaves = [x.detach().clone().requires_grad_(True)
              for x in pytree.leaves(params)]
    loss = loss_fn(pytree.unflatten(params, leaves), *args)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def _rel_rms(got, want) -> float:
    g = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                   else got, dtype=np.float64)
    w = np.asarray(want, dtype=np.float64)
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def _gc_inputs(seed, n_grid=40, n_mesh=12, n_vars=11):
    rng = np.random.default_rng(seed)
    gx = rng.normal(size=(n_grid, n_vars)).astype(np.float32)
    g2m = rng.integers(0, [[n_grid], [n_mesh]], size=(2, 80)).astype(np.int32)
    me = rng.integers(0, n_mesh, size=(2, 50)).astype(np.int32)
    m2g = rng.integers(0, [[n_mesh], [n_grid]], size=(2, 80)).astype(np.int32)
    return gx, g2m, me, m2g, n_mesh


@pytest.mark.parametrize("remat,aggregator", [(False, "sum"), (True, "sum"),
                                              (False, "mean")])
def test_graphcast_forward_loss_and_grads_match(remat, aggregator):
    """Twin of tests/test_models.py::test_graphcast_forward, gradients
    through the recomputed blocks too."""
    ref_cfg = rgc.GraphCastConfig(n_layers=3, d_hidden=32, n_vars=11,
                                  dtype="float32", remat=remat,
                                  aggregator=aggregator)
    gx, g2m, me, m2g, n_mesh = _gc_inputs(1)
    ref_params = rgc.init_params(jax.random.PRNGKey(0), ref_cfg)
    params, cfg = _carry(ref_params, ref_cfg), _port(ref_cfg)
    rargs = tuple(jnp.asarray(a) for a in (gx, g2m, me, m2g))
    args = tuple(_t(a) for a in (gx, g2m, me, m2g))
    want = rgc.forward(ref_params, *rargs, n_mesh, ref_cfg)
    got = graphcast.forward(params, *args, n_mesh, cfg)
    assert got.shape == (40, 11) and got.dtype == torch.float32
    _close(got, want)
    target = np.random.default_rng(2).normal(size=gx.shape).astype(
        np.float32)
    want_l, ref_g = jax.value_and_grad(rgc.mse_loss)(
        ref_params, rargs[0], jnp.asarray(target), *rargs[1:], n_mesh,
        ref_cfg)
    loss, grads = _grads(
        lambda p, *a: graphcast.mse_loss(p, *a, n_mesh, cfg), params,
        args[0], _t(target), *args[1:])
    _close(loss, want_l)
    for g, w in zip(grads, jax.tree.leaves(ref_g), strict=True):
        _close(g, w, GRAD_TOL)


def test_graphcast_bf16_matches_within_its_rounding():
    """The published dtype (bf16) on the smoke's widths: port against the
    reference's bf16 run, and each against its own f32 run."""
    ref_cfg = dataclasses.replace(ref_registry.get("graphcast").SMOKE,
                                  n_layers=4, dtype="bfloat16")
    gx, g2m, me, m2g, n_mesh = _gc_inputs(3)
    ref_params = rgc.init_params(jax.random.PRNGKey(1), ref_cfg)
    rargs = tuple(jnp.asarray(a) for a in (gx, g2m, me, m2g))
    args = tuple(_t(a) for a in (gx, g2m, me, m2g))
    want = rgc.forward(ref_params, *rargs, n_mesh, ref_cfg)
    params = _carry(ref_params, ref_cfg)
    assert params["grid_embed"].dtype == torch.bfloat16
    got = graphcast.forward(params, *args, n_mesh, _port(ref_cfg))
    f32 = dataclasses.replace(_port(ref_cfg), dtype="float32")
    got32 = graphcast.forward(pytree.tree_map(lambda x: x.float(), params),
                              *args, n_mesh, f32)
    assert _rel_rms(got, want) < BF16_RMS
    assert _rel_rms(got, got32) < BF16_RMS
    assert _rel_rms(want, rgc.forward(
        jax.tree.map(lambda x: x.astype(jnp.float32), ref_params), *rargs,
        n_mesh, dataclasses.replace(ref_cfg, dtype="float32"))) < BF16_RMS


def test_graphcast_arch_smoke_matches():
    """Twin of tests/test_arch_smoke.py's graphcast branch."""
    ref_cfg = ref_registry.get("graphcast").SMOKE
    rng = np.random.default_rng(0)
    n_grid, n_mesh = 30, 8
    gx = rng.normal(size=(n_grid, ref_cfg.n_vars)).astype(np.float32)
    g2m = np.stack([rng.integers(0, n_grid, 60),
                    rng.integers(0, n_mesh, 60)]).astype(np.int32)
    me = rng.integers(0, n_mesh, (2, 40)).astype(np.int32)
    m2g = np.stack([rng.integers(0, n_mesh, 60),
                    rng.integers(0, n_grid, 60)]).astype(np.int32)
    ref_params = rgc.init_params(jax.random.PRNGKey(0), ref_cfg)
    want = rgc.forward(ref_params, *(jnp.asarray(a) for a in
                                     (gx, g2m, me, m2g)), n_mesh, ref_cfg)
    got = graphcast.forward(_carry(ref_params, ref_cfg),
                            *(_t(a) for a in (gx, g2m, me, m2g)), n_mesh,
                            registry.get("graphcast").smoke)
    assert got.shape == (n_grid, ref_cfg.n_vars)
    _close(got, want)
