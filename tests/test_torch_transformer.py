"""Port vs reference: the dense LM (`models/transformer.py`) on the CPU.

The three dense `SMOKE` configs (f32) of the reference, their weights drawn
by the reference's `init_params` and carried over by
`interop.params_from_state`, the same numpy tokens through both
packages: `forward` + `logits_fn`, `forward_with_cache` (flash at S=128,
plain, query-chunked), and `decode_step` under both cache-update modes and
with a sliding window.

Tolerance: 1e-4 absolute and relative on f32 logits, hidden states and
caches of order 1. XLA:CPU and torch sum the products of each matrix
product (up to 512 terms) in different orders and XLA contracts some of
them into fused multiply-adds, which moves f32 results by a few ulps
(~1e-6) a layer; 1e-4 leaves room for that over two layers, while a
reduced-precision product (TF32 or bf16, ~1e-3 relative) would fail it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.models import transformer as rtr
from repro_torch.configs import registry
from repro_torch.interop import params_from_state
from repro_torch.models import transformer as ttr

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["gemma-7b", "codeqwen1.5-7b", "nemotron-4-15b"]


def _cfgs(arch, **over):
    ref_cfg = dataclasses.replace(ref_registry.get(arch).SMOKE, **over)
    cfg = dataclasses.replace(registry.get(arch).smoke, **over)
    return ref_cfg, cfg


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    ref_cfg, cfg = _cfgs(request.param)
    ref_params = rtr.init_params(jax.random.PRNGKey(0), ref_cfg)
    state = jax.tree.map(np.asarray, ref_params)
    return request.param, ref_params, params_from_state(state, cfg, "cpu")


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s),
                                                dtype=np.int32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(want, dtype=np.float32), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference(arch):
    mod = ref_registry.get(arch)
    for ref_cfg, cfg in ((mod.CONFIG, registry.get(arch).config),
                         (mod.SMOKE, registry.get(arch).smoke)):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
        assert cfg.n_params() == ref_cfg.n_params()
        assert cfg.torch_dtype == getattr(torch, ref_cfg.dtype)
    assert registry.get(arch).family == mod.FAMILY == "lm"


def test_params_carry_over_with_their_shapes(model):
    arch, ref_params, params = model
    flat_ref = jax.tree_util.tree_leaves_with_path(ref_params)
    for path, leaf in flat_ref:
        node = params
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


def test_bf16_state_crosses_as_bit_patterns():
    ref_cfg, cfg = _cfgs("gemma-7b", dtype="bfloat16")
    state = jax.tree.map(np.asarray,
                         rtr.init_params(jax.random.PRNGKey(1), ref_cfg))
    params = params_from_state(state, cfg, "cpu")
    assert params["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        params["layers"]["wq"].view(torch.int16).numpy(),
        state["layers"]["wq"].view(np.int16))
    state["layers"]["wq"] = state["layers"]["wq"][:, :-1]
    with pytest.raises(ValueError, match="wq"):
        params_from_state(state, cfg, "cpu")


def test_forward_and_logits_match(model):
    arch, ref_params, params = model
    ref_cfg, cfg = _cfgs(arch)
    tok = _tokens(cfg, 2, 128)
    want_h = rtr.forward(ref_params, jnp.asarray(tok), ref_cfg)
    got_h = ttr.forward(params, torch.from_numpy(tok), cfg)
    _close(got_h, want_h)
    _close(ttr.logits_fn(params, got_h, cfg),
           rtr.logits_fn(ref_params, want_h, ref_cfg))


@pytest.mark.parametrize("variant", [
    dict(use_flash=True),                 # the kernel's branch, S % 128 == 0
    dict(),                               # plain attention
    dict(attn_chunk=32),                  # query-chunked plain attention
])
def test_forward_with_cache_matches(model, variant):
    arch, ref_params, params = model
    ref_cfg, cfg = _cfgs(arch, **variant)
    tok = _tokens(cfg, 2, 128, seed=1)
    want_l, want_c = rtr.forward_with_cache(ref_params, jnp.asarray(tok),
                                            ref_cfg)
    got_l, got_c = ttr.forward_with_cache(params, torch.from_numpy(tok), cfg)
    _close(got_l, want_l)
    for name in ("k", "v"):
        assert tuple(got_c[name].shape) == want_c[name].shape
        _close(got_c[name], want_c[name])


@pytest.mark.parametrize("over", [
    dict(),                               # one-hot multiply-add update
    dict(scatter_cache_update=True),      # per-slot scatter update
    dict(window=3),                       # sliding window over the cache
])
def test_decode_steps_match(model, over):
    """Three slots at different positions over a cache that already holds
    values (each update must overwrite), three steps in a row."""
    arch, ref_params, params = model
    ref_cfg, cfg = _cfgs(arch, **over)
    rng = np.random.default_rng(2)
    shape = (cfg.n_layers, 3, 16, cfg.n_kv_heads, cfg.head_dim)
    cache_np = {n: rng.normal(size=shape).astype(np.float32)
                for n in ("k", "v")}
    ref_cache = {n: jnp.asarray(c) for n, c in cache_np.items()}
    cache = {n: torch.from_numpy(c.copy()) for n, c in cache_np.items()}
    pos = np.array([5, 0, 9], dtype=np.int32)
    for step in range(3):
        tok = rng.integers(0, cfg.vocab, 3, dtype=np.int32)
        want_l, ref_cache = rtr.decode_step(ref_params, ref_cache,
                                            jnp.asarray(tok),
                                            jnp.asarray(pos), ref_cfg)
        got_l, cache = ttr.decode_step(params, cache, torch.from_numpy(tok),
                                       torch.from_numpy(pos), cfg)
        _close(got_l, want_l)
        for name in ("k", "v"):
            _close(cache[name], ref_cache[name])
        pos = pos + 1


def test_sharding_axes_are_refused():
    """Sharding axes with no mesh in context are refused with the
    reference's RuntimeError (under a mesh that has them the forward runs:
    tests/test_torch_mesh.py)."""
    ref_cfg, cfg = _cfgs("gemma-7b", batch_axes=("data",))
    params = ttr.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="mesh"):
        ttr.forward(params, torch.zeros((1, 4), dtype=torch.int64), cfg)
    ref_params = rtr.init_params(jax.random.PRNGKey(0), ref_cfg)
    with pytest.raises(RuntimeError, match="mesh"):
        rtr.forward(ref_params, jnp.zeros((1, 4), jnp.int32), ref_cfg)
