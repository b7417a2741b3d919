"""Port vs reference: the MoE LM (`models/moe.py`) on the CPU.

The two MoE `SMOKE` configs (f32) and the reference tests' own small
configs, weights drawn by the reference's `init_params` and carried over by
`interop.params_from_state`, the same numpy inputs through both
packages: `moe_ffn` (outputs, aux, the pairs dropped at capacity),
`forward`, `lm_loss` and its gradients (padding experts included),
`forward_with_cache` and `decode_step`.

Tolerances: 1e-5 absolute and relative on one `moe_ffn` (one router
product, three expert products, f32); 1e-4 on whole-model hidden states,
logits, losses and caches (products summed in other orders and XLA's
fused multiply-adds move f32 results by a few ulps a layer, see
tests/test_torch_transformer.py); gradients 1e-4 relative and 1e-5
absolute, as the reference's own micro-batch test holds them. Routing is
discrete: both packages must choose the same experts and drop the same
pairs, which these inputs (no near-tied router probabilities) allow.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.models import moe as rmoe
from repro_torch import pytree
from repro_torch.configs import registry
from repro_torch.interop import params_from_state
from repro_torch.models import moe as tmoe

ARCHS = ["qwen2-moe-a2.7b", "qwen3-moe-30b-a3b"]
FFN_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)

# tests/test_models.py's two MoE configs: padded experts with a shared one,
# and a capacity factor of 8
PADDED = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
              vocab=64, n_experts=6, n_experts_padded=8, top_k=2,
              d_ff_expert=32, n_shared=1, dtype="float32", remat=False,
              loss_chunks=1)
CAP8 = dict(n_layers=1, d_model=16, n_heads=1, n_kv_heads=1, head_dim=16,
            vocab=32, n_experts=4, n_experts_padded=4, top_k=1,
            d_ff_expert=16, capacity_factor=8.0, dtype="float32",
            remat=False)
# capacity that drops: 64 tokens x top-2 over 4 experts at factor 0.5 gives
# 16 slots an expert for 32 pairs on average
DROPS = dict(CAP8, top_k=2, capacity_factor=0.5)


def _cfgs(arch=None, **fields):
    if arch is not None:
        ref_cfg = dataclasses.replace(ref_registry.get(arch).SMOKE, **fields)
        return ref_cfg, dataclasses.replace(registry.get(arch).smoke,
                                            **fields)
    return rmoe.MoEConfig(**fields), tmoe.MoEConfig(**fields)


def _params(ref_cfg, cfg, seed=0):
    ref_params = rmoe.init_params(jax.random.PRNGKey(seed), ref_cfg)
    return ref_params, params_from_state(
        jax.tree.map(np.asarray, ref_params), cfg, "cpu")


@pytest.fixture(scope="module", params=ARCHS)
def smoke(request):
    ref_cfg, cfg = _cfgs(request.param)
    return (request.param, ref_cfg, cfg) + _params(ref_cfg, cfg)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(want, dtype=np.float32), **tol)


def _tokens(vocab, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s),
                                                dtype=np.int32)


def _layer0(ref_params, params):
    return (jax.tree.map(lambda a: a[0], ref_params["layers"]),
            {k: ({kk: vv[0] for kk, vv in v.items()} if isinstance(v, dict)
                 else v[0]) for k, v in params["layers"].items()})


def _dropped(top_e, n_experts_padded, cap) -> int:
    counts = np.bincount(np.asarray(top_e).reshape(-1),
                         minlength=n_experts_padded)
    return int(np.maximum(counts - cap, 0).sum())


# ----------------------------------------------------------- configs ---
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference(arch):
    mod = ref_registry.get(arch)
    arch_ = registry.get(arch)
    assert arch_.family == mod.FAMILY == "moe"
    for ref_cfg, cfg in ((mod.CONFIG, arch_.config),
                         (mod.SMOKE, arch_.smoke)):
        assert isinstance(cfg, tmoe.MoEConfig)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
        assert cfg.n_params() == ref_cfg.n_params()
        assert cfg.n_active_params() == ref_cfg.n_active_params()
        assert cfg.torch_dtype == getattr(torch, ref_cfg.dtype)
    assert registry.model_module(arch_.config) is tmoe


def test_full_configs_pin_the_assignment():
    """The MoE rows of tests/test_arch_smoke.py's assignment pins."""
    c = registry.get("qwen2-moe-a2.7b").config
    assert (c.n_layers, c.d_model, c.n_experts, c.top_k, c.d_ff_expert,
            c.n_shared, c.vocab) == (24, 2048, 60, 4, 1408, 4, 151936)
    assert c.n_experts_padded == 64
    c = registry.get("qwen3-moe-30b-a3b").config
    assert (c.n_layers, c.d_model, c.n_kv_heads, c.n_experts, c.top_k,
            c.d_ff_expert, c.vocab) == (48, 2048, 4, 128, 8, 768, 151936)
    assert registry.get("qwen2-moe-a2.7b").source.startswith(
        "hf:Qwen/Qwen1.5-MoE-A2.7B")
    assert registry.get("qwen3-moe-30b-a3b").source.startswith(
        "hf:Qwen/Qwen3-30B-A3B")


def test_params_carry_over_and_shapes_are_checked(smoke):
    arch, ref_cfg, cfg, ref_params, params = smoke
    want = jax.tree_util.tree_leaves(ref_params)
    got = pytree.leaves(params)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert params["layers"]["we_up"].shape == (
        cfg.n_layers, cfg.n_experts_padded, cfg.d_model, cfg.d_ff_expert)
    state = jax.tree.map(np.asarray, ref_params)
    state["layers"]["we_down"] = state["layers"]["we_down"][:, :-1]
    with pytest.raises(ValueError, match="we_down"):
        params_from_state(state, cfg, "cpu")
    state = jax.tree.map(np.asarray, ref_params)
    state["layers"]["extra"] = state["layers"]["wq"]
    with pytest.raises(ValueError, match="keys"):
        params_from_state(state, cfg, "cpu")


def test_init_params_has_the_shapes_and_never_picks_padding():
    _, cfg = _cfgs(**PADDED)
    params = tmoe.init_params(cfg, seed=1, device="cpu")
    shapes = tmoe.param_shapes(cfg)
    assert [tuple(x.shape) for x in pytree.leaves(params)] == \
        pytree.leaves(shapes)
    # fan-in scaling as the reference's: D for the gate, F for down
    for name, fan_in in (("we_gate", cfg.d_model),
                         ("we_down", cfg.d_ff_expert)):
        std = float(params["layers"][name].std())
        assert abs(std * fan_in ** 0.5 - 1) < 0.1
    x = torch.randn(40, cfg.d_model, generator=torch.Generator().manual_seed(0))
    probs, _, top_e = tmoe.route(
        {k: v[0] for k, v in params["layers"].items()
         if not isinstance(v, dict)}, x, cfg)
    assert int(top_e.max()) < cfg.n_experts
    assert float(probs[:, cfg.n_experts:].abs().max()) == 0.0


# --------------------------------------------------------------- FFN ---
@pytest.mark.parametrize("case", ARCHS + ["cap8", "drops"])
def test_moe_ffn_matches_reference(case):
    if case in ARCHS:
        ref_cfg, cfg = _cfgs(case)
    else:
        ref_cfg, cfg = _cfgs(**(CAP8 if case == "cap8" else DROPS))
    ref_lp, lp = _layer0(*_params(ref_cfg, cfg, seed=2))
    x = np.random.default_rng(3).normal(size=(64, cfg.d_model)).astype(
        np.float32)
    want_y, want_aux = rmoe.moe_ffn(ref_lp, jnp.asarray(x), ref_cfg)
    got_y, got_aux = tmoe.moe_ffn(lp, torch.from_numpy(x), cfg)
    _close(got_y, want_y, FFN_TOL)
    _close(got_aux, want_aux, FFN_TOL)
    # the same experts, so the same pairs dropped at capacity
    cap = tmoe.capacity(64, cfg)
    ref_probs = jax.nn.softmax(
        jnp.where(jnp.arange(cfg.n_experts_padded) >= cfg.n_experts, -1e30,
                  jnp.asarray(x) @ ref_lp["router"]), axis=-1)
    want_e = np.asarray(jax.lax.top_k(ref_probs, cfg.top_k)[1])
    got_e = tmoe.route(lp, torch.from_numpy(x), cfg)[2].numpy()
    np.testing.assert_array_equal(np.sort(got_e, 1), np.sort(want_e, 1))
    dropped = _dropped(got_e, cfg.n_experts_padded, cap)
    assert dropped == _dropped(want_e, cfg.n_experts_padded, cap)
    if case == "drops":
        assert dropped > 0
    if case == "cap8":     # the reference test's claim: nothing dropped
        assert dropped == 0 and bool((got_y.abs().sum(-1) > 0).all())


def test_capacity_rounds_half_to_even_like_the_reference():
    """5 tokens x top-2 / 4 experts x 1.0 = 2.5: Python's round gives 2
    (the even neighbour), not 3, and the outputs still match, with the
    third pair of a full expert dropped in both."""
    fields = dict(CAP8, top_k=2, capacity_factor=1.0)
    ref_cfg, cfg = _cfgs(**fields)
    assert 5 * 2 / 4 * 1.0 == 2.5 and tmoe.capacity(5, cfg) == 2
    assert tmoe.capacity(7, cfg) == 4       # 3.5 -> 4, also even
    ref_lp, lp = _layer0(*_params(ref_cfg, cfg, seed=4))
    for seed in range(6):
        x = np.random.default_rng(seed).normal(size=(5, 16)).astype(
            np.float32)
        want_y, want_aux = rmoe.moe_ffn(ref_lp, jnp.asarray(x), ref_cfg)
        got_y, got_aux = tmoe.moe_ffn(lp, torch.from_numpy(x), cfg)
        _close(got_y, want_y, FFN_TOL)
        _close(got_aux, want_aux, FFN_TOL)


# ------------------------------------------------ forward, loss, grads ---
def test_forward_and_loss_match(smoke):
    arch, ref_cfg, cfg, ref_params, params = smoke
    tok = _tokens(cfg.vocab, 2, 33)
    want_h, want_aux = rmoe.forward(ref_params, jnp.asarray(tok[:, :-1]),
                                    ref_cfg)
    got_h, got_aux = tmoe.forward(params, torch.from_numpy(tok[:, :-1]), cfg)
    _close(got_h, want_h)
    _close(got_aux, want_aux)
    _close(tmoe.lm_loss(params, torch.from_numpy(tok), cfg),
           rmoe.lm_loss(ref_params, jnp.asarray(tok), ref_cfg))


def _grads(params, loss):
    leaves = pytree.leaves(params)
    return torch.autograd.grad(loss(), leaves)


@pytest.fixture(scope="module")
def padded():
    """The reference's loss and gradients on the padded config (remat and
    loss chunks change neither)."""
    ref_cfg, cfg = _cfgs(**PADDED)
    ref_params, _ = _params(ref_cfg, cfg)
    tok = _tokens(cfg.vocab, 2, 17, seed=1)
    want, want_g = jax.value_and_grad(rmoe.lm_loss)(
        ref_params, jnp.asarray(tok), ref_cfg)
    return ref_cfg, ref_params, tok, want, want_g


@pytest.mark.parametrize("variant", [dict(), dict(remat=True, loss_chunks=4)])
def test_loss_and_grads_with_padding_experts(padded, variant):
    """tests/test_models.py's padded config: equal loss and gradients, also
    with per-layer recomputation and a chunked vocab projection, and the
    padding experts get no routing and exactly zero gradient (their expert
    weights and their router columns)."""
    ref_cfg, ref_params, tok, want, want_g = padded
    cfg = tmoe.MoEConfig(**dict(PADDED, **variant))
    params = params_from_state(jax.tree.map(np.asarray, ref_params), cfg,
                               "cpu")
    for x in pytree.leaves(params):
        x.requires_grad_(True)
    loss = tmoe.lm_loss(params, torch.from_numpy(tok), cfg)
    _close(loss.detach(), want)
    got_g = torch.autograd.grad(loss, pytree.leaves(params))
    for g, w in zip(got_g, jax.tree_util.tree_leaves(want_g)):
        _close(g, w, GRAD_TOL)
    g = pytree.unflatten(params, got_g)["layers"]
    for name in ("we_up", "we_gate", "we_down"):
        assert float(g[name][:, cfg.n_experts:].abs().max()) == 0.0
        assert float(g[name][:, :cfg.n_experts].abs().max()) > 0.0
    assert float(g["router"][..., cfg.n_experts:].abs().max()) == 0.0
    with torch.no_grad():
        h, aux = tmoe.forward(params, torch.from_numpy(tok), cfg)
    assert float(aux) > 0.0 and torch.isfinite(h).all()


def test_loss_grads_match_on_the_smokes(smoke):
    arch, ref_cfg, cfg, ref_params, params = smoke
    tok = _tokens(cfg.vocab, 2, 17, seed=2)
    want_g = jax.grad(rmoe.lm_loss)(ref_params, jnp.asarray(tok), ref_cfg)
    leaves = [x.clone().requires_grad_(True) for x in pytree.leaves(params)]
    p = pytree.unflatten(params, leaves)
    got_g = torch.autograd.grad(tmoe.lm_loss(p, torch.from_numpy(tok), cfg),
                                leaves)
    for g, w in zip(got_g, jax.tree_util.tree_leaves(want_g)):
        _close(g, w, GRAD_TOL)


# -------------------------------------------------- prefill and decode ---
@pytest.mark.parametrize("variant", [dict(use_flash=True), dict(),
                                     dict(attn_chunk=32)])
def test_forward_with_cache_matches(smoke, variant):
    arch, ref_cfg, cfg, ref_params, params = smoke
    ref_cfg = dataclasses.replace(ref_cfg, **variant)
    cfg = dataclasses.replace(cfg, **variant)
    tok = _tokens(cfg.vocab, 2, 128, seed=5)
    want_l, want_c = rmoe.forward_with_cache(ref_params, jnp.asarray(tok),
                                             ref_cfg)
    got_l, got_c = tmoe.forward_with_cache(params, torch.from_numpy(tok),
                                           cfg)
    _close(got_l, want_l)
    for n in ("k", "v"):
        assert tuple(got_c[n].shape) == want_c[n].shape
        _close(got_c[n], want_c[n])


def test_decode_steps_match_with_slots_that_collide(smoke):
    """Four slots decoded together at their own positions, one of them
    idle at 0, as the serve engine steps them: qwen2's smoke routes 16
    pairs over 6 experts at capacity 3 (4 x 4 / 6 x 1.25 rounds to 3), so
    pairs are dropped; qwen3's sends every token to all 8 experts at
    capacity 4 = T. Each step's logits and the caches equal the
    reference's."""
    arch, ref_cfg, cfg, ref_params, params = smoke
    ref_cfg = dataclasses.replace(ref_cfg, scatter_cache_update=True)
    b, max_seq = 4, 12
    rng = np.random.default_rng(6)
    tok = rng.integers(0, cfg.vocab, (8, b), dtype=np.int32)
    ref_cache = rmoe.init_cache(ref_cfg, b, max_seq)
    cache = tmoe.init_cache(cfg, b, max_seq, device="cpu")
    for t in range(8):
        pos = np.array([t, t, max(t - 2, 0), 0], dtype=np.int32)
        want, ref_cache = rmoe.decode_step(ref_params, ref_cache,
                                           jnp.asarray(tok[t]),
                                           jnp.asarray(pos), ref_cfg)
        got, cache = tmoe.decode_step(params, cache, torch.from_numpy(tok[t]),
                                      torch.from_numpy(pos), cfg)
        _close(got, want)
    for n in ("k", "v"):
        _close(cache[n], ref_cache[n])


def test_reference_onehot_decode_adds_where_the_port_overwrites(smoke):
    """The reference MoE's default (one-hot) cache update ADDS the new K/V
    row to what the cache holds at that position, while its scatter mode
    and the dense model's one-hot mode overwrite it. A slot that writes a
    position twice (the serve engine steps idle slots at their position
    with token 0) then holds k1 + k2 there in the reference's default mode.
    The port overwrites in both modes, so it equals the reference's scatter
    mode and differs from its one-hot mode exactly at the rewritten rows
    (ROADMAP section 3)."""
    arch, ref_cfg, cfg, ref_params, params = smoke
    toks = [np.array([3, 4], dtype=np.int32), np.array([5, 6], dtype=np.int32)]
    pos = np.array([0, 0], dtype=np.int32)
    caches = {}
    for mode in (False, True):
        rc = dataclasses.replace(ref_cfg, scatter_cache_update=mode)
        c = rmoe.init_cache(rc, 2, 4)
        for t in toks:
            _, c = rmoe.decode_step(ref_params, c, jnp.asarray(t),
                                    jnp.asarray(pos), rc)
        caches[mode] = np.asarray(c["k"])
    c = tmoe.init_cache(cfg, 2, 4, device="cpu")
    for t in toks:
        _, c = tmoe.decode_step(params, c, torch.from_numpy(t),
                                torch.from_numpy(pos), cfg)
    _close(c["k"], caches[True])
    assert not np.allclose(caches[False][:, :, 0], caches[True][:, :, 0],
                           atol=1e-2)
    np.testing.assert_array_equal(caches[False][:, :, 1:],
                                  caches[True][:, :, 1:])


def test_decode_at_capacity_one_drops_like_the_reference():
    """Two slots whose tokens pick the same expert at capacity 1
    (2 tokens x top-1 / 4 experts x 1.25 rounds to 1): the later slot's
    pair is dropped in both packages, so its routed output is zero and its
    logits still match."""
    fields = dict(CAP8, n_layers=2, top_k=1, capacity_factor=1.25)
    ref_cfg, cfg = _cfgs(**fields)
    assert tmoe.capacity(2, cfg) == 1
    ref_params, params = _params(ref_cfg, cfg, seed=7)
    lp = {k: v[0] for k, v in params["layers"].items()
          if not isinstance(v, dict)}
    # the same token in both slots at the same position: identical router
    # inputs in every layer, so the same expert
    tokens = np.array([5, 5], dtype=np.int32)
    pos = np.array([0, 0], dtype=np.int32)
    x = params["embed"][torch.from_numpy(tokens)]
    want, _ = rmoe.decode_step(ref_params, rmoe.init_cache(ref_cfg, 2, 4),
                               jnp.asarray(tokens), jnp.asarray(pos), ref_cfg)
    got, _ = tmoe.decode_step(params, tmoe.init_cache(cfg, 2, 4,
                                                      device="cpu"),
                              torch.from_numpy(tokens), torch.from_numpy(pos),
                              cfg)
    _close(got, want)
    # the two slots saw the same input but only slot 0 was routed
    assert not torch.allclose(got[0], got[1])
    y, _ = tmoe.moe_ffn(lp, x, cfg)
    assert float(y[1].abs().max()) == 0.0 and float(y[0].abs().max()) > 0


def test_flash_is_refused_under_autograd():
    """The kernel is forward-only (as the reference's): a loss with
    use_flash whose gradient is taken raises instead of running it."""
    _, cfg = _cfgs("qwen2-moe-a2.7b", use_flash=True)
    params = tmoe.init_params(cfg, seed=0, device="cpu")
    for x in pytree.leaves(params):
        x.requires_grad_(True)
    tok = torch.from_numpy(_tokens(cfg.vocab, 1, 129))
    with pytest.raises(RuntimeError, match="forward-only"):
        tmoe.lm_loss(params, tok, cfg)
    with torch.no_grad():
        assert torch.isfinite(tmoe.lm_loss(params, tok, cfg))
