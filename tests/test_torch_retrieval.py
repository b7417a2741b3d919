"""Port vs reference: SASRec, STREAK retrieval and the recsys data on the CPU.

The same seeded numpy inputs, and the reference's weights carried over by
`interop.params_from_state`, go through the reference (JAX on the CPU) and
the port (`device="cpu"`).

Tolerances: model outputs and losses 1e-5 relative and 1e-6 absolute
(f32 products summed in other orders: XLA's against torch's); gradients
1e-4 relative and 1e-5 absolute, as tests/test_torch_train.py. Retrieval:
ids in order and `blocks_read` equal; scores within 1e-6 relative (a
score is one f32 dot product of 8 to 50 terms, summed in another order).
On integer-valued catalogs every product and sum is exact, so there the
scores are equal and each tie is broken as the reference breaks it.
Stream batches: equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.data import recsys as rrec
from repro.models import sasrec as rsas
from repro.serve import retrieval as rret
from repro_torch import pytree
from repro_torch.configs import registry
from repro_torch.data import recsys
from repro_torch.interop import params_from_state
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import serve_topk
from repro_torch.models import sasrec
from repro_torch.serve import retrieval

TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
SCORE_TOL = dict(rtol=1e-6, atol=1e-6)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(
        got, torch.Tensor) else got, dtype=np.float32),
        np.asarray(want, dtype=np.float32), **tol)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _port(ref_cfg):
    """The port's config equal to a reference config."""
    return sasrec.SASRecConfig(**dataclasses.asdict(ref_cfg))


def _carry(ref_params, ref_cfg):
    return params_from_state(jax.tree.map(np.asarray, ref_params),
                             _port(ref_cfg), "cpu")


def _shapes(tree):
    return jax.tree.map(lambda x: tuple(x.shape), tree)


# ------------------------------------------------------------- registry ---
def test_sasrec_arch_matches_the_reference_config():
    mod = ref_registry.get("sasrec")
    arch = registry.get("sasrec")
    assert arch.family == mod.FAMILY == "recsys"
    assert dataclasses.asdict(arch.config) == dataclasses.asdict(mod.CONFIG)
    assert dataclasses.asdict(arch.smoke) == dataclasses.asdict(mod.SMOKE)
    assert registry.model_module(arch.config) is sasrec
    assert arch.config.n_params() == mod.CONFIG.n_params()
    assert registry.RECSYS_SHAPES == ref_registry.RECSYS_SHAPES


@pytest.mark.parametrize("which", ["smoke", "config"])
def test_param_shapes_are_the_reference_tree(which):
    ref_cfg = getattr(ref_registry.get("sasrec"), which.upper())
    want = _shapes(jax.eval_shape(lambda: rsas.init_params(
        jax.random.PRNGKey(0), ref_cfg)))
    cfg = getattr(registry.get("sasrec"), which)
    assert sasrec.param_shapes(cfg) == want
    if which == "smoke":
        got = sasrec.init_params(cfg, seed=0, device="cpu")
        assert pytree.tree_map(lambda x: tuple(x.shape), got) == want
        blk = got["blocks"][0]
        assert torch.equal(blk["ln1_scale"], torch.ones(cfg.embed_dim))
        assert torch.equal(blk["ln2_bias"], torch.zeros(cfg.embed_dim))


def test_init_params_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        sasrec.init_params(registry.get("sasrec").smoke)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_serve.serve_retrieval(registry.get("sasrec").smoke)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_topk.main(["--steps", "1"])


def test_carried_weights_are_checked_against_the_shapes():
    cfg = registry.get("sasrec").smoke
    state = jax.tree.map(np.asarray, rsas.init_params(
        jax.random.PRNGKey(0), ref_registry.get("sasrec").SMOKE))
    state["blocks"] = state["blocks"][:1]
    with pytest.raises(ValueError, match="items"):
        params_from_state(state, cfg, "cpu")
    state["blocks"] = state["blocks"] * 2
    state["blocks"][1] = dict(state["blocks"][1], wq=np.zeros((3, 3)))
    with pytest.raises(ValueError, match="blocks.1.wq"):
        params_from_state(state, cfg, "cpu")


# ---------------------------------------------------------------- model ---
@pytest.fixture(scope="module")
def model():
    """Reference weights (n_items=500, D=16, 2 blocks, S=10) and the port's
    copy, with sequences holding padding: row 0 starts with two pads, row 1
    is all padding (every query row's keys masked), row 2 none."""
    cfg = rsas.SASRecConfig(n_items=500, embed_dim=16, n_blocks=2,
                            seq_len=10, d_ff=24)
    ref_params = rsas.init_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(3)
    seq = rng.integers(1, 500, size=(4, 10)).astype(np.int32)
    seq[0, :2] = 0
    seq[1] = 0
    pos = rng.integers(1, 500, size=(4, 10)).astype(np.int32)
    pos[0, :3] = 0
    neg = rng.integers(1, 500, size=(4, 10)).astype(np.int32)
    return cfg, ref_params, _carry(ref_params, cfg), seq, pos, neg


def test_encode_and_scores_match(model):
    cfg, ref_params, params, seq, _, _ = model
    want = rsas.encode(ref_params, jnp.asarray(seq), cfg)
    got = sasrec.encode(params, _t(seq), cfg)
    assert got.shape == (4, 10, 16) and torch.isfinite(got).all()
    _close(got, want)
    st = sasrec.user_state(params, _t(seq), cfg)
    ref_st = rsas.user_state(ref_params, jnp.asarray(seq), cfg)
    _close(st, ref_st)
    cands = np.random.default_rng(4).integers(1, 500, (4, 20)).astype(
        np.int32)
    _close(sasrec.score_candidates(params, st, _t(cands)),
           rsas.score_candidates(ref_params, ref_st, jnp.asarray(cands)))
    _close(sasrec.score_all(params, st), rsas.score_all(ref_params, ref_st))


def test_all_padding_row_softmaxes_to_uniform_not_nan(model):
    """-1e30, not -inf: a row whose keys are all padding averages v."""
    cfg, ref_params, params, seq, _, _ = model
    got = sasrec.encode(params, _t(seq[1:2]), cfg)
    assert torch.isfinite(got).all()
    _close(got, rsas.encode(ref_params, jnp.asarray(seq[1:2]), cfg))


def test_bpr_loss_and_grads_match(model):
    cfg, ref_params, params, seq, pos, neg = model
    args = (jnp.asarray(seq), jnp.asarray(pos), jnp.asarray(neg))
    want, ref_g = jax.value_and_grad(rsas.bpr_loss)(ref_params, *args, cfg)
    leaves = [x.clone().requires_grad_(True) for x in pytree.leaves(params)]
    loss = sasrec.bpr_loss(pytree.unflatten(params, leaves), _t(seq),
                           _t(pos), _t(neg), cfg)
    _close(loss, want)
    grads = torch.autograd.grad(loss, leaves)
    for g, w in zip(grads, jax.tree.leaves(ref_g), strict=True):
        _close(g, w, GRAD_TOL)


def test_padding_masked_as_the_reference():
    """Twin of tests/test_models.py::test_sasrec_padding_masked."""
    cfg = rsas.SASRecConfig(n_items=100, embed_dim=8, n_blocks=1, seq_len=6)
    ref_params = rsas.init_params(jax.random.PRNGKey(0), cfg)
    params = _carry(ref_params, cfg)
    s = np.array([[0, 0, 5, 6, 7, 8]], dtype=np.int32)
    got = sasrec.user_state(params, _t(s), cfg)
    _close(got, rsas.user_state(ref_params, jnp.asarray(s), cfg))


def test_an_id_past_the_table_reads_the_last_row_and_gets_no_gradient():
    """InteractionStream draws positive items up to n_items, one past the
    table: the reference's gather clamps it and drops its gradient."""
    cfg = rsas.SASRecConfig(n_items=50, embed_dim=8, n_blocks=1, seq_len=4,
                            d_ff=8)
    ref_params = rsas.init_params(jax.random.PRNGKey(1), cfg)
    params = _carry(ref_params, cfg)
    seq = np.array([[3, 50, 7, 50]], dtype=np.int32)
    pos = np.array([[50, 7, 50, 9]], dtype=np.int32)
    neg = np.array([[4, 5, 6, 49]], dtype=np.int32)
    args = (jnp.asarray(seq), jnp.asarray(pos), jnp.asarray(neg))
    want, ref_g = jax.value_and_grad(rsas.bpr_loss)(ref_params, *args, cfg)
    table = params["item_embed"].clone().requires_grad_(True)
    loss = sasrec.bpr_loss(dict(params, item_embed=table), _t(seq), _t(pos),
                           _t(neg), cfg)
    _close(loss, want)
    (g,) = torch.autograd.grad(loss, [table])
    _close(g, ref_g["item_embed"], GRAD_TOL)
    _close(sasrec.take_rows(params["item_embed"], _t(seq)),
           ref_params["item_embed"][jnp.asarray(seq)])


def test_arch_smoke_user_state_matches():
    """Twin of tests/test_arch_smoke.py's recsys branch."""
    cfg = ref_registry.get("sasrec").SMOKE
    ref_params = rsas.init_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(0)
    seq = rng.integers(1, cfg.n_items, (3, cfg.seq_len)).astype(np.int32)
    want = rsas.user_state(ref_params, jnp.asarray(seq), cfg)
    got = sasrec.user_state(_carry(ref_params, cfg), _t(seq), cfg)
    assert got.shape == (3, cfg.embed_dim)
    _close(got, want)


# ------------------------------------------------------------ retrieval ---
def _catalog(seed, b, n, d, integer=False):
    rng = np.random.default_rng(seed)
    if integer:        # exact products: many equal scores
        return (rng.integers(-2, 3, (b, d)).astype(np.float32),
                rng.integers(-2, 3, (n, d)).astype(np.float32))
    state = rng.normal(size=(b, d)).astype(np.float32)
    items = (rng.normal(size=(n, d))
             * rng.exponential(1.0, size=(n, 1))).astype(np.float32)
    return state, items


CATALOGS = {     # (seed, B, N, D, k, block, integer)
    "twin_blocked": (4, 3, 1000, 16, 10, 128, False),
    "twin_streak": (5, 2, 2000, 16, 10, 128, False),
    "n_below_k": (6, 2, 50, 8, 100, 64, False),
    "ties": (7, 4, 700, 6, 25, 64, True),
    "ties_n_below_k": (8, 3, 40, 4, 64, 16, True),
    "launcher_block": (9, 8, 3000, 16, 10, 187, False),
}


@pytest.mark.parametrize("name", sorted(CATALOGS))
def test_blocked_topk_matches_reference(name):
    seed, b, n, d, k, block, integer = CATALOGS[name]
    state, items = _catalog(seed, b, n, d, integer)
    ws, wi = rret.blocked_topk(jnp.asarray(state), jnp.asarray(items), k=k,
                               block=block)
    gs, gi = retrieval.blocked_topk(_t(state), _t(items), k=k, block=block)
    assert gi.dtype == torch.int32 and gi.shape == (b, k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    if integer:
        np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    else:
        _close(gs, ws, SCORE_TOL)


@pytest.mark.parametrize("name", sorted(CATALOGS))
def test_streak_topk_matches_reference(name):
    seed, b, n, d, k, block, integer = CATALOGS[name]
    state, items = _catalog(seed, b, n, d, integer)
    r_sorted, r_order = rret.sort_items_by_norm(jnp.asarray(items), block)
    r_bounds = rret.block_bounds(r_sorted, block)
    ws, wi, wb = rret.streak_topk(jnp.asarray(state), r_sorted,
                                  r_order.astype(jnp.int32), r_bounds, k=k,
                                  block=block)
    items_sorted, order = retrieval.sort_items_by_norm(_t(items), block)
    np.testing.assert_array_equal(order.numpy(), np.asarray(r_order))
    bounds = retrieval.block_bounds(items_sorted, block)
    _close(bounds, r_bounds, SCORE_TOL)
    gs, gi, gb = retrieval.streak_topk(_t(state), items_sorted, order,
                                       bounds, k=k, block=block)
    assert gb == int(wb)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    if integer:
        np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    else:
        _close(gs, ws, SCORE_TOL)
    # exact: the same answer as the full scan (whose products take the
    # items in catalog order, so their scores may round otherwise)
    fs, fi = retrieval.blocked_topk(_t(state), _t(items), k=k, block=block)
    if integer:         # (with ties, equal scores may name other items)
        np.testing.assert_array_equal(gs.numpy(), fs.numpy())
    else:
        np.testing.assert_array_equal(gi.numpy(), fi.numpy())
        _close(gs, fs, SCORE_TOL)


def test_streak_topk_early_terminates_and_is_exact():
    """Twin of tests/test_substrate.py::
    test_streak_topk_exact_and_early_terminates."""
    state, items = _catalog(5, 2, 2000, 16)
    block = 128
    items_sorted, order = retrieval.sort_items_by_norm(_t(items), block)
    bounds = retrieval.block_bounds(items_sorted, block)
    scores, ids, blocks_read = retrieval.streak_topk(
        _t(state), items_sorted, order, bounds, k=10, block=block)
    dense = state @ items.T
    for b in range(2):
        np.testing.assert_allclose(scores[b].numpy(),
                                   np.sort(dense[b])[::-1][:10], rtol=1e-5)
        assert set(ids[b].tolist()) == set(np.argsort(-dense[b])[:10])
    assert blocks_read < -(-2000 // block)


def test_stable_topk_breaks_ties_by_position():
    """jax.lax.top_k on [1, 2, 2, -inf, -inf] gives ids [1, 2, 0, 3]."""
    s = torch.tensor([[1.0, 2.0, 2.0, -torch.inf, -torch.inf]])
    for k in (1, 2, 3, 4, 5):
        vals, pos = retrieval._stable_topk(s, k)
        want_v, want_p = jax.lax.top_k(jnp.asarray(s.numpy()), k)
        np.testing.assert_array_equal(pos.numpy(), np.asarray(want_p))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(want_v))
    assert retrieval._stable_topk(s, 4)[1].tolist() == [[1, 2, 0, 3]]


# ------------------------------------------------------------------ data ---
def test_interaction_stream_batches_equal_the_reference():
    for kw in (dict(), dict(process_index=1, process_count=2)):
        a = rrec.InteractionStream(300, 7, 6, seed=2, **kw)
        b = recsys.InteractionStream(300, 7, 6, seed=2, **kw)
        for step in (0, 5):
            for x, y in zip(a.batch(step), b.batch(step), strict=True):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)


def _bag_inputs(seed):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(20, 5)).astype(np.float32)
    idx = rng.integers(0, 20, 11).astype(np.int32)
    off = np.array([0, 3, 3, 7, 11], dtype=np.int32)   # bags 1 and 4 empty
    w = rng.normal(size=11).astype(np.float32)
    return table, idx, off, w


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_matches_reference(mode, weighted):
    table, idx, off, w = _bag_inputs(1)
    w = w if weighted else None
    want = rrec.embedding_bag(jnp.asarray(table), jnp.asarray(idx),
                              jnp.asarray(off), mode,
                              None if w is None else jnp.asarray(w))
    got = recsys.embedding_bag(_t(table), _t(idx), _t(off), mode,
                               None if w is None else _t(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


def test_embedding_bag_empty_max_bag_is_minus_inf():
    """F.embedding_bag gives 0 there; the reference's segment max -inf."""
    table, idx, off, _ = _bag_inputs(2)
    got = recsys.embedding_bag(_t(table), _t(idx), _t(off), "max")
    assert torch.isneginf(got[1]).all() and torch.isneginf(got[4]).all()
    assert torch.isfinite(got[[0, 2, 3]]).all()
    empty = recsys.embedding_bag(_t(table), _t(idx), _t(off), "mean")
    assert torch.equal(empty[1], torch.zeros(5))


def test_embedding_bag_modes_twin():
    """Twin of tests/test_substrate.py::test_embedding_bag_modes."""
    table = torch.arange(20.0).reshape(10, 2)
    idx, off = torch.tensor([0, 1, 2, 5]), torch.tensor([0, 2])
    assert recsys.embedding_bag(table, idx, off, "sum").tolist() == \
        [[2, 4], [14, 16]]
    assert recsys.embedding_bag(table, idx, off, "mean").tolist() == \
        [[1, 2], [7, 8]]


# ------------------------------------------------------------- launchers ---
def test_serve_retrieval_on_the_cpu_is_exact_and_terminates_early():
    cfg = registry.get("sasrec").smoke
    r = launch_serve.serve_retrieval(cfg, device="cpu")
    assert r["device"] == "cpu" and r["block"] == 64 and r["n_blocks"] == 16
    assert 0 < r["blocks_read"] < r["n_blocks"]
    params, seq = launch_serve.popularity_catalog(cfg, "cpu")
    with torch.no_grad():
        state = sasrec.user_state(params, seq, cfg)
        dense = sasrec.score_all(params, state)
    assert torch.equal(state, r["state"])
    want = torch.sort(dense, dim=1, descending=True, stable=True)
    np.testing.assert_array_equal(r["ids"].numpy(), want.indices[:, :10])
    np.testing.assert_allclose(r["scores"].numpy(), want.values[:, :10],
                               rtol=1e-6)


def test_serve_launcher_main_dispatches_on_the_family(capsys):
    import sys
    argv = sys.argv
    try:
        sys.argv = ["serve", "--arch", "sasrec", "--smoke", "--device",
                    "cpu"]
        launch_serve.main()
        assert "early-out read" in capsys.readouterr().out
        sys.argv = ["serve", "--arch", "gcn-cora", "--smoke", "--device",
                    "cpu"]
        with pytest.raises(SystemExit, match="no serve path for family gnn"):
            launch_serve.main()
    finally:
        sys.argv = argv


def test_serve_topk_agrees_with_the_full_scan_on_the_cpu(capsys):
    r = serve_topk.main(["--steps", "8", "--device", "cpu"])
    assert len(r["losses"]) == 8 and np.isfinite(r["losses"]).all()
    assert 0 < r["blocks_read"] < r["n_blocks"] == 20
    assert "exactness check" in capsys.readouterr().out
