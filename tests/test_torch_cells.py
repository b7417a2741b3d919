"""Port vs reference: the cell builder (`repro_torch.launch.cells`).

Layouts: all 40 (arch x shape) cells build on both production meshes as
abstract inputs (no memory), every leaf divided evenly by its sharding.

Steps: at the smoke configs and small shapes, on a one-position CPU mesh,
each family's cell step on real tensors equals the reference's step
composed inline from its own modules (its `launch/cells.py` does not
import: ROADMAP §3): `jax.value_and_grad` + `optim.apply_updates`, the
micro-batch scan, `forward_with_cache`, `decode_step`, the GNN, GraphCast
and NequIP losses, `blocked_topk`/`streak_topk`. Parameters are carried
across by `interop`; the batches are the cell's own seeded draws.

Tolerances are those of the existing port tests of these modules: LM
losses and logits 1e-4 (tests/test_torch_train.py), gradient-derived
moments 1e-4 relative and 1e-5 absolute; GNN, GraphCast and NequIP losses
1e-5 relative and 1e-6 absolute (tests/test_torch_gnn.py); top-k ids
equal, scores 1e-5 (tests/test_torch_retrieval.py), and where the
reference's two neighbouring scores tie within that tolerance the ids may
come in either order (each side computes its own user states).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.models import equivariant as req
from repro.models import gnn as rgnn
from repro.models import graphcast as rgc
from repro.models import moe as rmoe
from repro.models import sasrec as rsas
from repro.models import transformer as rtr
from repro.serve import retrieval as rret
from repro.train import optim as roptim
from repro_torch import pytree
from repro_torch.configs import registry
from repro_torch.interop import params_from_state
from repro_torch.launch import cells
from repro_torch.launch.mesh import (make_host_mesh, make_production_mesh,
                                     placeholder_devices)

LM_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
GNN_TOL = dict(rtol=1e-5, atol=1e-6)
RET_TOL = dict(rtol=1e-5, atol=1e-5)


def _close(got, want, tol):
    np.testing.assert_allclose(
        np.asarray(got.detach().float() if torch.is_tensor(got) else got,
                   dtype=np.float32),
        np.asarray(want, dtype=np.float32), **tol)


# --------------------------------------------------------------- layouts --
@pytest.mark.parametrize("multi_pod", [False, True])
def test_all_cells_build_and_divide_evenly(multi_pod):
    mesh = make_production_mesh(multi_pod=multi_pod,
                                devices=placeholder_devices(512))
    n = 0
    for arch, shape in registry.all_cells():
        for variant in cells.variants(arch, shape):
            cell = cells.build_cell(arch, shape, mesh, variant=variant)
            for a in cells.abstract_leaves(cell):
                assert a.sharding is not None and a.sharding.mesh == mesh
                assert a.local_nbytes() * math_parts(a) == a.nbytes
            n += 1
    assert len(registry.all_cells()) == 40 and n == 40 + 23 + 5


def math_parts(a) -> int:
    out = 1
    for d in range(len(a.shape)):
        out *= a.sharding.parts(d)
    return out


def test_uneven_head_rules_replicate():
    """nemotron-4-15b's 8 and qwen3-moe's 4 KV heads on model = 16: wk and
    wv replicate, and so does the KV cache's head axis; no other LM rule
    is dropped."""
    mesh = make_production_mesh(devices=placeholder_devices(256))
    for arch in ("gemma-7b", "codeqwen1.5-7b", "nemotron-4-15b",
                 "qwen2-moe-a2.7b", "qwen3-moe-30b-a3b"):
        cell = cells.build_cell(arch, "decode_32k", mesh)
        p = cell.args[0]["layers"]
        kv = registry.get(arch).config.n_kv_heads
        want = ("model",) if kv % 16 == 0 else ()
        assert p["wk"].sharding.spec.axes(2) == want
        assert cell.args[1]["k"].sharding.spec.axes(3) == want
        assert p["wq"].sharding.spec.axes(2) == ("model",)


# ----------------------------------------------------------------- steps --
ONE = make_host_mesh(devices=["cpu"])
SMALL_LM = {"train_4k": dict(kind="train", seq_len=32, global_batch=8),
            "prefill_32k": dict(kind="prefill", seq_len=32, global_batch=2),
            "decode_32k": dict(kind="decode", seq_len=16, global_batch=2)}
SMALL_GNN = {"full_graph_sm": dict(kind="full", n_nodes=40, n_edges=160,
                                   d_feat=12, n_classes=5),
             "minibatch_lg": dict(kind="sampled", n_nodes=1000,
                                  n_edges=5000, batch_nodes=4,
                                  fanout=(3, 2), d_feat=10, n_classes=6),
             "molecule": dict(kind="batched", n_nodes=6, n_edges=12,
                              batch=4, d_feat=4, n_classes=1)}


def _np(tree):
    return pytree.tree_map(lambda t: np.asarray(t.detach().cpu()), tree) \
        if isinstance(tree, (dict, list)) else np.asarray(tree.cpu())


def _carry(ref_params, cfg):
    return params_from_state(jax.tree.map(np.asarray, ref_params), cfg,
                             "cpu")


def _port(cell, seed, ref_params, cfg):
    """The cell's seeded args with the reference's parameters carried in
    (and fresh optimizer state for a training step)."""
    args = list(cells.materialize(cell, device="cpu", seed=seed))
    args[0] = _carry(ref_params, cfg)
    if len(args) > 1 and isinstance(args[1], dict) and "step" in args[1]:
        from repro_torch.train import optim
        args[1] = optim.init_state(args[0])
    return args


def _ref_train(loss_fn, p, *batch, n_micro=1):
    """The reference's training step, jitted as its dry run lowers it."""
    return jax.jit(lambda p, *b: _ref_step(loss_fn, p, *b,
                                           n_micro=n_micro))(p, *batch)


def _ref_step(loss_fn, p, *batch, n_micro=1):
    o = roptim.init_state(p)
    if n_micro == 1:
        loss, g = jax.value_and_grad(loss_fn)(p, *batch)
    else:
        (tok,) = batch
        mb = tok.reshape(n_micro, tok.shape[0] // n_micro, -1)

        def micro(gsum, t):
            l, g = jax.value_and_grad(loss_fn)(p, t)
            return jax.tree.map(lambda a, b: a + b.astype(jnp.float32),
                                gsum, g), l
        zeros = jax.tree.map(lambda x: jnp.zeros(x.shape, jnp.float32), p)
        gsum, losses = jax.lax.scan(micro, zeros, mb)
        g = jax.tree.map(lambda x: x / n_micro, gsum)
        loss = jnp.mean(losses)
    return roptim.apply_updates(p, g, o, roptim.AdamWConfig()) + (loss,)


def _check_train(got, want, tol):
    params, opt, loss, metrics = got
    rp, ro, rm, rloss = want
    _close(loss, rloss, tol)
    _close(metrics["grad_norm"], rm["grad_norm"], tol)
    assert int(opt["step"]) == int(ro["step"]) == 1
    for a, b in zip(pytree.leaves(opt["m"]), jax.tree.leaves(ro["m"])):
        _close(a, b, GRAD_TOL)
    for a, b in zip(pytree.leaves(params), jax.tree.leaves(rp)):
        _close(a, b, tol)


@pytest.mark.parametrize("arch,variant", [
    ("gemma-7b", "base"), ("gemma-7b", "opt"), ("qwen2-moe-a2.7b", "base")])
def test_lm_train_step(arch, variant):
    rcfg = ref_registry.get(arch).SMOKE
    cfg = registry.get(arch).smoke
    fam = rmoe if registry.get(arch).family == "moe" else rtr
    cell = cells.build_cell(arch, "train_4k", ONE, variant=variant, cfg=cfg,
                            spec=SMALL_LM["train_4k"])
    rp = fam.init_params(jax.random.PRNGKey(0), rcfg)
    args = _port(cell, 3, rp, cfg)
    with ONE:
        got = cell.fn(*args)
    tok = jnp.asarray(_np(args[2]))
    dp = ("data",)
    rc = dataclasses.replace(rcfg, batch_axes=dp,
                             seq_axes=("model",) if variant == "base" else ())
    with jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                           ("data", "model")):
        want = _ref_train(lambda p, t: fam.lm_loss(p, t, rc), rp, tok,
                          n_micro=1 if variant == "base" else 4)
    _check_train(got, want, LM_TOL)


@pytest.mark.parametrize("arch", ["gemma-7b", "qwen2-moe-a2.7b"])
def test_lm_prefill_and_decode_steps(arch):
    rcfg = ref_registry.get(arch).SMOKE
    cfg = registry.get(arch).smoke
    fam = rmoe if registry.get(arch).family == "moe" else rtr
    rp = fam.init_params(jax.random.PRNGKey(1), rcfg)
    cell = cells.build_cell(arch, "prefill_32k", ONE, cfg=cfg,
                            spec=SMALL_LM["prefill_32k"])
    args = _port(cell, 4, rp, cfg)
    logits, cache = cell.fn(*args)
    rc = dataclasses.replace(rcfg, attn_chunk=2048, remat=True)
    rl, rcache = fam.forward_with_cache(rp, jnp.asarray(_np(args[1])), rc)
    _close(logits, rl, LM_TOL)
    _close(cache["k"], rcache["k"], LM_TOL)
    # decode: the opt variant's scatter update, which the reference MoE
    # shares with the port (ROADMAP §3: its default one-hot update adds)
    cell = cells.build_cell(arch, "decode_32k", ONE, variant="opt", cfg=cfg,
                            spec=SMALL_LM["decode_32k"])
    args = _port(cell, 5, rp, cfg)
    cache0 = _np(args[1])
    logits, cache = cell.fn(*args)
    rc = dataclasses.replace(rcfg, attn_bf16_operands=True,
                             scatter_cache_update=True)
    rl, rcache = fam.decode_step(
        rp, jax.tree.map(jnp.asarray, cache0), jnp.asarray(_np(args[2])),
        jnp.asarray(_np(args[3])), rc)
    _close(logits, rl, LM_TOL)
    _close(cache["v"], rcache["v"], LM_TOL)


def _gnn_cfgs(arch, spec):
    cfg, rcfg = registry.get(arch).smoke, ref_registry.get(arch).SMOKE
    kw = dict(d_in=spec["d_feat"], d_out=max(spec["n_classes"], 2))
    return dataclasses.replace(cfg, **kw), dataclasses.replace(rcfg, **kw)


@pytest.mark.parametrize("arch,shape", [("gcn-cora", "full_graph_sm"),
                                        ("graphsage-reddit", "minibatch_lg")])
def test_gnn_train_step(arch, shape):
    spec = SMALL_GNN[shape]
    cfg, rcfg = _gnn_cfgs(arch, spec)
    cell = cells.build_cell(arch, shape, ONE, cfg=registry.get(arch).smoke,
                            spec=spec)
    rp = rgnn.init_params(jax.random.PRNGKey(2), rcfg)
    args = _port(cell, 6, rp, cfg)
    batch = [jnp.asarray(_np(t)) for t in args[2:]]
    with ONE:
        got = cell.fn(*args)
    want = _ref_train(lambda p, *b: rgnn.nll_loss(p, *b, rcfg), rp, *batch)
    _check_train(got, want, GNN_TOL)


def test_graphcast_train_step():
    spec = SMALL_GNN["full_graph_sm"]
    cfg = registry.get("graphcast").smoke
    rcfg = ref_registry.get("graphcast").SMOKE
    cell = cells.build_cell("graphcast", "full_graph_sm", ONE, cfg=cfg,
                            spec=spec)
    rp = rgc.init_params(jax.random.PRNGKey(3), rcfg)
    args = _port(cell, 7, rp, cfg)
    gx, g2m, me, m2g, target = [jnp.asarray(_np(t)) for t in args[2:]]
    n_mesh = cell.static["n_mesh"]
    got = cell.fn(*args)
    want = _ref_train(lambda p: rgc.mse_loss(p, gx, target, g2m, me, m2g,
                                             n_mesh, rcfg), rp)
    _check_train(got, want, GNN_TOL)


def test_nequip_train_step():
    spec = SMALL_GNN["molecule"]
    cfg = registry.get("nequip").smoke
    rcfg = ref_registry.get("nequip").SMOKE
    cell = cells.build_cell("nequip", "molecule", ONE, cfg=cfg, spec=spec)
    rp = req.init_params(jax.random.PRNGKey(4), rcfg)
    args = _port(cell, 8, rp, cfg)
    batch = [jnp.asarray(_np(t)) for t in args[2:]]
    got = cell.fn(*args)
    want = _ref_train(lambda p, *b: req.batched_energy_loss(p, *b, rcfg),
                      rp, *batch)
    _check_train(got, want, GNN_TOL)


def test_sasrec_train_step():
    cfg = registry.get("sasrec").smoke
    rcfg = ref_registry.get("sasrec").SMOKE
    cell = cells.build_cell("sasrec", "train_batch", ONE, cfg=cfg,
                            spec=dict(kind="train", batch=8))
    rp = rsas.init_params(jax.random.PRNGKey(5), rcfg)
    args = _port(cell, 9, rp, cfg)
    batch = [jnp.asarray(_np(t)) for t in args[2:]]
    got = cell.fn(*args)
    want = _ref_train(lambda p, *b: rsas.bpr_loss(p, *b, rcfg), rp, *batch)
    _check_train(got, want, LM_TOL)


@pytest.mark.parametrize("shape,spec,variant", [
    ("serve_p99", dict(kind="serve", batch=4), "base"),
    ("serve_p99", dict(kind="serve", batch=4), "opt"),
    ("serve_bulk", dict(kind="bulk", batch=1024), "base"),
    ("retrieval_cand", dict(kind="retrieval", batch=1,
                            n_candidates=1000), "base"),
    ("retrieval_cand", dict(kind="retrieval", batch=1,
                            n_candidates=1000), "opt"),
])
def test_sasrec_serving_steps(shape, spec, variant):
    """Top-100 ids equal and scores within 1e-5: `blocked_topk` over the
    catalog (in 512-user chunks for bulk), `streak_topk` over the
    norm-sorted catalog (blocks read equal), sharded or not."""
    cfg = registry.get("sasrec").smoke
    rcfg = ref_registry.get("sasrec").SMOKE
    cell = cells.build_cell("sasrec", shape, ONE, variant=variant, cfg=cfg,
                            spec=spec)
    rp = rsas.init_params(jax.random.PRNGKey(6), rcfg)
    args = _port(cell, 10, rp, cfg)
    got = cell.fn(*args)
    seq = jnp.asarray(_np(args[1]))
    state = rsas.user_state(rp, seq, rcfg)
    if shape == "retrieval_cand":
        want = rret.streak_topk(state, *(jnp.asarray(_np(t))
                                         for t in args[2:]),
                                k=100, block=65536)
        assert int(got[2]) == int(want[2])
    else:
        chunks = [state] if spec["kind"] == "serve" else \
            list(state.reshape(-1, 512, state.shape[-1]))
        outs = [rret.blocked_topk(s, rp["item_embed"], k=100, block=131072)
                for s in chunks]
        want = (jnp.concatenate([o[0] for o in outs]),
                jnp.concatenate([o[1] for o in outs]))
    ids, want_ids = _np(got[1]).reshape(-1, 100), \
        np.asarray(want[1]).reshape(-1, 100)
    ws = np.asarray(want[0]).reshape(-1, 100)
    _close(got[0].reshape(-1, 100), ws, RET_TOL)
    # ids equal, but where two scores tie within the tolerance (the two
    # states differ in their last bits, so a near tie may order either way)
    gap = np.minimum(np.abs(np.diff(ws, axis=1, prepend=np.inf)),
                     np.abs(np.diff(ws, axis=1, append=-np.inf)))
    differ = ids != want_ids
    assert np.all(gap[differ] <= RET_TOL["atol"] + RET_TOL["rtol"]
                  * np.abs(ws[differ])), (ids[differ], want_ids[differ])
