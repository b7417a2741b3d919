"""Port vs reference: LM training on the CPU.

`lm_loss` and its gradients (dense smokes, chunked and recomputed), the
AdamW pieces, int8 error-feedback compression, the token stream, the
trainer with checkpoints, restarts and the straggler guard, checkpoints
crossing between the packages, and the training launchers. Each runs the
reference and the port on the same inputs: weights carried over by
`interop`, batches from the same `TokenStream` seeds.

Tolerances: losses 1e-4 absolute and relative, gradients 1e-4 relative and
1e-5 absolute (the reference's own micro-batch test), as for the models
(tests/test_torch_transformer.py: f32 products summed in other orders).
Optimizer arithmetic on equal inputs: 1e-6 relative (element-wise f32 in
the same order; XLA may contract a product into a fused multiply-add).
Int8 codes and token batches: equal. Loss histories of two trainers:
1e-4, since each step feeds the next.
"""
import dataclasses
import pathlib
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.data import tokens as rtokens
from repro.dist import grad_compression as rgc
from repro.models import moe as rmoe
from repro.models import transformer as rtr
from repro.train import checkpoint as rckpt
from repro.train import fault as rfault
from repro.train import loop as rloop
from repro.train import optim as roptim
from repro_torch import pytree
from repro_torch.configs import registry
from repro_torch.data import tokens
from repro_torch.dist import grad_compression
from repro_torch.interop import params_from_state
from repro_torch.launch import train as launch_train
from repro_torch.launch import train_lm
from repro_torch.models import transformer as ttr
from repro_torch.train import checkpoint, fault, loop, optim

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
OPT_TOL = dict(rtol=1e-6, atol=1e-7)
DENSE = ["gemma-7b", "codeqwen1.5-7b", "nemotron-4-15b"]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(want, dtype=np.float32), **tol)


def _carry(ref_params, cfg):
    return params_from_state(jax.tree.map(np.asarray, ref_params), cfg,
                             "cpu")


def _grads(loss_fn, params, *args):
    leaves = [x.detach().clone().requires_grad_(True)
              for x in pytree.leaves(params)]
    loss = loss_fn(pytree.unflatten(params, leaves), *args)
    return loss.detach(), torch.autograd.grad(loss, leaves)


# ------------------------------------------------------------- lm_loss ---
@pytest.fixture(scope="module", params=DENSE)
def dense(request):
    """The reference's loss and gradients on a dense smoke, 2 x 33 tokens
    (S = 32: its default 8 loss chunks divide it)."""
    ref_cfg = ref_registry.get(request.param).SMOKE
    ref_params = rtr.init_params(jax.random.PRNGKey(0), ref_cfg)
    tok = np.random.default_rng(1).integers(0, ref_cfg.vocab, (2, 33),
                                            dtype=np.int32)
    loss, g = jax.value_and_grad(rtr.lm_loss)(ref_params, jnp.asarray(tok),
                                              ref_cfg)
    return request.param, ref_params, tok, loss, jax.tree_util.tree_leaves(g)


@pytest.mark.parametrize("variant", [dict(), dict(loss_chunks=1),
                                     dict(loss_chunks=4, remat=True)])
def test_dense_lm_loss_and_grads_match(dense, variant):
    """Chunking the vocab projection and recomputing layers change neither
    the loss nor the gradients."""
    arch, ref_params, tok, want, want_g = dense
    cfg = dataclasses.replace(registry.get(arch).smoke, **variant)
    params = _carry(ref_params, cfg)
    loss, grads = _grads(lambda p, t: ttr.lm_loss(p, t, cfg), params,
                         torch.from_numpy(tok))
    _close(loss, want)
    assert len(grads) == len(want_g)
    for g, w in zip(grads, want_g):
        _close(g, w, GRAD_TOL)
    with torch.no_grad():
        _close(ttr.lm_loss(params, torch.from_numpy(tok), cfg), want)


def test_microbatch_accumulation_matches_full_batch_grads():
    """tests/test_variants.py's twin: four micro-batches' mean gradient
    equals the full batch's, and both equal the reference's."""
    ref_cfg = rtr.TransformerConfig(
        n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
        d_ff=64, vocab=64, dtype="float32", remat=False, loss_chunks=1)
    cfg = ttr.TransformerConfig(**dataclasses.asdict(ref_cfg))
    ref_params = rtr.init_params(jax.random.PRNGKey(0), ref_cfg)
    params = _carry(ref_params, cfg)
    tok = np.random.default_rng(2).integers(0, 64, (8, 16), dtype=np.int32)
    want = jax.grad(rtr.lm_loss)(ref_params, jnp.asarray(tok), ref_cfg)

    def loss_fn(p, t):
        return ttr.lm_loss(p, t, cfg)
    _, g_full = _grads(loss_fn, params, torch.from_numpy(tok))
    g_acc = [torch.zeros_like(g) for g in g_full]
    for mb in torch.from_numpy(tok).reshape(4, 2, 16):
        for acc, g in zip(g_acc, _grads(loss_fn, params, mb)[1]):
            acc += g
    for a, b, w in zip(g_full, g_acc, jax.tree_util.tree_leaves(want)):
        _close(b / 4, a, GRAD_TOL)
        _close(a, w, GRAD_TOL)


# ----------------------------------------------------------- optimizer ---
def test_schedule_matches_reference():
    cfg = optim.AdamWConfig(lr=1e-2, warmup_steps=5, total_steps=40)
    ref_cfg = roptim.AdamWConfig(**dataclasses.asdict(cfg))
    for step in (0, 1, 3, 5, 6, 17, 39, 40, 41, 100):
        _close(optim.schedule(step, cfg),
               roptim.schedule(jnp.float32(step), ref_cfg), OPT_TOL)


def _tree(rng, dtype=np.float32):
    return {"a": rng.normal(size=(7, 5)).astype(dtype),
            "b": {"c": rng.normal(size=(11,)).astype(dtype),
                  "d": rng.normal(size=(3, 2, 4)).astype(dtype)}}


def _torch_tree(tree):
    return pytree.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def test_global_norm_and_one_update_match_reference():
    rng = np.random.default_rng(0)
    params, grads = _tree(rng), _tree(rng)
    grads = jax.tree.map(lambda g: g * 3, grads)     # clipped: norm > 1
    cfg = optim.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    ref_cfg = roptim.AdamWConfig(**dataclasses.asdict(cfg))
    _close(optim.global_norm(_torch_tree(grads)),
           roptim.global_norm(jax.tree.map(jnp.asarray, grads)), OPT_TOL)
    ref_p = jax.tree.map(jnp.asarray, params)
    ref_s = roptim.init_state(ref_p)
    p = _torch_tree(params)
    s = optim.init_state(p)
    for _ in range(3):                 # three steps: moments carried
        ref_p, ref_s, ref_m = roptim.apply_updates(
            ref_p, jax.tree.map(jnp.asarray, grads), ref_s, ref_cfg)
        p, s, m = optim.apply_updates(p, _torch_tree(grads), s, cfg)
        _close(m["grad_norm"], ref_m["grad_norm"], OPT_TOL)
        _close(m["lr"], ref_m["lr"], OPT_TOL)
    assert int(s["step"]) == int(ref_s["step"]) == 3
    for name in ("m", "v"):
        for a, b in zip(pytree.leaves(s[name]),
                        jax.tree_util.tree_leaves(ref_s[name])):
            assert a.dtype == torch.float32
            _close(a, b, OPT_TOL)
    for a, b in zip(pytree.leaves(p), jax.tree_util.tree_leaves(ref_p)):
        _close(a, b, OPT_TOL)


def test_bf16_parameters_stay_bf16_without_a_master_copy():
    """bf16 weights are updated in f32 and rounded back to bf16, as the
    reference does: the same update to within one bf16 rounding."""
    rng = np.random.default_rng(1)
    params32, grads = _tree(rng), _tree(rng)
    cfg = optim.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    ref_p = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params32)
    ref_p, _, _ = roptim.apply_updates(
        ref_p, jax.tree.map(jnp.asarray, grads), roptim.init_state(ref_p),
        roptim.AdamWConfig(**dataclasses.asdict(cfg)))
    p = pytree.tree_map(lambda a: torch.from_numpy(a).bfloat16(), params32)
    s = optim.init_state(p)
    optim.apply_updates(p, _torch_tree(grads), s, cfg)
    for a, b in zip(pytree.leaves(p), jax.tree_util.tree_leaves(ref_p)):
        assert a.dtype == torch.bfloat16
        _close(a.float(), np.asarray(b, np.float32),
               dict(rtol=2 ** -8, atol=1e-6))
    assert all(m.dtype == torch.float32 for m in pytree.leaves(s["m"]))


# --------------------------------------------------------- compression ---
def test_int8_codes_equal_the_reference_ties_included():
    """Half-way values round to even in both (2.5 -> 2, -1.5 -> -2)."""
    rng = np.random.default_rng(0)
    ties = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 126.5, 127.0],
                    np.float32)
    for g in (ties, rng.normal(size=(1000,)).astype(np.float32),
              np.zeros(5, np.float32)):
        codes, scale = grad_compression.compress(torch.from_numpy(g))
        ref_codes, ref_scale = rgc.compress(jnp.asarray(g))
        assert codes.dtype == torch.int8
        np.testing.assert_array_equal(codes.numpy(), np.asarray(ref_codes))
        assert float(scale) == float(ref_scale)
    np.testing.assert_array_equal(
        grad_compression.compress(torch.from_numpy(ties))[0].numpy(),
        [-2, -2, 0, 0, 2, 2, 126, 127])


def test_ef_compression_bias_vanishes_over_steps():
    """tests/test_substrate.py's twin, and the same codes as the
    reference's at every one of the 50 steps."""
    rng = np.random.default_rng(0)
    g_np = rng.normal(size=(256,)).astype(np.float32)
    g = torch.from_numpy(g_np)
    err = torch.zeros_like(g)
    ref_err = jnp.zeros(256, jnp.float32)
    acc_true = np.zeros(256)
    acc_comp = np.zeros(256)
    for _ in range(50):
        codes, scale, err = grad_compression.ef_compress(g, err)
        ref_codes, _, ref_err = rgc.ef_compress(jnp.asarray(g_np), ref_err)
        np.testing.assert_array_equal(codes.numpy(), np.asarray(ref_codes))
        acc_true += g_np
        acc_comp += grad_compression.decompress(codes, scale).numpy()
    rel = np.abs(acc_comp - acc_true).max() / np.abs(acc_true).max()
    assert rel < 0.02


def test_compression_is_4x_smaller():
    g = torch.ones(1024, dtype=torch.float32)
    codes, scale = grad_compression.compress(g)
    assert codes.dtype == torch.int8
    assert codes.numel() * codes.element_size() * 4 == \
        g.numel() * g.element_size()


def test_tree_roundtrip_matches_reference():
    rng = np.random.default_rng(3)
    grads = _tree(rng)
    got_g, got_e = grad_compression.tree_ef_compress_roundtrip(
        _torch_tree(grads), grad_compression.init_error_state(
            _torch_tree(grads)))
    ref = jax.tree.map(jnp.asarray, grads)
    want_g, want_e = rgc.tree_ef_compress_roundtrip(
        ref, rgc.init_error_state(ref))
    for a, b in zip(pytree.leaves(got_g), jax.tree_util.tree_leaves(want_g)):
        _close(a, b, OPT_TOL)
    # XLA contracts the residual `target - codes * scale` into one fused
    # multiply-add, the port rounds the product first: residuals differ by
    # up to a rounding of the product, an ulp of |g| <= 4 (4.8e-7)
    for a, b in zip(pytree.leaves(got_e), jax.tree_util.tree_leaves(want_e)):
        _close(a, b, dict(rtol=1e-5, atol=5e-7))


# -------------------------------------------------------- token stream ---
@pytest.mark.parametrize("shard", [(0, 1), (0, 2), (1, 2)])
def test_token_stream_batches_are_the_references(shard):
    index, count = shard
    a = tokens.TokenStream(100, 8, 4, seed=3, process_index=index,
                           process_count=count)
    b = rtokens.TokenStream(100, 8, 4, seed=3, process_index=index,
                            process_count=count)
    for step in (0, 1, 7):
        x = a.batch(step)
        assert x.dtype == np.int32 and x.shape == (4 // count, 9)
        np.testing.assert_array_equal(x, b.batch(step))
        np.testing.assert_array_equal(x, a.batch(step))   # deterministic


def test_token_stream_shards_differ():
    a = tokens.TokenStream(100, 8, 4, seed=3, process_index=0,
                           process_count=2)
    b = tokens.TokenStream(100, 8, 4, seed=3, process_index=1,
                           process_count=2)
    assert not np.array_equal(a.batch(0), b.batch(0))


# ------------------------------------------------------------- trainer ---
def _tiny_cfgs():
    ref_cfg = rtr.TransformerConfig(
        n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
        d_ff=64, vocab=64, dtype="float32", remat=False, loss_chunks=1)
    return ref_cfg, ttr.TransformerConfig(**dataclasses.asdict(ref_cfg))


def _trainers(tmp_path, seed, ref_cfg=None, cfg=None, ocfg=None, **tcfg):
    """A reference and a port trainer from the same weights, and their
    batch functions over one TokenStream."""
    if ref_cfg is None:
        ref_cfg, cfg = _tiny_cfgs()
    rmod = rmoe if isinstance(ref_cfg, rmoe.MoEConfig) else rtr
    tmod = registry.model_module(cfg)
    ref_params = rmod.init_params(jax.random.PRNGKey(0), ref_cfg)
    params = _carry(ref_params, cfg)
    stream = tokens.TokenStream(cfg.vocab, 16, 8, seed=seed)
    ocfg = ocfg or dict(lr=1e-2, warmup_steps=2, total_steps=60,
                        weight_decay=0.0)
    ref_tr = rloop.Trainer(
        lambda p, b: rmod.lm_loss(p, b, ref_cfg), ref_params,
        rloop.TrainerConfig(ckpt_dir=str(tmp_path / "ref"), **tcfg),
        roptim.AdamWConfig(**ocfg))
    tr = loop.Trainer(
        lambda p, b: tmod.lm_loss(p, b, cfg), params,
        loop.TrainerConfig(ckpt_dir=str(tmp_path / "port"), **tcfg),
        optim.AdamWConfig(**ocfg))
    return (ref_tr, lambda s: (jnp.asarray(stream.batch(s)),),
            tr, lambda s: (torch.from_numpy(stream.batch(s)),))


def test_trainer_loss_decreases_and_resumes(tmp_path):
    """tests/test_substrate.py's twin, with the reference's trainer beside
    it: the same loss history within 1e-4, and a new trainer resumes at
    step 30 from the port's checkpoint."""
    ref_tr, ref_b, tr, b = _trainers(tmp_path, seed=1, ckpt_every=5,
                                     log_every=100)
    want = ref_tr.fit(ref_b, n_steps=30)
    hist = tr.fit(b, n_steps=30)
    assert np.mean(hist[:5]) > np.mean(hist[-5:])       # it learns
    _close(hist, want)
    tr2 = loop.Trainer(tr.loss_fn, ttr.init_params(_tiny_cfgs()[1],
                                                   device="cpu"),
                       tr.cfg, tr.opt_cfg)
    assert tr2.maybe_restore()
    assert tr2.step == 30
    for a, c in zip(pytree.leaves(tr2.params), pytree.leaves(tr.params)):
        assert torch.equal(a, c)


def test_first_step_loss_is_lm_loss_outside_the_trainer(tmp_path):
    _, _, tr, b = _trainers(tmp_path, seed=4)
    cfg = _tiny_cfgs()[1]
    with torch.no_grad():
        want = ttr.lm_loss(tr.params, b(0)[0], cfg)
    assert torch.equal(tr.train_step(b(0)), want)
    assert float(tr.metrics["grad_norm"]) > 0


def test_trainer_recovers_from_injected_failure(tmp_path):
    """tests/test_substrate.py's twin: a failure at step 12 restores the
    step-10 checkpoint and the run still ends at step 20, with the same
    history (steps 10-11 twice) as the reference's."""
    ref_tr, ref_b, tr, b = _trainers(
        tmp_path, seed=2, ocfg={}, ckpt_every=5, log_every=1000,
        max_restarts=2)
    want = ref_tr.fit(ref_b, n_steps=20,
                      injector=rfault.FailureInjector(fail_at_steps=(12,)))
    hist = tr.fit(b, n_steps=20,
                  injector=fault.FailureInjector(fail_at_steps=(12,)))
    assert tr.step == 20 and len(hist) == len(want) == 22
    _close(hist, want)


def test_step_guard_detects_straggler():
    with pytest.raises(fault.StragglerTimeout):
        with fault.StepGuard(0.05):
            time.sleep(0.2)
    with fault.StepGuard(5.0) as guard:
        pass
    assert not guard.fired


def test_failures_beyond_max_restarts_propagate(tmp_path):
    _, _, tr, b = _trainers(tmp_path, seed=2, max_restarts=1,
                            log_every=1000)
    with pytest.raises(fault.InjectedFailure):
        tr.fit(b, n_steps=6,
               injector=fault.FailureInjector(fail_at_steps=(1, 3)))


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "qwen3-moe-30b-a3b"])
def test_moe_trainer_matches_reference(tmp_path, arch):
    ref_tr, ref_b, tr, b = _trainers(
        tmp_path, seed=5, ref_cfg=ref_registry.get(arch).SMOKE,
        cfg=registry.get(arch).smoke, log_every=1000, ckpt_every=100)
    _close(tr.fit(b, n_steps=4), ref_tr.fit(ref_b, n_steps=4))


@pytest.mark.parametrize("compress", [False, True])
def test_compressed_trainer_matches_reference(tmp_path, compress):
    ref_tr, ref_b, tr, b = _trainers(tmp_path, seed=6, log_every=1000,
                                     ckpt_every=100, compress_grads=compress)
    _close(tr.fit(b, n_steps=6), ref_tr.fit(ref_b, n_steps=6))


# ---------------------------------------------------------- checkpoint ---
def test_checkpoint_roundtrip_and_retention(tmp_path):
    ck = checkpoint.Checkpointer(tmp_path, keep=2)
    tree = {"a": torch.arange(10.0), "b": {"c": torch.ones(3, 4)},
            "h": torch.arange(4.0).bfloat16(), "step": 7}
    for s in (1, 2, 3):
        ck.save(s, tree, blocking=s != 2)
    ck.wait()
    assert ck.latest_step() == 3
    restored, step = ck.restore(tree)
    assert step == 3 and int(restored["step"]) == 7
    assert torch.equal(restored["a"], torch.arange(10.0))
    assert restored["h"].dtype == torch.bfloat16
    assert torch.equal(restored["h"], tree["h"])
    dirs = [p.name for p in ck.dir.iterdir() if p.name.startswith("step_")]
    assert sorted(dirs) == ["step_000000002", "step_000000003"]


def test_checkpoint_atomic_latest(tmp_path):
    ck = checkpoint.Checkpointer(tmp_path, keep=3)
    ck.save(5, {"x": torch.zeros(3)}, blocking=True)
    (tmp_path / "step_000000006").mkdir()  # crash artifact without manifest
    (tmp_path / "LATEST").write_text("step_000000006")
    assert ck.latest_step() is None  # refuses corrupt pointer


def test_checkpoint_layout_is_the_references(tmp_path):
    """The same files, leaf numbering and manifest fields as the
    reference's Checkpointer for one f32 tree."""
    rng = np.random.default_rng(0)
    tree = _tree(rng)
    checkpoint.Checkpointer(tmp_path / "port").save(
        4, dict(_torch_tree(tree), step=4), blocking=True)
    rckpt.Checkpointer(tmp_path / "ref").save(
        4, dict(jax.tree.map(jnp.asarray, tree), step=4), blocking=True)
    for side in ("port", "ref"):
        assert (tmp_path / side / "LATEST").read_text() == "step_000000004"
    a = np.load(tmp_path / "port" / "step_000000004" / "arrays.npz")
    b = np.load(tmp_path / "ref" / "step_000000004" / "arrays.npz")
    assert sorted(a.files) == sorted(b.files)
    for name in a.files:
        np.testing.assert_array_equal(a[name], b[name])


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_checkpoints_cross_between_the_packages(tmp_path, writer):
    """Five steps in one package, saved; a trainer of the other package
    restores that checkpoint and goes on to step 10, with the losses the
    writer's own run has there."""
    ref_tr, ref_b, tr, b = _trainers(tmp_path, seed=7, log_every=1000,
                                     ckpt_every=5)
    first, first_b, other = ((ref_tr, ref_b, tr) if writer == "ref"
                             else (tr, b, ref_tr))
    first.fit(first_b, n_steps=5)
    want = first.fit(first_b, n_steps=10)[5:]
    # point the other trainer at the writer's step-5 checkpoint
    src = pathlib.Path(first.cfg.ckpt_dir)
    dst = pathlib.Path(other.cfg.ckpt_dir)
    dst.mkdir(parents=True, exist_ok=True)
    import shutil
    shutil.copytree(src / "step_000000005", dst / "step_000000005")
    (dst / "LATEST").write_text("step_000000005")
    assert other.maybe_restore() and other.step == 5
    got = other.fit(b if other is tr else ref_b, n_steps=10)
    _close(got, want)


# ----------------------------------------------------------- launchers ---
def test_train_launcher_runs_the_moe_smoke_on_the_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen2-moe-a2.7b", "--smoke", "--steps", "4", "--device", "cpu",
         "--ckpt-dir", str(tmp_path / "ck")],
        capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin"})
    assert out.returncode == 0, out.stderr
    assert "qwen2-moe-a2.7b: loss" in out.stdout and "(4 steps) on cpu" in \
        out.stdout


@pytest.mark.parametrize("arch", ["gcn-cora", "sasrec"])
def test_train_launcher_runs_the_gnn_and_recsys_smokes_on_the_cpu(
        arch, tmp_path, capsys):
    hist = launch_train.main(["--arch", arch, "--smoke", "--steps", "4",
                              "--batch", "4", "--device", "cpu",
                              "--ckpt-dir", str(tmp_path / "ck")])
    assert len(hist) == 4 and np.isfinite(hist).all()
    assert f"{arch}: loss" in capsys.readouterr().out
    assert (tmp_path / f"ck_{arch}" / "LATEST").exists()


@pytest.mark.parametrize("arch", ["graphcast", "nequip"])
def test_train_launcher_exits_for_graphcast_and_nequip_as_the_reference(
        arch, monkeypatch):
    from repro.launch import train as rlaunch
    monkeypatch.setattr(sys, "argv", ["train", "--arch", arch, "--smoke"])
    with pytest.raises(SystemExit):
        rlaunch.main()
    with pytest.raises(SystemExit, match=f"no {arch} branch"):
        launch_train.main(["--arch", arch, "--smoke", "--device", "cpu"])


def test_train_launchers_resume_from_their_checkpoint(tmp_path, capsys):
    args = ["--arch", "gemma-7b", "--smoke", "--steps", "2", "--batch", "2",
            "--seq", "16", "--device", "cpu", "--ckpt-dir",
            str(tmp_path / "ck")]
    assert len(launch_train.main(args)) == 2
    args[args.index("--steps") + 1] = "3"
    assert len(launch_train.main(args)) == 1
    assert "resumed at step 2" in capsys.readouterr().out
    hist = train_lm.main(["--preset", "tiny", "--steps", "3", "--device",
                          "cpu", "--ckpt-dir", str(tmp_path / "lm")])
    assert len(hist) == 3 and all(np.isfinite(hist))
