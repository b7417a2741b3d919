"""The port stands alone and runs where it is told to.

`repro_torch` and `chip_smoke.py` import neither JAX nor the reference
package; the engine runs on CUDA unless the caller asks for the CPU and
raises when CUDA is missing; backends the port does not have (the
reference's interpret and jitted-CPU routes) are refused by name.
"""
import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import BackendPolicy, ExecConfig, StreakEngine
from repro_torch.data import synth_rdf

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def test_importing_the_port_loads_neither_jax_nor_the_reference():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.interop, repro_torch.kernels.ops\n"
        "import repro_torch.kernels._build, repro_torch.data.synth_rdf\n"
        "import repro_torch.models.transformer, repro_torch.serve.engine\n"
        "import repro_torch.launch.serve, repro_torch.configs.registry\n"
        "import repro_torch.serve.spatial, repro_torch.core.baselines\n"
        "import repro_torch.core.rtree, repro_torch.data.ingest\n"
        "import repro_torch.launch.analytics, repro_torch.data.fuzz_queries\n"
        "import repro_torch.models.moe, repro_torch.data.tokens\n"
        "import repro_torch.dist.grad_compression, repro_torch.train.loop\n"
        "import repro_torch.train.checkpoint, repro_torch.launch.train\n"
        "import repro_torch.launch.train_lm, repro_torch.pytree\n"
        "import repro_torch.models.sasrec, repro_torch.serve.retrieval\n"
        "import repro_torch.data.recsys, repro_torch.launch.serve_topk\n"
        "import repro_torch.models.gnn, repro_torch.models.graphcast\n"
        "import repro_torch.models.equivariant, repro_torch.data.graphs\n"
        "import repro_torch.launch.mesh, repro_torch.dist.elastic\n"
        "import repro_torch.roofline.analysis, repro_torch.roofline.op_count\n"
        "import repro_torch.launch.cells, repro_torch.launch.dryrun\n"
        "import repro_torch.dist.partitioning\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin"})


def test_the_dry_run_starts_no_process_group_at_import():
    """`launch.dryrun` sets its fake process group up inside a count and
    tears it down after; importing it (or the cells) starts none."""
    code = (
        "import torch.distributed as dist\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.cells\n"
        "assert not dist.is_initialized()\n"
        "from repro_torch.launch import dryrun\n"
        "rec = dryrun.run_cell('gcn-cora', 'molecule', False, verbose=False,"
        " art=None)\n"
        "assert rec['n_devices'] == 256 and not dist.is_initialized()\n")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin"})


def test_no_port_source_names_jax_or_the_reference():
    files = [p for p in PORT.rglob("*")
             if p.suffix in (".py", ".cu", ".cuh")] + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        text = path.read_text()
        assert "import jax" not in text, path
        assert "repro." not in text, path


@pytest.fixture(scope="module")
def tiny():
    return synth_rdf.make_lgd(n_per_class=40, seed=0)


def test_engine_defaults_to_cuda_and_raises_without_it(tiny, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        StreakEngine(tiny.store)
    with pytest.raises(RuntimeError, match="CUDA"):
        StreakEngine(tiny.store, device="cuda")
    eng = StreakEngine(tiny.store, device="cpu")
    assert eng.device == torch.device("cpu")
    scores, rows, stats = eng.execute(tiny.queries[0])
    assert len(scores) and np.isfinite(scores).all()


def test_serve_loop_defaults_to_cuda_and_raises_without_it(tiny,
                                                         monkeypatch):
    from repro_torch.serve.spatial import SpatialServeEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SpatialServeEngine(tiny.store)
    with pytest.raises(RuntimeError, match="CUDA"):
        SpatialServeEngine(tiny.store, ExecConfig(), device="cuda")
    srv = SpatialServeEngine(tiny.store, device="cpu")
    assert srv.engine.device == torch.device("cpu")
    (req,) = srv.serve([tiny.queries[0]])
    assert req.done and req.error is None
    assert len(req.scores) and np.isfinite(req.scores).all()


def test_baseline_engines_default_to_cuda_and_raise_without_it(tiny,
                                                              monkeypatch):
    from repro_torch.core.baselines import (FullScanEngine, SyncRTreeEngine,
                                            fixed_plan_engine)
    makers = {"FullScanEngine": FullScanEngine,
              "SyncRTreeEngine": SyncRTreeEngine,
              "fixed_plan_engine": lambda store, **kw: fixed_plan_engine(
                  store, "S", **kw)}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    want = StreakEngine(tiny.store, device="cpu").execute(tiny.queries[0])[0]
    for who, make in makers.items():
        for kw in ({}, dict(device="cuda")):
            with pytest.raises(RuntimeError, match=f"{who} runs on CUDA"):
                make(tiny.store, **kw)
        eng = make(tiny.store, device="cpu")
        assert eng.device == torch.device("cpu")
        scores, rows, stats = eng.execute(tiny.queries[0])
        np.testing.assert_array_equal(np.sort(scores), np.sort(want))


def test_analytics_launcher_refuses_to_start_without_cuda():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.analytics", "--n", "40"],
        capture_output=True, text=True,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin",
             "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and "CUDA" in out.stderr
    assert "streak" not in out.stdout


def test_analytics_launcher_runs_on_the_cpu_when_asked(capsys):
    from repro_torch.launch import analytics
    r = analytics.main(["--n", "40", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "on cpu" in out and out.count("ms ") >= 8
    assert len(r["queries"]) == 8 and all(q["same"] for q in r["queries"])


def test_lm_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from repro_torch.configs import registry
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    from repro_torch.serve.engine import ServeEngine
    cfg = registry.get("codeqwen1.5-7b").smoke
    params = transformer.init_params(cfg, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: transformer.init_params(cfg),
                 lambda: transformer.init_cache(cfg, 2, 8),
                 lambda: ServeEngine(transformer, params, cfg),
                 lambda: ServeEngine(transformer, params, cfg,
                                     device="cuda"),
                 lambda: serve.serve_lm(cfg, 1)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    eng = ServeEngine(transformer, params, cfg, max_batch=2, max_seq=8,
                      device="cpu")
    assert eng.device == torch.device("cpu")
    assert eng.cache["k"].device == torch.device("cpu")


def test_serve_launcher_refuses_to_start_without_cuda():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "gemma-7b", "--smoke"], capture_output=True, text=True,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin",
             "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and "CUDA" in out.stderr
    assert "served" not in out.stdout


@pytest.mark.parametrize("stage", ["probe", "rank"])
def test_unported_kernel_backends_raise(stage):
    """The reference's interpret-mode and jitted-CPU routes are not ported
    and raise; the kernel backend resolves as itself."""
    pol = ExecConfig(policy=BackendPolicy(**{stage: "kernel"})).policy
    assert getattr(pol, stage) == "kernel"
    for unported in ("interpret", "cpu"):
        with pytest.raises(ValueError, match="unknown"):
            ExecConfig(policy=BackendPolicy(**{stage: unported}))


def test_auto_policy_resolves_like_the_reference(monkeypatch):
    """"auto" takes the kernels where the accelerator is, numpy elsewhere,
    for the descent, the Bloom probes and the rank pass alike."""
    for cuda, kern in ((True, "kernel"), (False, "numpy")):
        monkeypatch.setattr(torch.cuda, "is_available", lambda c=cuda: c)
        pol = BackendPolicy().resolve()
        assert (pol.join, pol.impl, pol.rank, pol.probe, pol.descend) == \
            ("numpy", "merge", kern, kern, kern)


def test_non_topk_shapes_are_not_ported(tiny):
    """Non-top-k shapes do not take the streaming top-k cursor: they run
    through a `ShapeCursor`, whole, under the shape plan ("S")."""
    q = tiny.queries[0]
    join_q = type(q)(select=q.select, patterns=q.patterns, spatial=q.spatial,
                     ranking=None, k=q.k)
    eng = StreakEngine(tiny.store, device="cpu")
    cur = eng.cursor(join_q)
    assert type(cur).__name__ == "ShapeCursor"
    scores, rows, stats = eng.execute(join_q)
    assert stats.plan_log and set(stats.plan_log) == {"S"}
    assert all(len(v) == len(scores) for v in rows.values())
    assert np.isfinite(scores).all() and (scores >= 0).all()


def test_shape_cursor_serve_half_runs_whole_shape(tiny):
    """A `ShapeCursor`'s serving half (`begin_block`) runs the whole shape
    at once and returns None, so the serve loop retires the slot with the
    results at its first step; they equal `execute`'s."""
    q = tiny.queries[0]
    join_q = type(q)(select=q.select, patterns=q.patterns, spatial=q.spatial,
                     ranking=None, k=q.k)
    eng = StreakEngine(tiny.store, device="cpu")
    cur = eng.cursor(join_q)
    assert cur.begin_block() is None and cur.done
    with pytest.raises(RuntimeError):
        cur.finish_block(None)
    scores, rows, _ = eng.execute(join_q)
    got_scores, got_rows, _ = cur.results()
    np.testing.assert_array_equal(got_scores, scores)
    assert got_rows.keys() == rows.keys()
    for name in rows:
        np.testing.assert_array_equal(got_rows[name], rows[name])


def test_public_surface_is_a_subset_of_the_reference():
    import repro
    # the whole surface since the sharded store and the fault plans
    assert set(repro_torch.__all__) == set(repro.__all__)
    for name in repro_torch.__all__:
        assert getattr(repro_torch, name).__name__ == \
            getattr(repro, name).__name__


def test_training_entry_points_default_to_cuda_and_raise_without_it(
        monkeypatch, tmp_path):
    from repro_torch.configs import registry
    from repro_torch.launch import train, train_lm
    from repro_torch.models import moe
    cfg = registry.get("qwen2-moe-a2.7b").smoke
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: moe.init_params(cfg),
                 lambda: moe.init_cache(cfg, 2, 8),
                 lambda: train.main(["--arch", "qwen2-moe-a2.7b", "--smoke",
                                     "--ckpt-dir", str(tmp_path / "a")]),
                 lambda: train_lm.main(["--ckpt-dir", str(tmp_path / "b")])):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    assert moe.init_cache(cfg, 2, 8, device="cpu")["k"].device == \
        torch.device("cpu")
    assert not (tmp_path / "a_qwen2-moe-a2.7b").exists()


def test_train_launcher_refuses_to_start_without_cuda(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "gemma-7b", "--smoke", "--ckpt-dir", str(tmp_path / "ck")],
        capture_output=True, text=True,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin",
             "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and "CUDA" in out.stderr
    assert "loss" not in out.stdout


# ------------------------------------------------------------------------
# public members of ported modules, each against the reference's
def _member_policy():
    import repro.core.policy as ref
    import repro_torch.core.policy as port
    for kw in ({}, dict(join="fused", impl="merge", rank="numpy",
                        probe="numpy", descend="numpy"),
               dict(join="fused"), dict(descend="auto", join="kernel",
                                        impl="merge", rank="kernel",
                                        probe="kernel")):
        assert port.BackendPolicy(**kw).resolved == \
            ref.BackendPolicy(**kw).resolved
    assert not port.BackendPolicy().resolved
    assert port.BackendPolicy().resolve().resolved


def _member_topk():
    import repro.core.join as ref_join
    import repro.core.topk as ref
    import repro_torch.core.join as port_join
    import repro_torch.core.topk as port
    rng = np.random.default_rng(0)
    for descending in (True, False):
        a = port.TopK(k=5, descending=descending)
        b = ref.TopK(k=5, descending=descending)
        for n in (3, 4, 6):
            s = rng.normal(size=n)
            ids = np.arange(n)
            a.push(s, port_join.Relation({"x": ids}))
            b.push(s, ref_join.Relation({"x": ids}))
            for bound in (-3.0, -0.5, 0.0, 0.5, 3.0, float(a.theta),
                          -float(a.theta)):
                assert a.can_improve(bound) == b.can_improve(bound)


def _member_query():
    import repro.core.query as ref
    import repro_torch.core.query as port
    for m in (port, ref):
        x, y, z = m.Var("x"), m.Var("y"), m.Var("z")
        pats = (m.TriplePattern(x, 3, y), m.TriplePattern(y, 4, 7, g=z),
                m.TriplePattern(z, x, y), m.TriplePattern(1, 2, 3, g=4))
        q = m.Query(select=(x,), patterns=pats, spatial=None, ranking=None)
        yield [tp.n_bound() for tp in pats], [v.name for v in q.all_vars()]


def _member_ids():
    import repro.core.ids as ref
    import repro_torch.core.ids as port
    rng = np.random.default_rng(1)
    level = rng.integers(0, 11, 50)
    zpath = rng.integers(0, 1 << 20, 50) >> (2 * (10 - level))
    local = rng.integers(0, 1 << 30, 50)
    ids = np.concatenate([port.encode(zpath, level, local),
                          port.nonspatial_ids(20, start=5)])
    np.testing.assert_array_equal(port.is_spatial(ids), ref.is_spatial(ids))
    assert port.is_spatial(ids).sum() == 50
    np.testing.assert_array_equal(port.nonspatial_ids(7),
                                  ref.nonspatial_ids(7))
    np.testing.assert_array_equal(port.nonspatial_ids(3, start=9),
                                  ref.nonspatial_ids(3, start=9))
    sid = port.SpatialId(True, 5, 2, 9)
    assert dataclasses.asdict(sid) == dataclasses.asdict(
        ref.SpatialId(True, 5, 2, 9))
    with pytest.raises(dataclasses.FrozenInstanceError):
        sid.level = 3
    assert port.MAX_LOCAL == ref.MAX_LOCAL


def _member_charsets():
    import repro.core.charsets as ref
    import repro_torch.core.charsets as port
    rng = np.random.default_rng(2)
    x = rng.integers(-(1 << 62), 1 << 62, 200)
    for seed in (0, 1, 17):
        np.testing.assert_array_equal(port.hash_u64(x, seed),
                                      ref.hash_u64(x, seed))
    sets = [rng.integers(0, 50, rng.integers(0, 8)) for _ in range(40)]
    sets.append(np.array([3, 3, 1]))
    np.testing.assert_array_equal(port.cs_id_of_predicate_sets(sets),
                                  ref.cs_id_of_predicate_sets(sets))


def _member_morton():
    import repro.core.morton as ref
    import repro_torch.core.morton as port
    z = np.random.default_rng(3).integers(0, 1 << 20, 100)
    for to in (0, 3, 10):
        np.testing.assert_array_equal(port.zpath_at(z, 10, to),
                                      ref.zpath_at(z, 10, to))


MEMBERS = {"BackendPolicy.resolved": _member_policy,
           "TopK.can_improve": _member_topk,
           "TriplePattern.n_bound+Query.all_vars": _member_query,
           "ids.SpatialId+is_spatial+nonspatial_ids": _member_ids,
           "charsets.hash_u64+cs_id_of_predicate_sets": _member_charsets,
           "morton.zpath_at": _member_morton}


@pytest.mark.parametrize("member", sorted(MEMBERS))
def test_public_member_matches_the_reference(member):
    out = MEMBERS[member]()
    if out is not None:              # (port, reference) results to compare
        port, ref = list(out)
        assert port == ref
