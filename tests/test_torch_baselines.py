"""Port vs reference: the paper's baseline engines.

The same stores go through the reference's `FullScanEngine`,
`SyncRTreeEngine` and fixed-plan engines and the port's on
``device="cpu"`` (the refinement kernel there runs its plain torch
version). Top-k scores are exact, rows equal as multisets, `BaselineStats`
equal; the four query shapes' pair-distance scores are within one ulp of
the f32 refinement core (the reference contracts it, ROADMAP.md §3) and
equal the unfused formula exactly. The `ExecConfig.mbr_join_fn` hook is
held to the reference's contract: it replaces the Phase-3 MBR join, skips
the fused streaming path and its serve batcher, and is never cached.
"""
import dataclasses

import numpy as np
import pytest

import repro
import repro_torch
from repro.core import baselines as ref_base
from repro.data import synth_rdf as ref_synth
from repro_torch.core import baselines as port_base
from repro_torch.core import spatial_join as port_sj
from repro_torch.data import synth_rdf as port_synth
from repro_torch.serve import spatial as port_serve
from test_torch_engine import _quickstart
from test_torch_shapes import _shape_query, _unfused_cores


@pytest.fixture(scope="module")
def sets():
    """{name: (reference dataset, port dataset)}, built alike."""
    lgd = dict(n_per_class=150, seed=0)
    yago = dict(n_places=600, seed=1, block=128)
    return {"lgd": (ref_synth.make_lgd(**lgd), port_synth.make_lgd(**lgd)),
            "yago": (ref_synth.make_yago(**yago),
                     port_synth.make_yago(**yago)),
            "quickstart": (_quickstart("repro"), _quickstart("repro_torch"))}


def _row_multiset(scores, rows) -> list:
    cols = sorted(rows.keys())
    return sorted(zip(scores.tolist(), *(rows[c].tolist() for c in cols)))


def assert_same_full_scan(got, want) -> None:
    (gs, gr, gst), (ws, wr, wst) = got, want
    assert gs.dtype == ws.dtype
    np.testing.assert_array_equal(gs, ws)
    assert sorted(gr.keys()) == sorted(wr.keys())
    assert _row_multiset(gs, gr) == _row_multiset(ws, wr)
    assert dataclasses.asdict(gst) == dataclasses.asdict(wst)


def assert_same_answer(got, want) -> None:
    (gs, gr, gst), (ws, wr, wst) = got, want
    np.testing.assert_array_equal(gs, ws)
    assert list(gr) == list(wr)
    for c in wr:
        np.testing.assert_array_equal(gr[c], wr[c])
    assert dataclasses.asdict(gst) == dataclasses.asdict(wst)


TOPK = [("lgd", qi) for qi in range(8)] + [("yago", qi) for qi in range(8)] \
    + [("quickstart", 0)]


@pytest.mark.parametrize("name,qi", TOPK, ids=[f"{n}-Q{q + 1}"
                                               for n, q in TOPK])
def test_full_scan_matches_reference(sets, name, qi):
    ref_ds, port_ds = sets[name]
    got = port_base.FullScanEngine(port_ds.store, device="cpu").execute(
        port_ds.queries[qi])
    want = ref_base.FullScanEngine(ref_ds.store).execute(ref_ds.queries[qi])
    assert_same_full_scan(got, want)


SHAPES = {
    "range": dict(window=(15.0, 10.0, 70.0, 60.0)),
    "within": dict(dist=18.0, center=(50.0, 30.0)),
    "join": dict(dist=5.0),
    "knn": dict(knn=4),
}


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_full_scan_shapes_match_reference(sets, name):
    """hotel x park on lgd 150: 22,500 cartesian pairs for the binary
    shapes. Rows, order and stats exact; pair distances within one ulp of
    the f32 core against the reference, exact against the unfused core."""
    out = []
    for pkg, ds, base, kw in ((repro_torch, sets["lgd"][1], port_base,
                               dict(device="cpu")),
                              (repro, sets["lgd"][0], ref_base, {})):
        binary = name in ("join", "knn")
        spatial = dict(SHAPES[name], a=pkg.Var("g1"),
                       b=pkg.Var("g2") if binary else None)
        q = _shape_query(pkg, ds, spatial)
        out.append(base.FullScanEngine(ds.store, **kw).execute(q))
    (gs, gr, gst), (ws, wr, wst) = out
    assert sorted(gr.keys()) == sorted(wr.keys())
    for c in wr:
        np.testing.assert_array_equal(gr[c], wr[c])
    assert dataclasses.asdict(gst) == dataclasses.asdict(wst)
    assert gs.dtype == ws.dtype and len(gs) == len(ws) and len(gs)
    if name not in ("join", "knn"):
        np.testing.assert_array_equal(gs, ws)
        return
    core_g = (gs * gs).astype(np.float32)
    core_w = (ws * ws).astype(np.float32)
    np.testing.assert_array_equal(np.sqrt(core_g.astype(np.float64)), gs)
    np.testing.assert_array_equal(
        core_g, _unfused_cores(sets["lgd"][1].store, gr["place"],
                               gr["nplace"]))
    ulps = np.abs(core_g.view(np.int32).astype(np.int64)
                  - core_w.view(np.int32).astype(np.int64))
    assert ulps.max(initial=0) <= 1


@pytest.mark.parametrize("fanout", [4, 16])
@pytest.mark.parametrize("qi", range(8))
def test_sync_rtree_matches_reference(sets, qi, fanout):
    ref_ds, port_ds = sets["lgd"]
    eng = port_base.SyncRTreeEngine(port_ds.store, fanout=fanout,
                                    device="cpu")
    ref_eng = ref_base.SyncRTreeEngine(ref_ds.store, fanout=fanout)
    got = eng.execute(port_ds.queries[qi])
    want = ref_eng.execute(ref_ds.queries[qi])
    assert_same_answer(got, want)
    assert set(got[2].plan_log) <= {"S"}
    assert dataclasses.asdict(eng._sync_stats) == \
        dataclasses.asdict(ref_eng._sync_stats)
    # SIP off, the S-Plan forced, the rtree join installed
    assert not eng.config.use_sip and eng.config.force_plan == "S"
    assert eng.config.mbr_join_fn is not None


@pytest.mark.parametrize("plan", ["N", "S"])
@pytest.mark.parametrize("qi", range(8))
def test_fixed_plan_engines_match_reference(sets, qi, plan):
    ref_ds, port_ds = sets["lgd"]
    got = port_base.fixed_plan_engine(port_ds.store, plan, device="cpu") \
        .execute(port_ds.queries[qi])
    want = ref_base.fixed_plan_engine(ref_ds.store, plan).execute(
        ref_ds.queries[qi])
    assert_same_answer(got, want)
    assert set(got[2].plan_log) <= {plan}


@pytest.mark.parametrize("qi", [0, 5])
def test_baselines_agree_with_streak(sets, qi):
    """FullScan, SyncRTree and both fixed plans give STREAK's scores."""
    port_ds = sets["lgd"][1]
    q = port_ds.queries[qi]
    want = np.sort(repro_torch.StreakEngine(port_ds.store, device="cpu")
                   .execute(q)[0])
    for eng in (port_base.FullScanEngine(port_ds.store, device="cpu"),
                port_base.SyncRTreeEngine(port_ds.store, device="cpu"),
                port_base.fixed_plan_engine(port_ds.store, "N",
                                            device="cpu"),
                port_base.fixed_plan_engine(port_ds.store, "S",
                                            device="cpu")):
        np.testing.assert_array_equal(np.sort(eng.execute(q)[0]), want)


def test_replace_keeps_a_resolved_policy():
    """`SyncRTreeEngine` and `fixed_plan_engine` replace the config they
    are given, which may already be resolved: re-running `__post_init__`
    on a resolved policy gives the same policy."""
    cfg = repro_torch.ExecConfig(policy=repro_torch.BackendPolicy(
        join="fused", probe="kernel", rank="kernel", descend="kernel"))
    again = dataclasses.replace(cfg, use_sip=False, force_plan="S",
                                mbr_join_fn=lambda *a: None)
    assert again.policy == cfg.policy


class CountingJoin:
    """An `mbr_join_fn` that counts its calls and runs the numpy join."""

    def __init__(self):
        self.calls = 0

    def __call__(self, boxes, dvn_boxes, dist_norm, backend, stats):
        self.calls += 1
        return port_sj.mbr_distance_join(boxes, dvn_boxes, dist_norm,
                                         "numpy", stats)


def _no_fused(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the fused path ran under an mbr_join_fn")
    monkeypatch.setattr(port_sj, "fused_stream_join", refuse)
    monkeypatch.setattr(port_sj, "fused_stream_join_multi", refuse)
    monkeypatch.setattr(port_serve, "_FusedJoinBatcher", refuse)


def test_mbr_join_fn_is_honoured_by_the_engine(sets, monkeypatch):
    port_ds = sets["lgd"][1]
    q = port_ds.queries[0]
    want = repro_torch.StreakEngine(port_ds.store, device="cpu").execute(q)
    _no_fused(monkeypatch)
    hook = CountingJoin()
    eng = repro_torch.StreakEngine(port_ds.store, repro_torch.ExecConfig(
        policy=repro_torch.BackendPolicy(join="fused"), mbr_join_fn=hook),
        device="cpu")
    eng.share_cache = {}
    got = eng.execute(q)
    assert hook.calls > 0
    assert_same_answer(got, want)
    calls = hook.calls
    eng.execute(q)                      # nothing was cached: called again
    assert hook.calls == 2 * calls
    assert not any(k[0] == "mbr" for k in eng.share_cache)


def test_mbr_join_fn_is_honoured_by_the_serve_loop(sets, monkeypatch):
    port_ds = sets["lgd"][1]
    queries = [port_ds.queries[0], port_ds.queries[0], port_ds.queries[5]]
    eng = repro_torch.StreakEngine(port_ds.store, device="cpu")
    want = [eng.execute(q) for q in queries]
    _no_fused(monkeypatch)
    hook = CountingJoin()
    srv = port_serve.SpatialServeEngine(
        port_ds.store, repro_torch.ExecConfig(
            policy=repro_torch.BackendPolicy(join="fused"),
            mbr_join_fn=hook), max_slots=3, device="cpu")
    reqs = srv.serve(queries)
    assert hook.calls > 0
    for req, (scores, rows, _) in zip(reqs, want):
        assert req.error is None
        np.testing.assert_array_equal(req.scores, scores)
        for c in rows:
            np.testing.assert_array_equal(req.rows[c], rows[c])
    assert not any(k[0] == "mbr" for k in srv.engine.share_cache)
