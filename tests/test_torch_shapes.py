"""Port vs reference: the Geographica query shapes (range, within-distance,
kNN, non-top-k spatial join) through `StreakEngine.execute`.

The twin of `tests/test_shapes.py` for the port: the same queries over the
same `make_lgd` data go through the reference's engine and the port's on
``device="cpu"`` (kernel backends there run their plain torch versions),
and scores, rows, row order and statistics must be equal, through `execute` and through the serving
loop. The sharded and packed E-list cases wait for the port's later
slices.
"""
import dataclasses

import numpy as np
import pytest

import repro
import repro_torch
from repro.core import spatial_join as ref_sj
from repro.data import synth_rdf as ref_synth
from repro_torch import tracing
from repro_torch.core import spatial_join as port_sj
from repro_torch.core.executor import SideCache
from repro_torch.core.planner import plan_query
from repro_torch.data import synth_rdf as port_synth


@pytest.fixture(scope="module")
def ds():
    """(reference dataset, port dataset), built alike."""
    build = dict(n_per_class=80, seed=11, block=64)
    return ref_synth.make_lgd(**build), port_synth.make_lgd(**build)


def _shape_query(pkg, d, spatial, cls_a="class:hotel", cls_b="class:park",
                 extra_b=()):
    ns, Var, TP = d.ns, pkg.Var, pkg.TriplePattern
    pa, pb = Var("place"), Var("nplace")
    patterns = [
        TP(pa, Var("typePred1"), ns[cls_a], g=Var("r")),
        TP(Var("r"), ns["hasConfidence"], Var("conf")),
        TP(pa, ns["hasGeometry"], Var("g1")),
        TP(pb, Var("typePred2"), ns[cls_b], g=Var("r1")),
        TP(Var("r1"), ns["hasConfidence"], Var("conf1")),
        TP(pb, ns["hasGeometry"], Var("g2")),
    ]
    for p in extra_b:
        patterns.append(TP(pb, ns[p], Var(f"b_{p}")))
    return pkg.Query(select=(pa, pb), patterns=tuple(patterns),
                     spatial=pkg.SpatialFilter(**spatial), ranking=None)


# the spatial filters of tests/test_shapes.py, as SpatialFilter kwargs
def _f(b=True, **kw):
    return dict(a="g1", b="g2" if b else None, **kw)


SHAPES = {
    "range": _f(False, window=(15.0, 10.0, 70.0, 60.0)),
    "range_sliver": _f(False, window=(40.0, 0.0, 40.5, 100.0)),
    "range_outside": _f(False, window=(400.0, 400.0, 500.0, 500.0)),
    "within": _f(False, dist=18.0, center=(50.0, 30.0)),
    "within_tiny": _f(False, dist=0.01, center=(50.0, 30.0)),
    "join": _f(dist=5.0),
    "join_empty": _f(dist=1e-12),
    "knn1": _f(knn=1),
    "knn4": _f(knn=4),
    "knn_over": _f(knn=10 ** 7),
}


def _both(ds, spatial, policy=None, block=None, deadline=None, **qkw):
    """(port answer, reference answer) of one shape query."""
    out = []
    for pkg, d, kw in ((repro_torch, ds[1], dict(device="cpu")),
                       (repro, ds[0], {})):
        spatial_kw = dict(spatial)
        spatial_kw["a"] = pkg.Var(spatial_kw["a"])
        if spatial_kw["b"] is not None:
            spatial_kw["b"] = pkg.Var(spatial_kw["b"])
        q = _shape_query(pkg, d, spatial_kw, **qkw)
        cfg = {}
        if policy is not None:
            cfg["policy"] = pkg.BackendPolicy(**policy)
        if block is not None:
            cfg["block"] = block
        dl = None if deadline is None else pkg.QueryDeadline(**deadline)
        out.append(pkg.StreakEngine(d.store, pkg.ExecConfig(**cfg), **kw)
                   .execute(q, deadline=dl))
    return out


def _unfused_cores(store, a_ents, b_ents) -> np.ndarray:
    """Per result row, the min over point pairs of ``v = dx*dx; v = v +
    dy*dy`` in f32 with every step rounded (the port's unfused core)."""
    pool, out = store.geom_pool, []
    for ra, rb in zip(store.geom_rows(a_ents), store.geom_rows(b_ents)):
        pa = pool.points[pool.offsets[ra]:pool.offsets[ra + 1]]
        pb = pool.points[pool.offsets[rb]:pool.offsets[rb + 1]]
        d0 = pa[:, None, 0] - pb[None, :, 0]
        d1 = pa[:, None, 1] - pb[None, :, 1]
        v = d0 * d0
        v = v + d1 * d1
        out.append(v.min())
    return np.array(out, dtype=np.float32)


def _assert_same(got, want, pair_store=None):
    """Equal rows, row order, statistics and scores. Pair-distance scores
    (kNN, join; `pair_store` given) come from f32 refinement cores, which
    the reference's jitted CPU code contracts into fused multiply-adds
    (ROADMAP.md, faults): there the port's cores must equal the unfused
    formula exactly and the reference's to within one ulp."""
    (gs, gr, gst), (ws, wr, wst) = got, want
    assert gs.dtype == ws.dtype
    assert sorted(gr.keys()) == sorted(wr.keys())
    for c in wr.keys():
        np.testing.assert_array_equal(gr[c], wr[c])
    assert dataclasses.asdict(gst) == dataclasses.asdict(wst)
    if pair_store is None:
        np.testing.assert_array_equal(gs, ws)
        return got
    # distance = f64 sqrt of an f32 core, so squaring recovers the core
    core_g = (gs * gs).astype(np.float32)
    core_w = (ws * ws).astype(np.float32)
    np.testing.assert_array_equal(np.sqrt(core_g.astype(np.float64)), gs)
    np.testing.assert_array_equal(
        core_g, _unfused_cores(pair_store, gr["place"], gr["nplace"]))
    ulps = np.abs(core_g.view(np.int32).astype(np.int64)
                  - core_w.view(np.int32).astype(np.int64))
    assert ulps.max(initial=0) <= 1
    return got


def _check(ds, spatial, **kw):
    """Run one shape on both packages and hold the port to the reference."""
    pair_store = ds[1].store if spatial["b"] is not None else None
    return _assert_same(*_both(ds, spatial, **kw), pair_store=pair_store)


# ------------------------------------------------ differential, backends --
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_shapes_match_reference(ds, name):
    _check(ds, SHAPES[name])


@pytest.mark.parametrize("join", ["numpy", "kernel", "fused"])
@pytest.mark.parametrize("name", ["range", "within", "join", "knn4"])
def test_shapes_match_reference_across_backends(ds, name, join):
    """Probes, ranks and the descent on their kernel backends, the Phase-3
    join on each backend, against the reference under the same policy."""
    pol = dict(join=join, probe="kernel", rank="kernel", descend="kernel")
    _check(ds, SHAPES[name], policy=pol)


def test_planner_rejects_malformed_shapes(ds):
    d = ds[1]
    Var = repro_torch.Var
    q = _shape_query(repro_torch, d, dict(a=Var("g1"), b=None,
                                          window=(0, 0, 9, 9)))
    with pytest.raises(ValueError, match="selections"):
        plan_query(d.store, dataclasses.replace(
            q, ranking=repro_torch.Ranking(((Var("conf"), 1.0),))))
    with pytest.raises(ValueError, match="positive"):
        repro_torch.StreakEngine(d.store, device="cpu").execute(
            dataclasses.replace(q, spatial=repro_torch.SpatialFilter(
                Var("g1"), Var("g2"), knn=0)))


def test_shape_results_use_canonical_order(ds):
    """Entity-major, then distance; repeat runs are bit-identical (kNN:
    the join at 5.0 has no rows on this data)."""
    got, _ = _both(ds, SHAPES["knn4"], block=16)
    again, _ = _both(ds, SHAPES["knn4"], block=16)
    _assert_same(again, got)            # port against itself: exact
    s1, r1, _ = got
    a = r1["place"]
    assert len(a) and np.all(a[:-1] <= a[1:])
    grp = np.flatnonzero(a[:-1] == a[1:])
    assert np.all(s1[grp] <= s1[grp + 1])


# -------------------------------------------------------- kNN / empty edges --
def test_knn_short_lists_when_k_exceeds_candidates(ds):
    es, erows, estats = _check(ds, SHAPES["knn_over"])
    n_parks = len(np.unique(erows["nplace"]))
    counts = np.unique(erows["place"], return_counts=True)[1]
    assert set(counts.tolist()) == {n_parks}
    assert estats.results_considered == erows.n


def test_knn_empty_driven_side(ds):
    es, erows, estats = _check(ds, _f(knn=3), cls_b="class:police",
                               extra_b=("area",))
    assert erows.n == 0 and len(es) == 0 and not estats.partial


def test_join_empty_result_is_well_formed(ds):
    es, erows, estats = _check(ds, SHAPES["join_empty"])
    assert erows.n == 0 and set(erows.keys()) >= {"place", "nplace"}
    assert estats.driver_blocks >= 1 and set(estats.plan_log) == {"S"}


@pytest.mark.parametrize("name", ["range", "within", "join", "knn4"])
def test_shape_stats_are_consistent(ds, name):
    _, rows, stats = _check(ds, SHAPES[name])
    assert stats.driver_blocks >= 1
    assert stats.plan_s == stats.driver_blocks == len(stats.plan_log)
    assert stats.results_considered == rows.n
    assert not stats.early_terminated


# ----------------------------------------------------------------- deadlines --
def test_deadline_marks_partial_join(ds):
    got = _check(ds, SHAPES["join"], block=8, deadline=dict(max_blocks=1))
    assert got[2].deadline_expired and got[2].partial
    full, _ = _both(ds, SHAPES["join"], block=8)
    assert len(got[0]) <= len(full[0])


def test_deadline_marks_partial_knn(ds):
    got = _check(ds, SHAPES["knn4"], deadline=dict(max_blocks=1))
    assert got[2].deadline_expired and got[2].partial


# ---------------------------------------------- degenerate geometry handling --
def test_pool_min_dist_coincident_points_exactly_zero(ds):
    pool = ds[1].store.geom_pool
    rows = np.arange(8, dtype=np.int64)
    d = port_sj.exact_pair_distance(pool, rows, rows, "euclid", device="cpu")
    np.testing.assert_array_equal(d, np.zeros(8))
    np.testing.assert_array_equal(
        d, ref_sj.exact_pair_distance(ds[0].store.geom_pool, rows, rows))
    keep = port_sj.refine(rows, rows, pool, rows, rows, 0.0, "euclid",
                          device="cpu")
    assert keep.all()


def test_pool_point_min_dist_exact_zero_and_inf(ds):
    pool = ds[1].store.geom_pool
    p = pool.points[pool.offsets[3]].astype(np.float64)
    assert port_sj.pool_point_min_dist(pool, np.array([3]), p)[0] == 0.0
    rows = np.arange(20)
    for metric in ("euclid", "haversine"):
        far = port_sj.pool_point_min_dist(pool, rows, np.array([1e9, 1e9]),
                                          metric)
        assert np.isfinite(far).all() and (far > 0).all()
        np.testing.assert_array_equal(far, ref_sj.pool_point_min_dist(
            ds[0].store.geom_pool, rows, np.array([1e9, 1e9]), metric))


def test_pool_points_in_box_zero_area_window(ds):
    pool = ds[1].store.geom_pool
    p = pool.points[pool.offsets[3]].astype(np.float64)
    assert port_sj.pool_points_in_box(
        pool, np.array([3]), (p[0], p[1], p[0], p[1]))[0]
    assert not port_sj.pool_points_in_box(
        pool, np.array([3]), (p[0] + 1e-3, p[1], p[0] + 1e-3, p[1]))[0]


def test_within_zero_radius_at_stored_point(ds):
    """dist=0 centered on a hotel's f32-stored point: the MBR prune layer
    must not drop what exact refinement keeps."""
    store, ns = ds[1].store, ds[1].ns
    ent = int(store.scan(p=ns["rdf:type"], o=ns["class:hotel"])[0, 1])
    row = int(store.geom_rows(np.array([ent]))[0])
    p = store.geom_pool.points[store.geom_pool.offsets[row]].astype(
        np.float64)
    es, erows, _ = _check(ds, _f(False, dist=0.0,
                                 center=(float(p[0]), float(p[1]))))
    assert erows.n > 0 and np.all(es == 0.0)
    assert ent in set(np.unique(erows["place"]).tolist())


@pytest.mark.parametrize("backend", ["numpy", "kernel", "fused"])
def test_mbr_join_zero_area_boxes_zero_dist(backend):
    pt = np.array([[0.25, 0.5, 0.25, 0.5]])
    other = np.array([[0.25, 0.5, 0.25, 0.5], [0.7, 0.7, 0.7, 0.7]])
    i, j = port_sj.mbr_distance_join(pt, other, 0.0, backend, device="cpu")
    assert i.tolist() == [0] and j.tolist() == [0]


# ----------------------------------------------------- serve-loop adapter --
def test_shapes_through_serve_loop_match_serial(ds):
    """Range, within, join and kNN(4) beside a top-k tenant through the
    serving loop: each request equal to the port's serial run and to the
    reference's serve, the loop's counters too."""
    from repro.serve import spatial as ref_serve
    from repro_torch.serve import spatial as port_serve
    runs = []
    for pkg, mod, d, kw in ((repro, ref_serve, ds[0], {}),
                            (repro_torch, port_serve, ds[1],
                             dict(device="cpu"))):
        queries = []
        for name in ("range", "within", "join", "knn4"):
            spatial_kw = dict(SHAPES[name])
            spatial_kw["a"] = pkg.Var(spatial_kw["a"])
            if spatial_kw["b"] is not None:
                spatial_kw["b"] = pkg.Var(spatial_kw["b"])
            queries.append(_shape_query(pkg, d, spatial_kw))
        queries.append(d.queries[0])            # a top-k companion tenant
        srv = mod.SpatialServeEngine(d.store, pkg.ExecConfig(), max_slots=3,
                                     **kw)
        runs.append((srv, srv.serve(queries), queries))
    (rsrv, rreqs, _), (psrv, preqs, pqs) = runs
    assert dataclasses.asdict(psrv.stats) == dataclasses.asdict(rsrv.stats)
    eng = repro_torch.StreakEngine(ds[1].store, device="cpu")
    for i, (req, want_req, q) in enumerate(zip(preqs, rreqs, pqs)):
        assert req.error is None and want_req.error is None
        want_s, want_r, want_st = eng.execute(q)
        np.testing.assert_array_equal(req.scores, want_s)
        assert list(req.rows) == list(want_r)
        for c in want_r.keys():
            np.testing.assert_array_equal(req.rows[c], want_r[c])
        assert dataclasses.asdict(req.stats) == dataclasses.asdict(want_st)
        pair = ds[1].store if i in (2, 3) else None
        _assert_same((req.scores, req.rows, req.stats),
                     (want_req.scores, want_req.rows, want_req.stats),
                     pair_store=pair)


# ------------------------------------------------------------- cached sides --
def _port_query(d, name: str):
    """The port's query of `SHAPES[name]`; "bare" is a range selection
    whose side is its geometry alone ("every spatial entity"), "empty" a
    kNN whose driven side has no rows."""
    V, TP = repro_torch.Var, repro_torch.TriplePattern
    if name == "bare":
        return repro_torch.Query(
            select=(V("place"),),
            patterns=(TP(V("place"), d.ns["hasGeometry"], V("g1")),),
            spatial=repro_torch.SpatialFilter(V("g1"),
                                              window=(15.0, 10.0, 70.0, 60.0)),
            ranking=None)
    if name == "empty":
        return _port_shape_query(d, _f(knn=3), cls_b="class:police",
                                 extra_b=("area",))
    return _port_shape_query(d, SHAPES[name])


def _port_shape_query(d, spatial, **qkw):
    spatial = dict(spatial)
    spatial["a"] = repro_torch.Var(spatial["a"])
    if spatial["b"] is not None:
        spatial["b"] = repro_torch.Var(spatial["b"])
    return _shape_query(repro_torch, d, spatial, **qkw)


def _engine_plan_sides(d, name: str):
    eng = repro_torch.StreakEngine(d.store, device="cpu")
    plan = plan_query(d.store, _port_query(d, name), policy=eng.config.policy)
    sides = [plan.driver]
    if plan.shape in ("knn", "join"):
        sides.append(plan.driven)
    return eng, plan, sides


def _counted(before: dict, prefix: str) -> dict:
    return {k: v - before.get(k, 0) for k, v in tracing.COUNTS.items()
            if k.startswith(prefix) and v != before.get(k, 0)}


@pytest.mark.parametrize("name", sorted(SHAPES) + ["bare", "empty"])
def test_cached_side_equals_a_fresh_build(ds, name):
    """Every side of the corpus: the engine's cached (relation, entities,
    boxes) equals `QuadStore.entities_with_box` over a fresh engine's
    joined side (every spatial entity for a pattern-less side), array for
    array."""
    d = ds[1]
    eng, plan, sides = _engine_plan_sides(d, name)
    for side in sides:
        rel, ents, boxes = eng.sides.shape(side, plan)
        fresh = repro_torch.StreakEngine(d.store, device="cpu")
        want_rel = (fresh.sides.full(side, plan) if side.all_ordered
                    else {side.entity_var: np.unique(d.store.tree.obj_ids)})
        want_ents, want_boxes = d.store.entities_with_box(
            want_rel[side.entity_var])
        assert sorted(rel.keys()) == sorted(want_rel.keys())
        for c in want_rel.keys():
            np.testing.assert_array_equal(rel[c], want_rel[c])
        assert (ents.dtype, boxes.dtype) == (want_ents.dtype,
                                             want_boxes.dtype)
        np.testing.assert_array_equal(ents, want_ents)
        np.testing.assert_array_equal(boxes, want_boxes)
    if name == "bare":
        tree = d.store.tree
        assert len(ents) == int((~np.isnan(tree.obj_mbr[:, 0])).sum()) > 0


@pytest.mark.parametrize("name", ["range", "within", "join", "knn4", "bare"])
def test_cached_side_is_looked_up_not_built_again(ds, name, monkeypatch):
    """The first lookup of each side builds it; later lookups, and whole
    queries, return the same objects, count `shape.side_hit:<shape>` and
    build nothing."""
    d = ds[1]
    eng, plan, sides = _engine_plan_sides(d, name)
    before = dict(tracing.COUNTS)
    first = [eng.sides.shape(s, plan) for s in sides]
    assert _counted(before, "shape.side_") == {
        f"shape.side_built:{plan.shape}": len(sides)}

    def no_build(*args):
        raise AssertionError("a cached side was built again")

    monkeypatch.setattr(SideCache, "full", no_build)
    monkeypatch.setattr(type(d.store), "entities_with_box", no_build)
    before = dict(tracing.COUNTS)
    again = [eng.sides.shape(s, plan) for s in sides]
    for a, b in zip(again, first):
        assert all(x is y for x, y in zip(a, b))
    eng.execute(_port_query(d, name))
    assert _counted(before, "shape.side_") == {
        f"shape.side_hit:{plan.shape}": 2 * len(sides)}


@pytest.mark.parametrize("name", ["range", "bare", "empty"])
def test_cached_side_arrays_are_read_only(ds, name):
    d = ds[1]
    eng, plan, sides = _engine_plan_sides(d, name)
    _, ents, boxes = eng.sides.shape(sides[-1], plan)
    assert not ents.flags.writeable and not boxes.flags.writeable
    assert (len(ents) == 0) == (name == "empty")
    with pytest.raises(ValueError, match="read-only"):
        ents[:1] = 0
    with pytest.raises(ValueError, match="read-only"):
        boxes[:1] = 0.0


# one template at several windows, centres or distances, each later one
# over other entities than the one before it
SWEEPS = {
    "range": [_f(False, window=w) for w in (
        (15.0, 10.0, 70.0, 60.0), (40.0, 0.0, 40.5, 100.0),
        (0.0, 0.0, 100.0, 100.0), (400.0, 400.0, 500.0, 500.0),
        (60.0, 50.0, 90.0, 95.0), (15.0, 10.0, 70.0, 60.0))],
    "within": [_f(False, dist=r, center=c) for r, c in (
        (18.0, (50.0, 30.0)), (0.01, (50.0, 30.0)), (40.0, (10.0, 90.0)),
        (5.0, (80.0, 20.0)), (18.0, (50.0, 30.0)))],
    "join": [_f(dist=r) for r in (12.0, 1e-12, 20.0, 8.0, 12.0)],
}


@pytest.mark.parametrize("mode", ["serial", "serve"])
@pytest.mark.parametrize("kind", sorted(SWEEPS))
def test_one_template_many_windows_answers_as_a_fresh_engine(ds, kind,
                                                              mode):
    """One engine answers the sweep in turn, serially or through the
    serving loop; each answer equals a fresh engine's, so nothing of one
    window is left in the sides the next one finds."""
    from repro_torch.serve.spatial import SpatialServeEngine
    d = ds[1]
    queries = [_port_shape_query(d, spatial) for spatial in SWEEPS[kind]]
    if mode == "serial":
        eng = repro_torch.StreakEngine(d.store, device="cpu")
        got = [eng.execute(q) for q in queries]
    else:
        srv = SpatialServeEngine(d.store, repro_torch.ExecConfig(),
                                 max_slots=2, device="cpu")
        reqs = srv.serve(queries)
        assert all(r.error is None for r in reqs)
        got = [(r.scores, r.rows, r.stats) for r in reqs]
    rows = set()
    for q, g in zip(queries, got):
        want = repro_torch.StreakEngine(d.store, device="cpu").execute(q)
        _assert_same(g, want)
        rows.add(g[1].n)
    assert len(rows) > 1
