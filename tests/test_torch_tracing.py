"""The program's recorder (`repro_torch.tracing`): spans, request ids and
the always-on counters.

Off, a span records nothing and allocates nothing; on, each span's self
time is its time less its children's, every span of a serve run and of a
serial run carries its request's id (the serve loop's pooled spans -1),
and answers and statistics are bit-identical to a run with the recorder
off. The share-cache counters count every lookup; garbage collections are
spans while the recorder is on. A range and a within selection
(`core/shapes.py`) served by the loop record their `shape.*` spans under
the request's `serve.begin`, and count the rows they return. One case
needs the card: the bytes the rank pass's round trip counts.
"""
import dataclasses
import gc
import time
import tracemalloc

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import tracing
from repro_torch.core.executor import ExecStats
from repro_torch.core.join import rows_in_ranges
from repro_torch.core.planner import plan_query
from repro_torch.core.shard import shard_views
from repro_torch.data import synth_rdf
from repro_torch.kernels import ops
from repro_torch.serve.spatial import SpatialServeEngine

POOLED = {"serve.step", "serve.pool", "sip.pooled", "phase3.flush"}
# spans a request opens inside a pooled span
OWN_IN_POOLED = {"serve.admit", "serve.begin", "serve.finish",
                 "serve.retire", "refine.emit"}


@pytest.fixture(autouse=True)
def recorder_off():
    """Each test starts and ends with the recorder off and empty."""
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


@pytest.fixture(scope="module")
def lgd():
    return synth_rdf.make_lgd(n_per_class=150, seed=0, block=128)


def config(**policy):
    return repro_torch.ExecConfig(
        policy=repro_torch.BackendPolicy(join="fused", **policy),
        fused_batch_cols=256)


KS = (5, 20, 60, 120)


def mixed(d):
    return [dataclasses.replace(q, k=KS[i % len(KS)])
            for i, q in enumerate(d.queries)]


def serve(d, queries, traced: bool, **kw):
    srv = SpatialServeEngine(d.store, config(), max_slots=4, device="cpu",
                             **kw)
    if traced:
        tracing.enable()
    reqs = srv.serve(queries)
    tracing.disable()
    return srv, reqs


def serial(d, queries, traced: bool):
    eng = repro_torch.StreakEngine(d.store, config(), device="cpu")
    if traced:
        tracing.enable()
    out = [eng.execute(q) for q in queries]
    tracing.disable()
    return out


def names_of(spans, names):
    return np.array(names, dtype=object)[spans["name"]] if len(names) \
        else np.empty(0, dtype=object)


# -------------------------------------------------------------- the recorder
def test_off_records_nothing_and_allocates_nothing():
    with tracing.span("exec.execute"):
        with tracing.span("exec.cursor", 3):
            pass
    spans, _ = tracing.drain()
    assert all(len(c) == 0 for c in spans.values())
    for _ in range(3):                   # warm the calls' own caches
        with tracing.span("sip.pooled", -1):
            pass
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(1000):
            with tracing.span("sip.pooled", -1):
                pass
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grew = [s for s in after.compare_to(before, "filename")
            if s.traceback[0].filename == tracing.__file__
            and s.size_diff > 0]
    assert grew == []


def test_self_time_is_the_span_less_its_children():
    tracing.enable()
    with tracing.span("exec.execute"):
        time.sleep(0.002)
        with tracing.span("exec.cursor"):
            time.sleep(0.003)
            with tracing.span("exec.plan"):
                time.sleep(0.001)
        with tracing.span("exec.materialize"):
            time.sleep(0.002)
    tracing.disable()
    spans, names = tracing.drain()
    got = list(names_of(spans, names))
    assert got == ["exec.execute", "exec.cursor", "exec.plan",
                   "exec.materialize"]
    assert spans["parent"].tolist() == [-1, 0, 1, 0]
    dur = spans["end"] - spans["start"]
    own = tracing.self_ns(spans)
    assert own[0] == dur[0] - dur[1] - dur[3]
    assert own[1] == dur[1] - dur[2]
    assert own[2] == dur[2] and own[3] == dur[3]
    assert (own > 0).all()
    assert own.sum() == dur[0]
    # a root without an id is its request's root: its own row
    assert spans["rid"].tolist() == [0, 0, 0, 0]


def test_decorated_function_is_one_span_and_keeps_its_name():
    @tracing.spanned("driven.aps")
    def choose(x):
        """Route."""
        return x + 1

    assert choose.__name__ == "choose" and choose.__doc__ == "Route."
    assert choose(1) == 2
    assert len(tracing.drain()[0]["name"]) == 0
    tracing.enable()
    with tracing.span("serve.finish", 7):
        assert choose(2) == 3
    tracing.disable()
    spans, names = tracing.drain()
    assert list(names_of(spans, names)) == ["serve.finish", "driven.aps"]
    assert spans["rid"].tolist() == [7, 7]
    assert spans["parent"].tolist() == [-1, 0]


def test_disable_ends_open_spans_and_drain_empties():
    tracing.enable()
    with tracing.span("serve.step", -1):
        tracing.disable()
    spans, _ = tracing.drain()
    assert len(spans["name"]) == 1 and spans["end"][0] >= spans["start"][0]
    assert all(len(c) == 0 for c in tracing.drain()[0].values())


def test_gc_pauses_are_spans_while_on():
    tracing.enable()
    with tracing.span("exec.execute"):
        gc.collect()
    tracing.disable()
    gc.collect()
    spans, names = tracing.drain()
    got = names_of(spans, names)
    gcs = np.flatnonzero(got == "host.gc")
    assert len(gcs) >= 1
    full = [i for i in gcs if spans["gen"][i] == 2]
    assert full, spans["gen"][gcs]
    i = full[-1]
    assert spans["parent"][i] == 0 and spans["rid"][i] == 0
    assert spans["start"][0] <= spans["start"][i] <= spans["end"][i] \
        <= spans["end"][0]
    assert (spans["gen"][got != "host.gc"] == -1).all()
    # the collection after disable() left no span
    assert spans["end"][gcs].max() <= spans["end"][0]


# --------------------------------------------------------- request ids
def test_serve_spans_carry_their_request_ids(lgd):
    queries = mixed(lgd)
    _, reqs = serve(lgd, queries, traced=True)
    spans, names = tracing.drain()
    got = names_of(spans, names)
    rid, parent = spans["rid"], spans["parent"]
    rids = {r.rid for r in reqs}
    assert set(rid.tolist()) <= rids | {-1}
    for name in POOLED:
        assert (rid[got == name] == -1).all(), name
    steps = got == "serve.step"
    assert steps.any() and (parent[steps] == -1).all()
    for name in ("serve.pool", "sip.pooled", "phase3.flush"):
        assert (got == name).any(), name
        assert (got[parent[got == name]] == "serve.step").all(), name
    for i in range(len(got)):
        p = parent[i]
        assert p >= 0 or got[i] in ("serve.step", "host.gc"), got[i]
        if p < 0:
            continue
        if rid[p] != -1:                 # inside a request's span: its id
            assert rid[i] == rid[p], (got[i], got[p])
        elif rid[i] != -1:               # a request's span in a pooled one
            assert got[i] in OWN_IN_POOLED, got[i]
    # every request's own spans: admitted, begun and retired once at least
    for name in ("serve.admit", "serve.retire"):
        assert sorted(rid[got == name].tolist()) == sorted(rids), name
    assert set(rid[got == "serve.begin"].tolist()) == rids
    # refinement in a shared launch is on behalf of a query whose block
    # was registered in the same step
    for i in np.flatnonzero((got == "refine.emit")
                            & (got[np.maximum(parent, 0)]
                               == "phase3.flush")):
        step = parent[parent[i]]
        finished = rid[(parent == step) & (got == "serve.finish")]
        assert rid[i] in finished.tolist()
    cursors = np.flatnonzero(got == "exec.cursor")
    assert len(cursors) == len(reqs)
    assert (got[parent[cursors]] == "serve.admit").all()


def test_serial_spans_carry_their_execute_span(lgd):
    serial(lgd, lgd.queries[:4], traced=True)
    spans, names = tracing.drain()
    got = names_of(spans, names)
    outside = (spans["parent"] == -1) & (got == "host.gc")
    assert (spans["rid"][outside] == -1).all()
    roots = np.flatnonzero((spans["parent"] == -1) & ~outside)
    assert list(got[roots]) == ["exec.execute"] * 4
    # each span's id is the row of the execute span it runs under
    owner = np.searchsorted(roots, np.arange(len(got)), side="right") - 1
    np.testing.assert_array_equal(spans["rid"][~outside],
                                  roots[owner][~outside])
    for name in ("exec.cursor", "exec.plan", "exec.materialize", "sip.select",
                 "sip.descend", "sip.node_select", "exec.filter_material",
                 "driven.aps", "phase3.prepare", "phase3.join",
                 "refine.emit", "refine.exact"):
        assert (got == name).any(), name


# ------------------------------------------------------- query shapes
SHAPE_SPANS = ("shape.side", "shape.material", "shape.exact", "shape.rows")


def selections(d):
    """A map window over hotels and a lookup of roads within d of a
    point: one class each, one row an entity."""
    V, TP = repro_torch.Var, repro_torch.TriplePattern
    ns = d.ns

    def of(cls, pred, spatial):
        place = V("place")
        return repro_torch.Query(
            select=(place, V(pred)),
            patterns=(TP(place, ns["rdf:type"], ns[cls], g=V("r")),
                      TP(place, ns["hasGeometry"], V("g")),
                      TP(place, ns[pred], V(pred))),
            spatial=repro_torch.SpatialFilter(V("g"), **spatial),
            ranking=None)

    return [of("class:hotel", "name", dict(window=(20.0, 20.0, 60.0, 60.0))),
            of("class:road", "name", dict(dist=15.0, center=(50.0, 40.0)))]


def test_selection_spans_sit_under_their_requests_begin(lgd):
    """Each selection served twice by one engine: the first of a side
    builds its entities and boxes, the second finds them; `shape.side`
    sits under its executor either way."""
    before = dict(tracing.COUNTS)
    _, reqs = serve(lgd, selections(lgd) * 2, traced=True)
    spans, names = tracing.drain()
    got = names_of(spans, names)
    rid, parent = spans["rid"], spans["parent"]
    counted = {k: v - before.get(k, 0) for k, v in tracing.COUNTS.items()
               if k.startswith("shape.")}
    shapes = ("range", "within") * 2
    for req, shape in zip(reqs, shapes):
        assert req.error is None and req.rows.n > 0
        top = np.flatnonzero((got == f"shape.{shape}") & (rid == req.rid))
        assert len(top) == 1
        assert got[parent[top[0]]] == "serve.begin"
        assert rid[parent[top[0]]] == req.rid
        # every span under the selection carries its request's id
        under = top.tolist()
        for i in range(top[0] + 1, len(got)):
            if parent[i] in under:
                under.append(i)
                assert rid[i] == req.rid, got[i]
        for name in SHAPE_SPANS + ("sip.select",):
            assert name in set(got[under]), (shape, name)
        side = np.flatnonzero((got == "shape.side") & (rid == req.rid))
        assert len(side) == 1 and parent[side[0]] == top[0]
    for shape in ("range", "within"):
        n = sum(r.rows.n for r, s in zip(reqs, shapes) if s == shape)
        assert counted[f"shape.rows:{shape}"] == n
        assert counted[f"shape.entities:{shape}"] \
            >= counted[f"shape.kept:{shape}"] >= n
        assert counted[f"shape.side_built:{shape}"] == 1
        assert counted[f"shape.side_hit:{shape}"] == 1


@pytest.mark.parametrize("shape,spatial", [
    ("knn", dict(knn=2)), ("join", dict(dist=3.0))])
def test_pair_shape_spans_sit_under_their_executor(lgd, shape, spatial):
    """kNN and the non-top-k join: both sides, the exact distances and the
    rows out are spans under `shape.<shape>`, on behalf of the request."""
    V, TP, ns = repro_torch.Var, repro_torch.TriplePattern, lgd.ns
    a, b = V("place"), V("nplace")
    q = repro_torch.Query(
        select=(a, b),
        patterns=(TP(a, ns["rdf:type"], ns["class:hotel"], g=V("r")),
                  TP(a, ns["hasGeometry"], V("g1")),
                  TP(b, ns["rdf:type"], ns["class:police"], g=V("r1")),
                  TP(b, ns["hasGeometry"], V("g2"))),
        spatial=repro_torch.SpatialFilter(V("g1"), V("g2"), **spatial),
        ranking=None)
    key = f"shape.side_built:{shape}"
    before = tracing.COUNTS.get(key, 0)
    (scores, rows, _), = serial(lgd, [q], traced=True)
    assert rows.n > 0
    assert tracing.COUNTS[key] - before == 2
    spans, names = tracing.drain()
    got = names_of(spans, names)
    top = np.flatnonzero(got == f"shape.{shape}")
    assert len(top) == 1
    kids = got[spans["parent"] == top[0]]
    assert list(kids).count("shape.side") == 2
    for name in ("shape.exact", "shape.rows", "sip.select"):
        assert name in kids, name
    assert (spans["rid"][spans["parent"] >= 0]
            == spans["rid"][top[0]]).all()


def test_selections_are_bit_identical_with_tracing_on(lgd):
    _, off = serve(lgd, selections(lgd), traced=False)
    _, on = serve(lgd, selections(lgd), traced=True)
    assert len(tracing.drain()[0]["name"]) > 0
    for a, b in zip(on, off):
        assert a.rows.n > 0
        np.testing.assert_array_equal(a.scores, b.scores)
        assert a.rows.keys() == b.rows.keys()
        for c in b.rows.keys():
            np.testing.assert_array_equal(a.rows[c], b.rows[c])
        assert dataclasses.asdict(a.stats) == dataclasses.asdict(b.stats)


# ---------------------------------------------------- on equals off
def test_serve_is_bit_identical_with_tracing_on(lgd):
    queries = mixed(lgd)
    off_srv, off = serve(lgd, queries, traced=False)
    on_srv, on = serve(lgd, queries, traced=True)
    assert len(tracing.drain()[0]["name"]) > 0
    assert dataclasses.asdict(on_srv.stats) == dataclasses.asdict(
        off_srv.stats)
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a.scores, b.scores)
        assert a.rows.keys() == b.rows.keys()
        for c in b.rows.keys():
            np.testing.assert_array_equal(a.rows[c], b.rows[c])
        assert dataclasses.asdict(a.stats) == dataclasses.asdict(b.stats)
        assert (a.steps, a.waited, a.error) == (b.steps, b.waited, b.error)


def test_serial_is_bit_identical_with_tracing_on(lgd):
    off = serial(lgd, mixed(lgd), traced=False)
    on = serial(lgd, mixed(lgd), traced=True)
    assert len(tracing.drain()[0]["name"]) > 0
    for (s1, r1, st1), (s0, r0, st0) in zip(on, off):
        np.testing.assert_array_equal(s1, s0)
        assert r1.keys() == r0.keys()
        for c in r0.keys():
            np.testing.assert_array_equal(r1[c], r0[c])
        assert dataclasses.asdict(st1) == dataclasses.asdict(st0)


# ------------------------------------------------------------ counters
class CountingCache(dict):
    """A share cache that counts its lookups."""

    def __init__(self):
        super().__init__()
        self.lookups = 0

    def __contains__(self, key):
        self.lookups += 1
        return super().__contains__(key)


@pytest.mark.parametrize("policy", [{}, {"join": "kernel"}])
def test_share_counters_count_every_lookup(lgd, policy):
    """Two tenants of one shape (k 5 and 20): the share cache must hit,
    and its hits and misses add up to its lookups."""
    cfg = dict(policy)
    join = cfg.pop("join", "fused")
    srv = SpatialServeEngine(
        lgd.store, repro_torch.ExecConfig(
            policy=repro_torch.BackendPolicy(join=join, **cfg),
            fused_batch_cols=256),
        max_slots=2, device="cpu")
    srv.engine.share_cache = cache = CountingCache()
    before = dict(tracing.COUNTS)
    srv.serve([dataclasses.replace(lgd.queries[0], k=k) for k in (5, 20)])

    def delta(prefix):
        return {k: v - before.get(k, 0) for k, v in tracing.COUNTS.items()
                if k.startswith(prefix) and v != before.get(k, 0)}

    hits, misses = delta("share.hit:"), delta("share.miss:")
    assert sum(hits.values()) > 0
    assert sum(hits.values()) + sum(misses.values()) == cache.lookups
    kinds = {k.split(":")[1] for k in {**hits, **misses}}
    assert kinds <= {"mat", "splan", "nblk", "mbr", "refine"}
    assert "mat" in kinds
    assert ("mbr" in kinds) == (join == "kernel")


def test_upload_counts_only_what_crosses_to_a_card():
    before = dict(tracing.COUNTS)
    x = np.arange(10, dtype=np.int64)
    t = ops.upload(x, "cpu", "fused_topk_join")
    np.testing.assert_array_equal(t.numpy(), x)
    assert tracing.COUNTS == before


# -------------------------------------------------------------- the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_rank_round_trip_counts_its_staged_words(card):
    rng = np.random.default_rng(0)
    table = np.sort(rng.integers(0, 1 << 40, 5000))
    probes = rng.integers(0, 1 << 40, 300)
    resident = ops.device_table(table, card)

    def counted(**kw):
        before = dict(tracing.COUNTS)
        lo, hi = ops.merge_join_ranks(table, probes, backend="kernel",
                                      device=card, **kw)
        np.testing.assert_array_equal(lo, np.searchsorted(table, probes,
                                                          "left"))
        np.testing.assert_array_equal(hi, np.searchsorted(table, probes,
                                                          "right"))
        return {k: v - before.get(k, 0) for k, v in tracing.COUNTS.items()
                if v != before.get(k, 0)}

    assert counted() == {"h2d.copy:merge_join_ranks":
                         (len(table) + len(probes)) * 8}
    assert counted(table_on_device=resident) == {
        "h2d.mapped:merge_join_ranks": len(probes) * 8}


@pytest.mark.cuda
def test_splan_filter_ranks_its_block_against_the_side_index(card, lgd):
    """An S-Plan filter on the card is one `merge_join_ranks` launch that
    reads the block's 2I + E interval bounds and E-list ids in place
    against the side's index; the index's sorted column goes up once for
    the engine, and nothing stages a table."""
    eng = repro_torch.StreakEngine(lgd.store, repro_torch.ExecConfig(
        force_plan="S", policy=repro_torch.BackendPolicy(rank="kernel")),
        device=card)
    plan = plan_query(lgd.store, lgd.queries[0], policy=eng.config.policy)
    side = plan.driven
    full = eng.sides.full(side, plan)       # the joins' tables go up here
    sh = shard_views(lgd.store)[0]
    n_nodes = len(sh.tree.irange)
    rng = np.random.default_rng(0)
    for block in range(3):
        v_star = np.sort(rng.choice(n_nodes, size=n_nodes // 3,
                                    replace=False)).astype(np.int64)
        intervals, explicit = sh.filter_material(v_star)
        before = dict(tracing.COUNTS)
        launches = ops.LAUNCHES["merge_join_ranks"]
        rel, _ = eng._driven_splan(side, plan, intervals, explicit,
                                   ExecStats())
        assert ops.LAUNCHES["merge_join_ranks"] == launches + 1
        want = {"driven.sip:indexed": 1, "h2d.mapped:merge_join_ranks":
                (2 * len(intervals) + len(explicit)) * 8}
        if block == 0:
            want["h2d.copy:rank_table"] = full.n * 8
        assert {k: v - before.get(k, 0) for k, v in tracing.COUNTS.items()
                if v != before.get(k, 0)} == want
        rows = rows_in_ranges(full, side.entity_var, intervals, explicit,
                              "numpy")
        for c in full:
            np.testing.assert_array_equal(rel[c], full[c][rows])
