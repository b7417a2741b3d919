"""The S-Plan's SIP filter through the side's index.

An S-Plan block keeps the rows of the engine's cached full driven relation
whose entity lies in one of the block's I-Range intervals or equals one of
its E-list ids. `join.rows_in_index` ranks the intervals' bounds and the
ids against the relation's entity column, sorted once per engine
(`join.SipIndex`, kept by `executor.SideCache.sip_index`), instead of
ranking every row against them (`join.rows_in_ranges`). Both, and the
looped oracle, must keep the same rows in the same order; the engine and
the serve loop must answer as the reference does, with the same plan log
and statistics, and build each side's index once.
"""
import dataclasses
import functools

import numpy as np
import pytest

import repro
import repro_torch
from repro.data import synth_rdf as ref_synth
from repro.serve import spatial as ref_serve
from repro_torch import tracing
from repro_torch.core import fault
from repro_torch.core import join as pjoin
from repro_torch.data import synth_rdf as port_synth
from repro_torch.kernels import ops
from repro_torch.serve import spatial as port_serve
from test_torch_engine import assert_same_answer
from test_torch_serve_spatial import assert_same_request

COL = "e"


@pytest.fixture(autouse=True)
def _clean_fault_state():
    fault.STATE.reset()
    yield
    fault.STATE.reset()


# ------------------------------------------------------- the filter alone ---
def _iv(*pairs) -> np.ndarray:
    return np.array(pairs, dtype=np.int64).reshape(-1, 2)


def _ids(*ids) -> np.ndarray:
    return np.array(ids, dtype=np.int64)


# (intervals, E-list ids) over a column of values in [0, 300)
CASES = {
    "overlapping": (_iv((10, 50), (40, 90), (85, 85), (120, 140)), _ids()),
    "nested": (_iv((10, 200), (20, 30), (25, 26), (150, 160)), _ids(5)),
    "touching": (_iv((10, 19), (20, 29), (30, 30), (31, 40)), _ids()),
    "empty_and_inverted": (_iv((50, 40), (7, 3), (60, 60), (61, 62)),
                           _ids()),
    "ids_inside_intervals": (_iv((10, 50), (200, 220)),
                             _ids(12, 30, 49, 51, 210, 260)),
    "ids_absent": (_iv((10, 20)), _ids(-5, 301, 400, 1 << 40)),
    "ids_duplicated_in_column": (_iv(), _ids(0, 7, 77, 150, 299)),
    "no_intervals": (_iv(), _ids(1, 2, 3, 100, 250)),
    "no_ids": (_iv((0, 0), (100, 180), (299, 299)), _ids()),
    "nothing": (_iv(), _ids()),
    "keeps_every_row": (_iv((-10, 5), (0, 299)), _ids(4, 200)),
    "random": None,
}


def _relation(case: str, sort: bool, rng) -> pjoin.Relation:
    n = 0 if case == "empty_relation" else 400
    vals = rng.integers(0, 300, n).astype(np.int64)
    if case == "ids_duplicated_in_column":
        vals[::7] = rng.choice([0, 7, 77, 150, 299], size=len(vals[::7]))
    rel = pjoin.Relation({COL: vals, "v": np.arange(n, dtype=np.int64),
                          "w": rng.integers(0, 9, n).astype(np.int64)})
    if sort:
        rel = rel.take(np.argsort(vals, kind="stable"))
        rel.sorted_by = (COL, "v")
    return rel


def _material(case: str, rng) -> tuple:
    if case in ("random", "empty_relation"):
        lo = rng.integers(-20, 320, 12)
        iv = np.stack([lo, lo + rng.integers(-5, 40, 12)], 1)
        return iv.astype(np.int64), np.unique(rng.integers(-10, 310, 40))
    return CASES[case]


@pytest.mark.parametrize("backend", ["numpy", "kernel"])
@pytest.mark.parametrize("sort", [True, False], ids=["sorted", "unsorted"])
@pytest.mark.parametrize("case", [*CASES, "empty_relation"])
def test_indexed_filter_equals_scan_and_oracle(case, sort, backend):
    """Row for row: the indexed filter, the merge filter that ranks every
    row, and the looped oracle; on the kernel backend against the index's
    resident copy (the plain version on the CPU)."""
    rng = np.random.default_rng([len(case), int(sort)])
    for _ in range(3 if case == "random" else 1):
        rel = _relation(case, sort, rng)
        intervals, explicit = _material(case, rng)
        index = pjoin.SipIndex.build(rel, COL, backend, "cpu")
        assert (index.perm is None) == sort
        assert (index.on_device is not None) == (backend == "kernel")
        got = pjoin.rows_in_index(index, intervals, explicit, backend, "cpu")
        want = pjoin.rows_in_ranges(rel, COL, intervals, explicit, backend,
                                    "cpu")
        assert got.dtype == want.dtype == np.int64
        np.testing.assert_array_equal(got, want)
        oracle = pjoin.filter_in_ranges_looped(rel, COL, intervals, explicit)
        kept, rows = pjoin.select_in_ranges(rel, COL, intervals, explicit,
                                            "merge", backend, "cpu", index)
        np.testing.assert_array_equal(rows, got)
        assert kept.sorted_by == rel.sorted_by and list(kept) == list(rel)
        for c in rel:
            np.testing.assert_array_equal(kept[c], oracle[c])
        if case == "keeps_every_row":
            assert len(got) == rel.n
        if case in ("nothing", "empty_relation"):
            assert len(got) == 0


# ------------------------------------------------------------- the engine ---
@functools.lru_cache(maxsize=None)
def _datasets(name: str) -> tuple:
    """(reference dataset, port dataset), built alike."""
    if name == "yago":
        build = dict(n_places=600, seed=1, block=128)
        return ref_synth.make_yago(**build), port_synth.make_yago(**build)
    build = dict(n_per_class=60, seed=0, block=64)
    return ref_synth.make_lgd(**build), port_synth.make_lgd(**build)


def _config(pkg, force_plan, rank="numpy"):
    return pkg.ExecConfig(force_plan=force_plan, use_sip=True,
                          policy=pkg.BackendPolicy(
                              join="numpy", descend="numpy", probe="numpy",
                              impl="merge", rank=rank))


@functools.lru_cache(maxsize=None)
def _reference(name: str, force_plan):
    ref_ds = _datasets(name)[0]
    eng = repro.StreakEngine(ref_ds.store, _config(repro, force_plan))
    return [eng.execute(q) for q in ref_ds.queries]


def _counted(fn) -> tuple:
    before = dict(tracing.COUNTS)
    out = fn()
    return out, {k: v - before.get(k, 0) for k, v in tracing.COUNTS.items()
                 if v != before.get(k, 0)}


@pytest.fixture
def index_builds(monkeypatch):
    """Every `SipIndex.build`: the index it made."""
    built = []
    inner = pjoin.SipIndex.build.__func__

    def build(cls, *args, **kw):
        built.append(inner(cls, *args, **kw))
        return built[-1]

    monkeypatch.setattr(pjoin.SipIndex, "build", classmethod(build))
    return built


@pytest.mark.parametrize("rank", ["numpy", "kernel"])
@pytest.mark.parametrize("force_plan", ["S", None], ids=["S", "adaptive"])
@pytest.mark.parametrize("name", ["lgd", "yago"])
def test_serial_answers_equal_reference_and_index_is_built_once(
        name, force_plan, rank, index_builds):
    """One engine over every query, twice: answers, plan logs and
    statistics equal the reference's, each S-Plan filter counts one
    `driven.sip:indexed`, and the second pass builds no index."""
    port_ds = _datasets(name)[1]
    eng = repro_torch.StreakEngine(port_ds.store, _config(
        repro_torch, force_plan, rank), device="cpu")
    want = _reference(name, force_plan)
    for turn in range(2):
        got, counts = _counted(lambda: [eng.execute(q)
                                        for q in port_ds.queries])
        for g, w in zip(got, want):
            assert_same_answer(g, w)
        plan_s = sum(st.plan_s for _, _, st in got)
        assert counts.get("driven.sip:indexed", 0) == plan_s
        if force_plan == "S":
            assert plan_s > 0 and "driven.sip:scanned" not in counts
        if turn == 0:
            n_built = len(index_builds)
            assert n_built >= (plan_s > 0)
    assert len(index_builds) == n_built
    for ix in index_builds:
        assert (ix.on_device is not None) == (rank == "kernel")


@pytest.mark.parametrize("force_plan", ["S", None], ids=["S", "adaptive"])
@pytest.mark.parametrize("name", ["lgd", "yago"])
def test_serve_loop_answers_equal_reference(name, force_plan):
    """The serve loop with the share cache: every request and `ServeStats`
    equal the reference's; a filter that ran (a share miss) counts one
    `driven.sip:indexed`."""
    ref_ds, port_ds = _datasets(name)
    ks = (5, 20, 60, 120)

    def queries(d):
        return [dataclasses.replace(q, k=ks[i % len(ks)])
                for i, q in enumerate(d.queries + d.queries)]

    ref_srv = ref_serve.SpatialServeEngine(
        ref_ds.store, _config(repro, force_plan), max_slots=8)
    want = ref_srv.serve(queries(ref_ds))
    srv = port_serve.SpatialServeEngine(
        port_ds.store, _config(repro_torch, force_plan, "kernel"),
        max_slots=8, device="cpu")
    got, counts = _counted(lambda: srv.serve(queries(port_ds)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_same_request(g, w)
    assert dataclasses.asdict(srv.stats) == dataclasses.asdict(ref_srv.stats)
    assert counts.get("driven.sip:indexed", 0) == \
        counts.get("share.miss:splan", 0)
    if force_plan == "S":
        assert counts["driven.sip:indexed"] > 0


def test_demoted_rank_stage_answers_alike(index_builds):
    """A `FaultPlan` whose rank chain is exhausted demotes the rank stage
    at plan time; that engine's index lives under the numpy backend, holds
    no device copy, and its answers equal the reference's."""
    port_ds = _datasets("lgd")[1]
    with fault.fault_plan(fault.FaultPlan(rules=(
            fault.FaultRule(op="merge_join_ranks", attempts=99),))):
        for _ in range(fault.STATE.breaker_threshold):
            with pytest.raises(fault.FallbackExhausted):
                ops.merge_join_ranks(np.arange(4), np.arange(2),
                                     backend="kernel", device="cpu")
        cfg = _config(repro_torch, "S", "kernel")
    assert cfg.policy.rank == "numpy"
    fault.STATE.reset()
    eng = repro_torch.StreakEngine(port_ds.store, cfg, device="cpu")
    for g, w in zip([eng.execute(q) for q in port_ds.queries],
                    _reference("lgd", "S")):
        assert_same_answer(g, w)
    assert index_builds and all(ix.on_device is None for ix in index_builds)
