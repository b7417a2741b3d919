"""Phase 3's driven side, gathered against looked up.

An S-Plan block keeps rows of the engine's cached full driven relation;
when that relation is sorted by the driven entity variable, `_phase3`
gathers the block's driven entities, boxes and key bounds from the
relation's `DrivenMaterial` instead of sorting and searching them
(`StreakEngine._driven_entities`). The two must agree bit for bit on every
block, on YAGO- and LGD-shaped stores, and the `phase3.prepare:gathered` /
`phase3.prepare:looked_up` counters say which path each block took.
"""
import dataclasses
import functools

import numpy as np
import pytest

from repro_torch import tracing
from repro_torch.core import ExecConfig, StreakEngine
from repro_torch.core.executor import DrivenMaterial, QueryCursor
from repro_torch.core.join import Relation, rows_in_ranges
from repro_torch.core.planner import plan_query
from repro_torch.core.query import Ranking
from repro_torch.core.shard import shard_store, shard_views
from repro_torch.data import synth_rdf


@functools.lru_cache(maxsize=None)
def _dataset(name: str):
    if name == "yago":
        return synth_rdf.make_yago(n_places=600, seed=1, block=128)
    return synth_rdf.make_lgd(n_per_class=150, seed=0, block=64)


@functools.lru_cache(maxsize=None)
def _sharded(name: str):
    return shard_store(_dataset(name).store, 4)


def _ranked(q, descending: bool, scale: float = 1.0):
    terms = tuple((v, scale * w) for v, w in q.ranking.terms)
    return dataclasses.replace(q, ranking=Ranking(terms, descending))


def _same(got: tuple, want: tuple) -> None:
    """(entities, boxes, bounds) equal bit for bit, dtypes and shapes too."""
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


def _by_entity(rel: Relation, var: str) -> Relation:
    """`rel` stably sorted by `var` (an LGD driven relation is sorted by
    its reified fact)."""
    out = rel.take(np.argsort(rel[var], kind="stable"))
    out.sorted_by = (var,)
    return out


def _with_gaps(rel: Relation, side, store, rng) -> Relation:
    """`rel` with duplicated rows, rows of entities that have no geometry,
    and quant values that are not numeric literals (NaN contributions)."""
    var = side.entity_var
    ents = rel[var]
    dup = rng.choice(rel.n, size=max(rel.n // 4, 1))
    plain = np.setdiff1d(np.concatenate([ents + 1, ents - 1]),
                         store.tree.obj_ids)
    extra = rel.take(rng.choice(rel.n, size=max(rel.n // 8, 1)))
    extra[var] = rng.choice(plain, size=extra.n)
    cols = {c: np.concatenate([rel[c], rel[c][dup], extra[c]]) for c in rel}
    for _, qv, _ in side.quant_terms:
        bad = rng.random(len(cols[qv])) < 0.2
        cols[qv] = np.where(bad, cols[var], cols[qv])
    return _by_entity(Relation(cols), var)


def _rows_cases(case: str, rel: Relation, side, dataset: str, rng) -> list:
    """Row selections of `rel` (ascending) for one case."""
    if case == "none":
        return [np.empty(0, dtype=np.int64)]
    if case == "all":
        return [np.arange(rel.n)]
    views = shard_views(_sharded(dataset) if case == "sharded"
                        else _dataset(dataset).store)
    out = []
    for sh in views:
        n_nodes = len(sh.tree.irange)
        v_star = np.sort(rng.choice(n_nodes, size=max(n_nodes // 3, 1),
                                    replace=False)).astype(np.int64)
        intervals, explicit = sh.filter_material(v_star)
        out.append(rows_in_ranges(rel, side.entity_var, intervals, explicit))
    return out


@pytest.mark.parametrize("descending", [True, False])
@pytest.mark.parametrize("case", ["sip", "sharded", "none", "all", "gaps"])
@pytest.mark.parametrize("dataset", ["yago", "lgd"])
def test_gathered_equals_looked_up(dataset, case, descending):
    ds = _dataset(dataset)
    store = ds.store
    eng = StreakEngine(store, ExecConfig(), device="cpu")
    rng = np.random.default_rng([len(case), int(descending)])
    seen = dict(blocks=0, dup=False, no_geo=False, nan=False)
    for q in ds.queries:
        plan = plan_query(store, _ranked(q, descending),
                          policy=eng.config.policy)
        side = plan.driven
        rel = _by_entity(eng.sides.full(side, plan), side.entity_var)
        if case == "gaps":
            rel = _with_gaps(rel, side, store, rng)
        contrib = eng._key_contrib(rel, side, plan)
        mat = DrivenMaterial.build(store.tree, rel[side.entity_var], contrib)
        ents = rel[side.entity_var]
        seen["dup"] |= bool(len(np.unique(ents)) < len(ents))
        seen["no_geo"] |= bool((mat.geo < 0).any())
        seen["nan"] |= bool(np.isneginf(contrib).any())
        for rows in _rows_cases(case, rel, side, dataset, rng):
            for bound in (True, False):
                _same(mat.entities(rows, bound),
                      eng._driven_entities(rel.take(rows), side, plan, bound))
            seen["blocks"] += 1
    assert seen["blocks"] >= len(ds.queries)
    if case == "gaps":
        assert seen["dup"] and seen["no_geo"] and seen["nan"]


@pytest.mark.parametrize("descending", [True, False])
@pytest.mark.parametrize("n_shards", [1, 4])
def test_engine_blocks_gather_what_lookup_gives(monkeypatch, n_shards,
                                                descending):
    """Every block `_phase3` gathers, on a YAGO store and on its four
    shards: the looked-up arrays of the same driven relation equal it."""
    ds = _dataset("yago")
    store = ds.store if n_shards == 1 else _sharded("yago")
    eng = StreakEngine(store, ExecConfig(), device="cpu")
    orig, checked = QueryCursor._phase3, []

    def phase3(self, drv_rel, uniq_ents, boxes, dvn_rel, batcher=None,
               gather=None):
        if gather is not None:
            material, rows = gather
            _same(material.entities(rows),
                  eng._driven_entities(dvn_rel, self.driven, self.plan))
            checked.append(len(rows))
        return orig(self, drv_rel, uniq_ents, boxes, dvn_rel,
                    batcher=batcher, gather=gather)

    monkeypatch.setattr(QueryCursor, "_phase3", phase3)
    for q in ds.queries:
        eng.execute(_ranked(q, descending))
    assert len(checked) >= len(ds.queries)


def _counted(fn) -> dict:
    before = dict(tracing.COUNTS)
    fn()
    return {k: tracing.COUNTS.get(k, 0) - before.get(k, 0)
            for k in ("phase3.prepare:gathered", "phase3.prepare:looked_up")}


def test_counters_and_shapes_that_differ_in_ranking(monkeypatch):
    """S-Plan blocks count as gathered and N-Plan blocks as looked up; no
    SIP means looked up. Shapes that differ only in their weights or
    direction keep materials of their own (`SideCache.material` builds one
    each and hands it back after) and answer as a fresh engine."""
    ds = _dataset("yago")
    store = ds.store
    calls = []
    orig = QueryCursor._phase3

    def phase3(self, *args, **kw):
        calls.append(kw.get("gather") is not None)
        return orig(self, *args, **kw)

    monkeypatch.setattr(QueryCursor, "_phase3", phase3)
    queries = [q for q in ds.queries
               if plan_query(store, q).driven.scan is not None]
    assert queries
    for force, use_sip, path in (("S", True, "gathered"),
                                 ("N", True, "looked_up"),
                                 ("S", False, "looked_up")):
        eng = StreakEngine(store, ExecConfig(force_plan=force,
                                             use_sip=use_sip), device="cpu")
        calls.clear()
        counts = _counted(lambda: [eng.execute(q) for q in queries])
        assert calls and counts[f"phase3.prepare:{path}"] == len(calls)
        assert sum(counts.values()) == len(calls)
        assert all(calls) == (path == "gathered")

    q = ds.queries[0]
    variants = [q, _ranked(q, q.ranking.descending, 2.0),
                _ranked(q, not q.ranking.descending)]
    shared = StreakEngine(store, ExecConfig(force_plan="S"), device="cpu")
    built = []
    orig_build = DrivenMaterial.build.__func__

    def build(cls, *args):
        built.append(orig_build(cls, *args))
        return built[-1]

    monkeypatch.setattr(DrivenMaterial, "build", classmethod(build))
    got = [shared.execute(v) for v in variants]
    assert len(built) == len(variants)
    plans = [plan_query(store, v, policy=shared.config.policy)
             for v in variants]
    mats = [shared.sides.material(p.driven, p) for p in plans]
    assert len(built) == len(variants)      # the lookups built nothing
    assert all(m is b for m, b in zip(mats, built))
    assert len({m.contrib.tobytes() for m in mats}) == len(variants)
    for v, (scores, rows, _) in zip(variants, got):
        want_scores, want_rows, _ = StreakEngine(
            store, ExecConfig(force_plan="S"), device="cpu").execute(v)
        assert scores.tobytes() == want_scores.tobytes()
        assert rows.keys() == want_rows.keys()
        for c in rows:
            np.testing.assert_array_equal(rows[c], want_rows[c])
