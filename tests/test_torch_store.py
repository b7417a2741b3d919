"""Port vs reference: synthetic data, store build, and the state round trip.

The port's `make_lgd` / `make_yago` / `build_store` must reproduce the
reference's stores array for array (quads, dictionary, permutation and
numeric indexes, S-QuadTree node and object arrays, Bloom words, CS
statistics, geometry pool), and `repro_torch.interop.store_from_state` over
the reference store's arrays must give the same store back.
"""
import numpy as np
import pytest

from repro.core.store import ORDERS
from repro.data import synth_rdf as ref_synth
from repro_torch.data import synth_rdf as port_synth
from repro_torch.interop import TREE_FIELDS, store_from_state


def state_of(store) -> dict:
    """The flat numpy state of a built store (either package), in the
    layout `repro_torch.interop.store_from_state` reads."""
    st = {"quads": store.quads, "geometry_predicate": store.geometry_predicate,
          "block": store.block, "num_ids": store._num_ids,
          "num_vals": store._num_vals}
    for name in ORDERS:
        st[f"index.{name}"] = store.indexes[name]
    preds = sorted(store.numeric)
    st["numeric.preds"] = np.array(preds, dtype=np.int64)
    for p in preds:
        ni = store.numeric[p]
        for c in ("values", "subjects", "objects", "facts", "block_max",
                  "block_min"):
            st[f"numeric.{p}.{c}"] = getattr(ni, c)
        st[f"numeric.{p}.block"] = ni.block
    st["cs_of_entity.keys"] = np.array(list(store.cs_of_entity), np.int64)
    st["cs_of_entity.values"] = np.array(list(store.cs_of_entity.values()),
                                         np.int64)
    cat_ids = sorted(store.cs_catalog)
    cat = [np.array(sorted(store.cs_catalog[c]), np.int64) for c in cat_ids]
    st["cs_catalog.ids"] = np.array(cat_ids, np.int64)
    st["cs_catalog.offsets"] = np.cumsum([0] + [len(c) for c in cat])
    st["cs_catalog.preds"] = (np.concatenate(cat) if cat
                              else np.empty(0, np.int64))
    st["geom_pool.points"] = store.geom_pool.points
    st["geom_pool.offsets"] = store.geom_pool.offsets
    ex_ids = sorted(store.exact_geoms)
    ex = [np.asarray(store.exact_geoms[e], np.float64).reshape(-1, 2)
          for e in ex_ids]
    st["exact_geoms.ids"] = np.array(ex_ids, np.int64)
    st["exact_geoms.offsets"] = np.cumsum([0] + [len(g) for g in ex])
    st["exact_geoms.points"] = (np.concatenate(ex) if ex
                                else np.empty((0, 2)))
    d = store.dictionary
    st["dictionary.terms"] = np.array(list(d.term_to_id))
    st["dictionary.ids"] = np.array(list(d.term_to_id.values()), np.int64)
    st["dictionary.numeric_ids"] = np.array(list(d.numeric_value), np.int64)
    st["dictionary.numeric_values"] = np.array(
        list(d.numeric_value.values()), np.float64)
    st["dictionary.next"] = d._next
    t = store.tree
    e = t.extent
    st["tree.extent"] = np.array([e.xmin, e.ymin, e.xmax, e.ymax])
    st["tree.l_max"] = t.l_max
    for f in TREE_FIELDS:
        st[f"tree.{f}"] = getattr(t, f)
    for w in ("self", "in", "out"):
        bank = getattr(t, f"bloom_{w}")
        st[f"tree.bloom_{w}.bits"] = bank.bits
        st[f"tree.bloom_{w}.k"] = bank.k
    for c in ("offsets", "cs_ids", "counts"):
        st[f"tree.cs_stats.{c}"] = getattr(t.cs_stats, c)
    return st


def assert_states_equal(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for key in want:
        g, w = np.asarray(got[key]), np.asarray(want[key])
        assert g.dtype == w.dtype, key
        np.testing.assert_array_equal(g, w, err_msg=key)


def assert_stores_equal(got, want) -> None:
    """Every array and table of two built stores is equal."""
    assert_states_equal(state_of(got), state_of(want))
    assert got.dictionary.id_to_term == want.dictionary.id_to_term
    assert got.cs_catalog == want.cs_catalog
    assert got.tree.entity_to_id == want.tree.entity_to_id
    np.testing.assert_array_equal(got.tree.level_order, want.tree.level_order)
    np.testing.assert_array_equal(got.tree.level_offsets,
                                  want.tree.level_offsets)
    for a, b in zip(got.geom_pool.planes2d() + got.geom_pool.planes3d(),
                    want.geom_pool.planes2d() + want.geom_pool.planes3d()):
        np.testing.assert_array_equal(a, b)


DATASETS = {
    "lgd": lambda m: m.make_lgd(n_per_class=200, seed=0, block=128),
    "lgd_seed3": lambda m: m.make_lgd(n_per_class=120, seed=3),
    "yago": lambda m: m.make_yago(n_places=600, seed=1, block=128),
    "scale": lambda m: m.make_scale(20_000, seed=0, block=512),
}


@pytest.fixture(scope="module", params=sorted(DATASETS))
def pair(request):
    build = DATASETS[request.param]
    return build(ref_synth), build(port_synth)


def test_port_build_matches_reference(pair):
    ref, port = pair
    assert port.ns == ref.ns
    assert port.raw_nbytes == ref.raw_nbytes
    assert_stores_equal(port.store, ref.store)


def test_port_queries_match_reference(pair):
    ref, port = pair
    assert len(port.queries) == len(ref.queries)
    for pq, rq in zip(port.queries, ref.queries):
        assert repr(pq) == repr(rq)


def test_store_from_state_round_trips(pair):
    ref, _ = pair
    state = state_of(ref.store)
    rebuilt = store_from_state(state)
    assert_stores_equal(rebuilt, ref.store)
    assert_states_equal(state_of(rebuilt), state)


def test_store_from_state_answers_like_the_port_build(pair):
    """Same state, same answers: the port's engine over the carried state
    equals the port's engine over its own build."""
    from repro_torch import BackendPolicy, ExecConfig, StreakEngine
    ref, port = pair
    cfg = ExecConfig(policy=BackendPolicy(join="fused", descend="kernel"))
    own = StreakEngine(port.store, cfg, device="cpu")
    carried = StreakEngine(store_from_state(state_of(ref.store)), cfg,
                           device="cpu")
    for q in port.queries[:3]:
        s1, r1, st1 = own.execute(q)
        s2, r2, st2 = carried.execute(q)
        np.testing.assert_array_equal(s1, s2)
        assert sorted(r1) == sorted(r2)
        for c in r1:
            np.testing.assert_array_equal(r1[c], r2[c])
        assert st1 == st2


def test_packed_elist_tier_matches_reference(pair):
    from repro.core.squadtree import PackedEList as RPacked
    from repro_torch.core.squadtree import PackedEList as PPacked
    ref, port = pair
    t = port.store.tree
    got = PPacked.encode(t.elist_offsets, t.elist_ids, t.obj_ids)
    want = RPacked.encode(ref.store.tree.elist_offsets,
                          ref.store.tree.elist_ids, ref.store.tree.obj_ids)
    for f in ("nodes", "counts", "base", "width", "bit_off", "words"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    nodes = np.arange(t.n_nodes)
    ranks, pos = got.ranks_of(nodes)
    np.testing.assert_array_equal(got.decode(ranks),
                                  want.decode(want.ranks_of(nodes)[0]))
    packed = port_synth.make_lgd(n_per_class=120, seed=3).store.tree
    intervals, explicit = packed.filter_material(np.arange(packed.n_nodes))
    packed.pack_elists()
    i2, e2 = packed.filter_material(np.arange(packed.n_nodes))
    np.testing.assert_array_equal(i2, intervals)
    np.testing.assert_array_equal(e2, explicit)
