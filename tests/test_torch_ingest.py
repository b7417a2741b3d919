"""Port vs reference: GTFS-flavored stops CSV ingestion.

The twin of `tests/test_ingest.py` for the port: the port's sample is a
byte copy of the reference's; both packages parse it, classify its
columns and build the store, which must be equal field by field; parse
errors match message for message; and on the port's store every query
shape and a top-k query answer as the port's `FullScanEngine` does.
"""
import io
import pathlib

import numpy as np
import pytest

import repro_torch
from repro.data import ingest as ref_ingest
from repro_torch.core.baselines import FullScanEngine
from repro_torch.data import ingest
from test_torch_store import assert_states_equal, state_of

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF_SAMPLE = ROOT / "src" / "repro" / "data" / "samples" / "gtfs_stops.csv"


@pytest.fixture(scope="module")
def both():
    return ref_ingest.build_stops_store(str(REF_SAMPLE)), \
        ingest.build_stops_store(ingest.SAMPLE)


def test_sample_is_a_byte_copy_of_the_reference():
    assert ingest.SAMPLE.read_bytes() == REF_SAMPLE.read_bytes()
    assert len(ingest.SAMPLE.read_text().splitlines()) == 41


MALFORMED = {
    "missing": "stop_id,stop_name\nS1,A\n",
    "duplicate": "stop_id,stop_name,stop_lat,stop_lon\nS1,A,1,2\nS1,B,3,4\n",
    "unparseable": "stop_id,stop_name,stop_lat,stop_lon\nS1,A,north,2\n",
    "empty": "stop_id,stop_name,stop_lat,stop_lon\n",
    "empty_id": "stop_id,stop_name,stop_lat,stop_lon\n ,A,1,2\n",
    "no_lon": "stop_id,stop_name,stop_lat,stop_lon\nS1,A,1\n",
}


@pytest.mark.parametrize("name", sorted(MALFORMED))
def test_parse_errors_match_reference(name):
    text = MALFORMED[name]
    with pytest.raises(ValueError) as want:
        ref_ingest.parse_stops_text(text)
    with pytest.raises(ValueError) as got:
        ingest.parse_stops_text(text)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as stream:
        ingest.parse_stops_csv(io.StringIO(text))
    assert str(stream.value) == str(want.value)


def test_parsed_rows_and_columns_match_reference():
    rows = ingest.parse_stops_csv(ingest.SAMPLE)
    assert rows == ref_ingest.parse_stops_csv(str(REF_SAMPLE))
    assert ingest._classify_columns(rows) == \
        ref_ingest._classify_columns(rows)


def test_store_matches_reference_field_by_field(both):
    ref, port = both
    assert_states_equal(state_of(port.store), state_of(ref.store))
    assert port.store.dictionary.id_to_term == ref.store.dictionary.id_to_term
    assert port.store.tree.entity_to_id == ref.store.tree.entity_to_id
    assert port.ns == ref.ns
    assert (port.n_stops, port.numeric_columns, port.string_columns) == \
        (ref.n_stops, ref.numeric_columns, ref.string_columns) == \
        (40, ("zone_fare", "daily_boardings"), ("zone_id",))


def test_build_from_rows_stream_and_path_agree(both):
    _, port = both
    rows = ingest.parse_stops_csv(ingest.SAMPLE)
    with open(ingest.SAMPLE, newline="") as fh:
        from_stream = ingest.build_stops_store(fh)
    for other in (ingest.build_stops_store(rows), from_stream):
        assert_states_equal(state_of(other.store), state_of(port.store))


def test_no_numeric_column_ranks_by_row_order():
    """Without a numeric column every stop gets `hasConfidence` = its row
    order, as in the reference."""
    text = ("stop_id,stop_name,stop_lat,stop_lon,zone_id\n"
            "A,a,1.0,2.0,z1\nB,b,1.5,2.5,\nC,c,1.25,2.0,z2\n")
    got = ingest.build_stops_store(ingest.parse_stops_text(text))
    want = ref_ingest.build_stops_store(ref_ingest.parse_stops_text(text))
    assert got.numeric_columns == () and got.string_columns == ("zone_id",)
    assert_states_equal(state_of(got.store), state_of(want.store))
    assert int(got.ns["hasConfidence"]) in got.store.numeric


def _stop_patterns(ns, suffix=""):
    Var, TP = repro_torch.Var, repro_torch.TriplePattern
    s, g = Var(f"stop{suffix}"), Var(f"geo{suffix}")
    return s, g, (TP(s, ns["rdf:type"], ns["gtfs:Stop"], g=Var(f"r{suffix}")),
                  TP(s, ns["hasGeometry"], g))


def _shape_query(ns, spatial):
    s, g, pats = _stop_patterns(ns)
    select = (s,)
    if spatial.b is not None:
        s2, _, pats2 = _stop_patterns(ns, "2")
        pats, select = pats + pats2, (s, s2)
    return repro_torch.Query(select=select, patterns=pats, spatial=spatial,
                             ranking=None)


def _topk_query(ns, k=7, dist=0.01, descending=True):
    Var = repro_torch.Var
    s, g, pats = _stop_patterns(ns)
    s2, g2, pats2 = _stop_patterns(ns, "2")
    board = Var("board")
    return repro_torch.Query(
        select=(s, s2), patterns=pats + pats2 + (repro_torch.TriplePattern(
            s, ns["gtfs:daily_boardings"], board),),
        spatial=repro_torch.SpatialFilter(g, g2, dist),
        ranking=repro_torch.Ranking(((board, 1.0),), descending=descending),
        k=k)


V = repro_torch.Var
INGEST_SHAPES = {
    "range": repro_torch.SpatialFilter(
        V("geo"), None, window=(-122.42, 37.78, -122.39, 37.80)),
    "within": repro_torch.SpatialFilter(V("geo"), None, dist=0.02,
                                        center=(-122.4075, 37.7880)),
    "join": repro_torch.SpatialFilter(V("geo"), V("geo2"), dist=0.005),
    "knn": repro_torch.SpatialFilter(V("geo"), V("geo2"), knn=3),
}


@pytest.mark.parametrize("join", ["numpy", "kernel", "fused"])
@pytest.mark.parametrize("name", sorted(INGEST_SHAPES))
def test_ingested_shapes_match_full_scan(both, name, join):
    store, ns = both[1].store, both[1].ns
    q = _shape_query(ns, INGEST_SHAPES[name])
    cfg = repro_torch.ExecConfig(policy=repro_torch.BackendPolicy(
        join=join, probe="kernel", rank="kernel", descend="kernel"))
    es, erows, _ = repro_torch.StreakEngine(store, cfg, device="cpu") \
        .execute(q)
    os_, orows, _ = FullScanEngine(store, device="cpu").execute(q)
    assert len(es)
    np.testing.assert_array_equal(es, os_)
    assert sorted(erows.keys()) == sorted(orows.keys())
    for c in orows.keys():
        np.testing.assert_array_equal(erows[c], orows[c])


@pytest.mark.parametrize("join", ["numpy", "fused"])
def test_ingested_topk_matches_full_scan(both, join):
    store, ns = both[1].store, both[1].ns
    q = _topk_query(ns)
    cfg = repro_torch.ExecConfig(policy=repro_torch.BackendPolicy(join=join))
    es, _, _ = repro_torch.StreakEngine(store, cfg, device="cpu").execute(q)
    bs, _, _ = FullScanEngine(store, device="cpu").execute(q)
    np.testing.assert_array_equal(es, bs)
    assert len(es) == 7 and np.all(np.diff(es) <= 0)


def test_blank_numeric_cells_drop_from_ranking(both):
    """S038 has no daily_boardings fact: it never appears in a ranking
    over that predicate (NaN-score drop), engine == baseline."""
    store, ns = both[1].store, both[1].ns
    q = _topk_query(ns, k=10 ** 6, dist=0.5, descending=False)
    es, erows, _ = repro_torch.StreakEngine(store, device="cpu").execute(q)
    bs, _, _ = FullScanEngine(store, device="cpu").execute(q)
    np.testing.assert_array_equal(np.sort(es), np.sort(bs))
    missing = store.dictionary.term_to_id["stop:S038"]
    assert missing not in set(np.unique(erows["stop"]).tolist())


def test_coincident_stops_within_zero(both):
    """S034/S035 share coordinates; dist=0 at their f32-stored point must
    return both with exactly-zero scores (engine == oracle)."""
    store, ns = both[1].store, both[1].ns
    d = store.dictionary
    e = d.term_to_id["stop:S034"]
    prow = store.geom_rows(np.array([e], dtype=np.int64))[0]
    pt = store.geom_pool.points[store.geom_pool.offsets[prow]].astype(float)
    q = _shape_query(ns, repro_torch.SpatialFilter(
        V("geo"), None, dist=0.0, center=(pt[0], pt[1])))
    es, erows, _ = repro_torch.StreakEngine(store, device="cpu").execute(q)
    os_, _, _ = FullScanEngine(store, device="cpu").execute(q)
    np.testing.assert_array_equal(es, os_)
    got = sorted(d.lookup(int(x)) for x in np.unique(erows["stop"]))
    assert got == ["stop:S034", "stop:S035"]
    np.testing.assert_array_equal(es, np.zeros(len(es)))
