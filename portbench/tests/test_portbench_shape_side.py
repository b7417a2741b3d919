"""`shape.side_hit_share` over synthetic windows: the query shapes' side
lookups that found a built side, over all lookups, in %; None where the
program counted no lookup, as a program without the counters does."""
import pytest

from portbench import harness

SIDE = {"shape.side_hit:range": 95, "shape.side_hit:within": 3,
        "shape.side_built:range": 1, "shape.side_built:within": 1}


def _window(counts):
    return harness.Window(seconds=51.0, setup_s=20.0, latencies_ms=[80.0],
                          completed=100, program_counts=counts)


@pytest.mark.parametrize("counts,want", [
    (SIDE, 98.0),
    (dict(SIDE, **{"shape.rows:range": 900, "share.hit:mat": 50}), 98.0),
    ({"shape.side_built:within": 4}, 0.0),
    ({"shape.side_hit:range": 7}, 100.0),
    ({"shape.rows:range": 12, "shape.kept:range": 30}, None),
    ({}, None),
    (None, None),
])
def test_side_hit_share_reads_hits_over_lookups(counts, want):
    got = harness.reader("shape.side_hit_share")(_window(counts))
    if want is None:
        assert got is None
    else:
        assert got == pytest.approx(want)
