"""`driven.indexed_share` over synthetic windows: the driven side's SIP
filters that went through the side's index, over all of them, in %; None
where the program counted no filter, as a program without the counters
does."""
import pytest

from portbench import harness

SIP = {"driven.sip:indexed": 97, "driven.sip:scanned": 3}


def _window(counts):
    return harness.Window(seconds=51.0, setup_s=20.0, latencies_ms=[80.0],
                          completed=100, program_counts=counts)


@pytest.mark.parametrize("counts,want", [
    (SIP, 97.0),
    (dict(SIP, **{"share.miss:splan": 40, "phase3.prepare:gathered": 9}),
     97.0),
    ({"driven.sip:scanned": 4}, 0.0),
    ({"driven.sip:indexed": 7}, 100.0),
    ({"share.hit:splan": 12, "h2d.copy:rank_table": 800}, None),
    ({}, None),
    (None, None),
])
def test_indexed_share_reads_indexed_over_filters(counts, want):
    got = harness.reader("driven.indexed_share")(_window(counts))
    if want is None:
        assert got is None
    else:
        assert got == pytest.approx(want)
