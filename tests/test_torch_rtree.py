"""Port vs reference: the STR R-tree, its synchronous distance join, and
the Z-order cell-list radius join, all host numpy in both packages.

The same seeded boxes and points go through `repro.core.rtree` /
`repro.core.squadtree.radius_join` and their copies in `repro_torch`;
trees level by level, candidate pairs and `SyncJoinStats` must be equal,
and the radius join must also equal brute force.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import rtree as ref_rtree
from repro.core import squadtree as ref_sq
from repro_torch.core import geometry, rtree, squadtree


def _boxes(n: int, seed: int, size: float = 0.02) -> np.ndarray:
    rng = np.random.default_rng(seed)
    lo = rng.random((n, 2))
    wh = rng.random((n, 2)) * size
    return np.concatenate([lo, lo + wh], axis=1)


def _assert_trees_equal(got, want) -> None:
    assert got.fanout == want.fanout and got.height == want.height
    np.testing.assert_array_equal(got.obj_index, want.obj_index)
    for g, w in zip(got.level_mbrs, want.level_mbrs):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got.level_children, want.level_children):
        np.testing.assert_array_equal(g, w)
    assert got.nbytes() == want.nbytes()


@pytest.mark.parametrize("fanout", [4, 16])
@pytest.mark.parametrize("n", [1, 1000])
def test_build_str_matches_reference(n, fanout):
    boxes = _boxes(n, seed=n + fanout)
    _assert_trees_equal(rtree.build_str(boxes, fanout),
                        ref_rtree.build_str(boxes, fanout))


@pytest.mark.parametrize("fanout", [4, 16])
def test_build_str_of_nothing_matches_reference(fanout):
    """n = 0: both packages return a one-level tree of no leaves. Joining
    against it raises IndexError in both: a reference-side fault, logged in
    ROADMAP.md §3 ("`sync_distance_join` against an empty R-tree raises"),
    pinned here so that the port follows the reference, not as a
    contract."""
    got = rtree.build_str(np.zeros((0, 4)), fanout)
    want = ref_rtree.build_str(np.zeros((0, 4)), fanout)
    _assert_trees_equal(got, want)
    assert got.height == 1 and len(got.obj_index) == 0
    # joining against it fails alike in both packages (no root to test)
    other = _boxes(5, seed=0)
    errors = []
    for mod, empty in ((rtree, got), (ref_rtree, want)):
        with pytest.raises(IndexError) as err:
            mod.sync_distance_join(empty, mod.build_str(other, fanout), 0.1)
        errors.append(str(err.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("fanout", [4, 16])
@pytest.mark.parametrize("na,nb", [(1, 1), (1, 1000), (1000, 700)])
@pytest.mark.parametrize("dist", [0.0, 0.01, 0.05])
def test_sync_distance_join_matches_reference(na, nb, dist, fanout):
    a, b = _boxes(na, seed=1), _boxes(nb, seed=2)
    stats, ref_stats = rtree.SyncJoinStats(), ref_rtree.SyncJoinStats()
    i, j = rtree.sync_distance_join(rtree.build_str(a, fanout),
                                    rtree.build_str(b, fanout), dist, stats)
    ri, rj = ref_rtree.sync_distance_join(ref_rtree.build_str(a, fanout),
                                          ref_rtree.build_str(b, fanout),
                                          dist, ref_stats)
    np.testing.assert_array_equal(i, ri)
    np.testing.assert_array_equal(j, rj)
    assert dataclasses.asdict(stats) == dataclasses.asdict(ref_stats)
    # and the pairs are exactly the boxes within `dist`
    d = geometry.box_min_dist(a[:, None, :], b[None, :, :])
    want = set(zip(*np.nonzero(d <= dist)))
    assert set(zip(i.tolist(), j.tolist())) == want
    assert stats.candidates == len(want)


def test_expand_matches_reference():
    rng = np.random.default_rng(5)
    counts = rng.integers(0, 4, 50)
    starts = rng.integers(0, 1000, 50)
    np.testing.assert_array_equal(rtree._expand(counts, starts),
                                  ref_rtree._expand(counts, starts))
    want = np.concatenate([np.arange(s, s + c)
                           for s, c in zip(starts, counts)])
    np.testing.assert_array_equal(rtree._expand(counts, starts), want)
    assert len(rtree._expand(np.zeros(3, np.int64), starts[:3])) == 0


def _brute(a, b, r, include_self):
    d = np.sqrt(((a[:, None, :] - b[None, :, :]) ** 2).sum(-1))
    keep = d <= r
    if not include_self and len(a) == len(b):
        np.fill_diagonal(keep, False)
    return set(zip(*np.nonzero(keep)))


# point sets: square, and a narrow anisotropic extent (100 wide, 0.5 high),
# the case where dividing the radius by the wider span drops pairs
RADIUS_CASES = {
    "square": (lambda rng: (rng.random((300, 2)) * 10,
                            rng.random((200, 2)) * 10), 0.7),
    "narrow": (lambda rng: (rng.random((400, 2)) * [100.0, 0.5],
                            rng.random((300, 2)) * [100.0, 0.5]), 0.3),
    "self": (lambda rng: ((lambda p: (p, p))(rng.random((500, 2)) * 4)),
             0.25),
}


@pytest.mark.parametrize("include_self", [True, False])
@pytest.mark.parametrize("case", sorted(RADIUS_CASES))
def test_radius_join_matches_reference_and_brute_force(case, include_self):
    make, r = RADIUS_CASES[case]
    a, b = make(np.random.default_rng(7))
    i, j = squadtree.radius_join(a, b, r, include_self=include_self)
    ri, rj = ref_sq.radius_join(a, b, r, include_self=include_self)
    np.testing.assert_array_equal(i, ri)
    np.testing.assert_array_equal(j, rj)
    assert set(zip(i.tolist(), j.tolist())) == _brute(a, b, r, include_self)
    # sorted by (i, j) and free of duplicates: the border dedupe
    key = i * len(b) + j
    assert np.all(np.diff(key) > 0)


def test_point_boxes_and_centroids():
    xy = np.random.default_rng(3).random((20, 2))
    boxes = geometry.point_boxes(xy)
    assert boxes.shape == (20, 4)
    np.testing.assert_array_equal(geometry.centroids(boxes), xy)
    from repro.core import geometry as ref_geometry
    wide = _boxes(30, seed=4)
    np.testing.assert_array_equal(geometry.centroids(wide),
                                  ref_geometry.centroids(wide))
    np.testing.assert_array_equal(boxes, ref_geometry.point_boxes(xy))
