"""The resident rank tables of the relational joins, on the CPU.

`core/join.py` keeps a copy of each cached sorted key table on the device
that a kernel rank pass runs on (`ops.device_table`), in the key-cache entry
that holds the host keys. With ``device="cpu"`` and ``rank="kernel"`` the
rank kernel's plain version runs against that copy, so the cache path runs
here: the answers must equal the reference's (`repro.core.join`) and the
numpy rank backend's over repeated driver blocks, a table must go to the
device once per relation, and a changed or evicted relation must never rank
against a stale copy.
"""
import numpy as np
import pytest

from repro.core import join as rjoin
from repro_torch.core import join as pjoin
from repro_torch.kernels import ops
from test_torch_engine import lgd_workload

DOM = 4000     # values of the join columns: blocks fall inside the scan's


def _scan(rng, n=3000):
    """A per-pattern scan: sorted by (x, y), as index scans report."""
    x = np.sort(rng.integers(0, DOM, n)).astype(np.int64)
    x[0], x[-1] = 0, DOM - 1        # every block's values fit its packing
    rel = pjoin.Relation({"x": x, "y": rng.integers(0, 5, n).astype(np.int64),
                          "v": np.arange(n, dtype=np.int64)})
    order = np.lexsort((rel["y"], rel["x"]))
    rel = rel.take(order)
    rel.sorted_by = ("x", "y")
    return rel


def _block(rng, n=200):
    return pjoin.Relation({"x": rng.integers(0, DOM, n).astype(np.int64),
                           "y": rng.integers(0, 5, n).astype(np.int64),
                           "w": rng.integers(0, 9, n).astype(np.int64)})


def _ref(rel):
    out = rjoin.Relation({k: v.copy() for k, v in rel.items()})
    out.sorted_by = getattr(rel, "sorted_by", ())
    return out


def _same(got, want):
    assert list(got) == list(want)
    for c in want:
        np.testing.assert_array_equal(got[c], want[c])


def _material(rng):
    iv = np.sort(rng.integers(0, DOM, (12, 2)), axis=1).astype(np.int64)
    ex = np.unique(rng.integers(0, DOM, 30)).astype(np.int64)
    return iv, ex


def _run(op, a, b, backend, device=None, pkg=pjoin, on=None):
    if op == "filter_in_ranges":
        iv, ex = b
        return pkg.filter_in_ranges(a, "x", iv, ex, impl="merge",
                                    backend=backend,
                                    **({"device": device} if device else {}))
    kw = {"device": device} if device else {}
    return getattr(pkg, op)(a, b, on=on, impl="merge", backend=backend, **kw)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("op", ["join", "semijoin", "filter_in_ranges"])
def test_repeated_blocks_equal_reference_and_numpy(op, seed):
    """Driver blocks against one long-lived scan, as `_join_chain` and the
    SIP filter run them: the kernel rank pass on the CPU, against the
    resident table, gives the reference's rows and the numpy backend's."""
    rng = np.random.default_rng(seed)
    scan = _scan(rng)
    ref_scan = _ref(scan)
    for _ in range(5):
        block = _block(rng)
        if op == "filter_in_ranges":
            other = ref_other = _material(rng)
        else:
            other, ref_other = scan, ref_scan
        on = None if op == "filter_in_ranges" else ["x", "y"]
        got = _run(op, block, other, "kernel", "cpu", on=on)
        want = _run(op, _ref(block), ref_other, "numpy", pkg=rjoin, on=on)
        _same(got, want)
        _same(got, _run(op, block, other, "numpy", on=on))


@pytest.fixture
def rank_calls(monkeypatch):
    """Every `ops.merge_join_ranks` call: whether it got a resident table."""
    calls = []
    inner = ops.merge_join_ranks

    def recording(*args, table_on_device=None, **kw):
        calls.append(table_on_device is not None)
        return inner(*args, table_on_device=table_on_device, **kw)

    monkeypatch.setattr(ops, "merge_join_ranks", recording)
    return calls


@pytest.mark.parametrize("op", ["join", "semijoin"])
def test_table_goes_to_the_device_once_per_relation(op, rank_calls):
    """The first join caches the scan's keys and uploads them; every later
    driver block (join or semijoin) ranks against that one copy."""
    rng = np.random.default_rng(7)
    scan = _scan(rng)
    before = ops.rank_table_uploads
    _run("join", _block(rng), scan, "kernel", "cpu", on=["x", "y"])
    for _ in range(6):
        _run(op, _block(rng), scan, "kernel", "cpu", on=["x", "y"])
    assert rank_calls == [True] * 7
    assert ops.rank_table_uploads - before == 1
    ent = scan._keycache[("x", "y")]
    cpu = pjoin.torch.device("cpu")
    assert list(ent[4]) == [cpu]
    np.testing.assert_array_equal(ent[4][cpu].numpy(), ent[2])
    # the numpy backend never makes a resident copy
    other = _scan(rng)
    for _ in range(3):
        _run("join", _block(rng), other, "numpy", on=["x", "y"])
    assert ops.rank_table_uploads - before == 1
    assert other._keycache[("x", "y")][4] == {}


def test_tables_built_per_call_are_not_kept(rank_calls):
    """The SIP filter's interval starts and E-list, and a semijoin's table
    with nothing cached, go up with their probes on every call."""
    rng = np.random.default_rng(9)
    scan = _scan(rng)
    before = ops.rank_table_uploads
    pjoin.filter_in_ranges(scan, "x", *_material(rng), impl="merge",
                           backend="kernel", device="cpu")
    pjoin.semijoin(_block(rng), scan, on=["x", "y"], impl="merge",
                   backend="kernel", device="cpu")
    assert rank_calls == [False, False, False]
    assert ops.rank_table_uploads == before


def test_changed_relation_never_ranks_against_a_stale_table():
    rng = np.random.default_rng(11)
    scan = _scan(rng)
    blocks = [_block(rng) for _ in range(3)]
    for blk in blocks:
        pjoin.join(blk, scan, on=["x", "y"], impl="merge", backend="kernel",
                   device="cpu")
    before = ops.rank_table_uploads
    # same length, other values: a stale table would give other rows
    scan["x"] = np.sort(rng.integers(0, DOM, scan.n)).astype(np.int64)
    assert not getattr(scan, "_keycache", None)
    for blk in blocks:
        got = pjoin.join(blk, scan, on=["x", "y"], impl="merge",
                         backend="kernel", device="cpu")
        _same(got, pjoin.join(blk, scan, on=["x", "y"], impl="merge",
                              backend="numpy"))
        _same(got, rjoin.join(_ref(blk), _ref(scan), on=["x", "y"],
                              impl="merge", backend="numpy"))
    assert ops.rank_table_uploads - before == 1


def test_evicted_entry_takes_its_resident_copy_along(monkeypatch):
    """Entry budget: an evicted entry's copy goes with it, and ranking on
    that `on` again uploads anew, never reusing the old copy."""
    monkeypatch.setattr(pjoin, "KEYCACHE_MAX_ENTRIES", 1)
    rng = np.random.default_rng(13)
    scan = _scan(rng)
    blk = _block(rng)
    before = ops.rank_table_uploads
    pjoin.join(blk, scan, on=["x", "y"], impl="merge", backend="kernel",
               device="cpu")
    old = scan._keycache[("x", "y")][4][pjoin.torch.device("cpu")]
    pjoin.join(blk, scan, on=["x"], impl="merge", backend="kernel",
               device="cpu")
    assert list(scan._keycache) == [("x",)]
    got = pjoin.join(blk, scan, on=["x", "y"], impl="merge",
                     backend="kernel", device="cpu")
    assert ops.rank_table_uploads - before == 3
    new = scan._keycache[("x", "y")][4][pjoin.torch.device("cpu")]
    assert new is not old
    _same(got, rjoin.join(_ref(blk), _ref(scan), on=["x", "y"],
                          impl="merge", backend="numpy"))


def test_resident_bytes_count_under_the_byte_budget(monkeypatch):
    """Two entries fit the byte budget with their host keys and perms;
    the resident copy of the newer one pushes the older one out."""
    rng = np.random.default_rng(17)
    scan = _scan(rng)
    blk = _block(rng)
    per_entry = scan.n * 8 * 2          # keys + perm
    monkeypatch.setattr(pjoin, "KEYCACHE_MAX_BYTES",
                        2 * per_entry + scan.n * 8 - 8)
    pjoin.join(blk, scan, on=["x"], impl="merge", backend="numpy")
    pjoin.join(blk, scan, on=["x", "y"], impl="merge", backend="numpy")
    assert list(scan._keycache) == [("x",), ("x", "y")]
    pjoin.join(blk, scan, on=["x", "y"], impl="merge", backend="kernel",
               device="cpu")
    assert list(scan._keycache) == [("x", "y")]
    assert pjoin._cache_nbytes(scan._keycache[("x", "y")]) == 3 * scan.n * 8


def test_merge_join_ranks_takes_the_resident_table():
    rng = np.random.default_rng(19)
    table = np.sort(rng.integers(-50, 50, 400)).astype(np.int64)
    probes = rng.integers(-60, 60, 90).astype(np.int64)
    resident = ops.device_table(table, "cpu")
    for side in ("both", "left", "right"):
        got = ops.merge_join_ranks(table, probes, "kernel", side, "cpu",
                                   table_on_device=resident)
        want = ops.merge_join_ranks(table, probes, "numpy", side)
        for g, w in zip(got if side == "both" else [got],
                        want if side == "both" else [want]):
            assert g.dtype == np.int64
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="resident table"):
        ops.merge_join_ranks(table[:-1], probes, "kernel", "both", "cpu",
                             table_on_device=resident)


@pytest.fixture(scope="module")
def lgd():
    return lgd_workload()


@pytest.mark.parametrize("qi", range(8))
@pytest.mark.parametrize("join", ["kernel", "numpy"])
def test_lgd_rank_kernel_matches_reference(lgd, join, qi):
    """make_lgd(n_per_class=200, seed=0) Q1-Q8 with the rank pass (and the
    Bloom probes) on their kernel backends, under the joins that
    `test_torch_engine_probe_rank` does not run that way."""
    lgd.check(join, "kernel", qi, "build", probe_rank="kernel")
