"""Port vs reference: the distance join's candidate pairs and the
per-filter Bloom probe against a bank kept on the device.

`ops.distance_join_pairs` (plain version `ref.distance_join_pairs_ref` on
the CPU) against ``np.nonzero`` of the reference's
`kernels.ops.distance_join_mask` run through the Pallas kernel in interpret
mode; the port's fused stream join, whose overflow recovery now takes those
pairs, against the reference's with a partial width small enough to
overflow; `ops.bloom_probe_any` and `BloomBank.contains_any_batch` on the
kernel route against the reference's numpy and interpret routes; and the
bank's resident copy, which `add` must drop. Pairs, verdicts and
statistics must be equal.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import charsets as rcs
from repro.core import spatial_join as rsj
from repro.kernels import ops as rops
from repro_torch.core import charsets as pcs
from repro_torch.core import spatial_join as psj
from repro_torch.kernels import ops, ref

SIZES = (1, 31, 33, 300)
PAIR_CASES = ("random", "at_a_distance", "nan_boxes", "none_pass",
              "all_pass")


def _boxes(rng, n):
    pts = rng.random((n, 2)).astype(np.float32)
    wh = rng.random((n, 2)).astype(np.float32) * 0.05
    return np.concatenate([pts, pts + wh], axis=1)


def _pair_case(m, n, case):
    """(driver, driven, dist) of one case; `at_a_distance` sets dist to a
    positive distance that the port's unfused f32 formula and the
    reference's kernel compute alike (the reference contracts a multiply-add
    and may differ by an ulp elsewhere), so that pair sits exactly at the
    limit."""
    rng = np.random.default_rng(m * 1000 + n)
    a, b = _boxes(rng, m), _boxes(rng, n)
    dist = 0.08
    if case == "nan_boxes":
        a[::3, 2] = np.nan
        b[1::4, 1] = np.nan
    elif case == "none_pass":
        dist = -1.0
    elif case == "all_pass":
        dist = 4.0
    elif case == "at_a_distance":
        port = ref.distance_join_ref(torch.from_numpy(a),
                                     torch.from_numpy(b)).numpy()
        theirs = np.asarray(rops.distance_join_matrix(a, b, interpret=True))
        same = (port == theirs) & (port > 0)
        if not same.any():
            same = port == theirs
        dist = float(port[np.nonzero(same)][0])
    return a, b, dist


@pytest.mark.parametrize("case", PAIR_CASES)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("m", SIZES)
def test_pairs_plain_matches_reference_mask(m, n, case):
    a, b, dist = _pair_case(m, n, case)
    want = np.nonzero(np.asarray(rops.distance_join_mask(
        a, b, dist, interpret=True)))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    i, j = ref.distance_join_pairs_ref(ta, tb, dist)
    assert i.dtype == j.dtype == torch.int64
    for got in ((i.numpy(), j.numpy()),
                ops.distance_join_pairs(ta, tb, dist),
                ops.distance_join_pairs(a.astype(np.float64), b, dist,
                                        device="cpu")):
        assert got[0].dtype == got[1].dtype == np.int64
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    if case == "none_pass":
        assert len(want[0]) == 0
    if case == "all_pass":
        assert len(want[0]) == m * n
    if case == "at_a_distance":
        d = ref.distance_join_ref(ta, tb).numpy()
        assert (d[want] == np.float32(dist)).any()
    if case == "nan_boxes" and m > 1:
        assert not np.isin(want[0], np.arange(0, m, 3)).any()


def test_pairs_of_empty_inputs_and_launch_counts_on_cpu():
    ops.reset_launch_counts()
    a = np.zeros((0, 4), np.float32)
    b = _boxes(np.random.default_rng(3), 5)
    for x, y in ((a, b), (b, a)):
        i, j = ops.distance_join_pairs(x, y, 1.0, device="cpu")
        assert i.shape == j.shape == (0,) and i.dtype == np.int64
    ops.distance_join_pairs(torch.from_numpy(b), torch.from_numpy(b), 1.0)
    assert all(v == 0 for v in ops.LAUNCHES.values())
    with pytest.raises(ValueError, match="need a device"):
        ops.distance_join_pairs(b, b, 1.0)
    with pytest.raises(ValueError, match=r"\(rows, 4\)"):
        ops.distance_join_pairs(b[:, :3], b, 1.0, device="cpu")


@pytest.mark.parametrize("theta", [-np.inf, 1.1])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fused_stream_join_overflow_recovery_matches_reference(seed, theta):
    """A partial width of 2 (a tuner capped at 2) overflows most rows, so
    the recovery's pairs and key bound decide most of the candidates."""
    rng = np.random.default_rng(seed)
    m, n = 40 + seed * 13, 500 + seed * 77
    a = _boxes(rng, m).astype(np.float64)
    b = _boxes(rng, n).astype(np.float64)
    dk, vk = rng.random(m), rng.random(n)
    vk[::7] = np.nan                  # no value: never a survivor
    runs = []
    for sj, dev in ((rsj, {}), (psj, {"device": "cpu"})):
        stats = sj.JoinStats()
        batches = list(sj.fused_stream_join(
            a, b, dk, vk, 0.12, k=1, theta_fn=lambda: theta, batch_cols=128,
            stats=stats, tuner=sj.KcapTuner(floor=1, ceiling=2), **dev))
        runs.append((batches, dataclasses.asdict(stats)))
    (want, want_stats), (got, got_stats) = runs
    assert got_stats == want_stats
    assert want_stats["overflow_rows"] > 0 and want_stats["candidates"] > 0
    assert len(got) == len(want)
    for (gi, gj), (wi, wj) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gj, wj)


def _banks(w, k, seed, n_filters=40):
    """A reference bank with inserted keys and the port's bank over the
    same words."""
    rng = np.random.default_rng(seed)
    bank = rcs.BloomBank.empty(n_filters, words=w, k=k)
    ins = rng.integers(-(1 << 63), 1 << 62, 150, dtype=np.int64)
    bank.add(rng.integers(0, n_filters, 150), ins)
    return bank, pcs.BloomBank(bank.bits.copy(), k), ins, rng


@pytest.mark.parametrize("n_keys", [1, 7, 300])
@pytest.mark.parametrize("k", [2, 3, 4])
@pytest.mark.parametrize("w", [8, 16, 32])
def test_bloom_probe_any_matches_reference(w, k, n_keys):
    ref_bank, port_bank, ins, rng = _banks(w, k, seed=w * 10 + k)
    n_in = min(3, n_keys // 2)       # a few members, the rest absent
    keys = np.concatenate([ins[:n_in], rng.integers(
        -(1 << 63), 1 << 62, n_keys - n_in, dtype=np.int64)])
    filters = rng.integers(0, 40, 90)          # repeats included
    prep = ref_bank.prepare(keys)
    want = ref_bank.contains_any_batch(filters, prep, backend="numpy")
    np.testing.assert_array_equal(
        ref_bank.contains_any_batch(filters, prep, backend="interpret"),
        want)
    got = ref.bloom_probe_any_ref(torch.from_numpy(port_bank.bits.view(
        np.int32)), torch.from_numpy(filters), torch.from_numpy(keys), k)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    bits = port_bank.device_bits("cpu")
    np.testing.assert_array_equal(
        ops.bloom_probe_any(bits, filters, keys, k), want)
    for backend in ("kernel", "numpy"):
        np.testing.assert_array_equal(port_bank.contains_any_batch(
            filters, port_bank.prepare(keys), backend, device="cpu"), want)
    if n_keys > 1:
        assert want.any() and not want.all()


def test_resident_bank_is_dropped_by_add():
    _, bank, _, rng = _banks(8, 3, seed=7)
    key = np.array([123456789012345], dtype=np.int64)
    prep = bank.prepare(key)
    before = ops.bloom_bank_uploads
    first = bank.contains_any_batch(np.arange(40), prep, "kernel", "cpu")
    assert ops.bloom_bank_uploads == before + 1
    bank.contains_any_batch(np.arange(40), prep, "kernel", "cpu")
    bank.contains_any_batch(np.arange(40), prep, "numpy")
    assert ops.bloom_bank_uploads == before + 1       # kept, not re-sent
    target = int(np.flatnonzero(~first)[0])
    bank.add(np.array([target]), key)
    after = bank.contains_any_batch(np.arange(40), prep, "kernel", "cpu")
    assert ops.bloom_bank_uploads == before + 2
    assert after[target] and not first[target]
    np.testing.assert_array_equal(
        after, bank.contains_any_batch(np.arange(40), prep, "numpy"))


def test_bloom_probe_any_checks_its_inputs():
    bits = torch.zeros((4, 8), dtype=torch.int32)
    keys = np.array([1, 2], dtype=np.int64)
    assert ops.bloom_probe_any(bits, np.empty(0, np.int64), keys, 3).shape \
        == (0,)
    assert not ops.bloom_probe_any(bits, np.array([0, 3]),
                                   np.empty(0, np.int64), 3).any()
    for fi in ([4], [-1]):
        with pytest.raises(ValueError, match="outside the bank"):
            ops.bloom_probe_any(bits, np.array(fi), keys, 3)
    with pytest.raises(ValueError, match="W in"):
        ops.bloom_probe_any(torch.zeros((4, 12), dtype=torch.int32),
                            np.array([0]), keys, 3)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.bloom_probe_any(bits.to("meta"), np.array([0]), keys, 3)
