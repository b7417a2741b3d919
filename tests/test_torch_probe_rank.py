"""Port vs reference: the Bloom probe and the merge-join rank pass.

The port's plain versions (`repro_torch.kernels.ref.bloom_probe_ref`,
`merge_join_ranks_ref`), reached through the kernel wrappers on CPU tensors,
against the reference's Pallas kernels in interpret mode and its numpy
routes, on the same numpy inputs. Both are integer functions, so every
verdict and rank must be equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import charsets as rcs
from repro.kernels import bloom_probe as bp
from repro.kernels import ops as rops
from repro_torch.core import charsets as pcs
from repro_torch.core import join as pjoin
from repro_torch.core.join import Relation
from repro_torch.kernels import ops


# ------------------------------------------------------------ bloom probe ---
def _bank_and_probes(nb, w, k, seed=2):
    """A reference bank with 200 inserted keys and `nb` probes: up to half
    of them inserted keys, the rest absent keys with the high bit set
    (negative int64) so the hi-half split is exercised."""
    rng = np.random.default_rng(seed)
    bank = rcs.BloomBank.empty(8, words=w, k=k)
    ins_keys = rng.integers(0, 1 << 62, size=200, dtype=np.int64)
    ins_f = rng.integers(0, 8, size=200, dtype=np.int64)
    bank.add(ins_f, ins_keys)
    n_in = min(200, nb // 2)
    absent = rng.integers(-(1 << 63), -1, size=nb - n_in, dtype=np.int64)
    probe_keys = np.concatenate([ins_keys[:n_in], absent])
    probe_f = np.concatenate([ins_f[:n_in],
                              rng.integers(0, 8, size=nb - n_in,
                                           dtype=np.int64)])
    return bank, probe_f, probe_keys, n_in


@pytest.mark.parametrize("nb,w,k", [(64, 8, 3), (1000, 16, 4), (2048, 8, 2),
                                    (300, 32, 1)])
def test_bloom_probe_plain_matches_pallas_and_bank(nb, w, k):
    bank, probe_f, probe_keys, n_in = _bank_and_probes(nb, w, k)
    rows = bank.bits[probe_f]
    got = ops.bloom_probe(torch.from_numpy(rows),
                          torch.from_numpy(probe_keys), k)
    assert got.dtype == torch.bool and got.shape == (nb,)
    got = got.numpy()
    np.testing.assert_array_equal(got, bank.contains(probe_f, probe_keys))
    u = probe_keys.view(np.uint64)
    lo = (u & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    hi = (u >> np.uint64(32)).astype(np.uint32).view(np.int32)
    want = np.asarray(bp.bloom_probe(jnp.asarray(rows), jnp.asarray(lo),
                                     jnp.asarray(hi), k=k, bb=256,
                                     interpret=True)) == 1
    np.testing.assert_array_equal(got, want)
    assert got[:n_in].all()             # inserted keys are always members
    # the int32 view of the words gives the same verdicts
    same = ops.bloom_probe(torch.from_numpy(rows.view(np.int32)),
                           torch.from_numpy(probe_keys), k).numpy()
    np.testing.assert_array_equal(same, got)


@pytest.mark.parametrize("w,k", [(8, 3), (16, 2), (32, 4)])
def test_contains_any_batch_kernel_route_matches_reference(w, k):
    """The Phase-1 frontier probe: the port's kernel route (plain version
    on the CPU) against the reference's numpy and kernel routes."""
    rng = np.random.default_rng(w * 10 + k)
    ref_bank = rcs.BloomBank.empty(40, words=w, k=k)
    ref_bank.add(rng.integers(0, 40, 120),
                 rng.integers(-(1 << 63), 1 << 62, 120, dtype=np.int64))
    port_bank = pcs.BloomBank(ref_bank.bits.copy(), k)
    keys = np.concatenate([rng.integers(0, 1 << 62, 5, dtype=np.int64),
                           np.array([-1, -(1 << 63)], dtype=np.int64)])
    filters = rng.integers(0, 40, 60)
    want = ref_bank.contains_any_batch(filters, ref_bank.prepare(keys),
                                       backend="numpy")
    np.testing.assert_array_equal(
        ref_bank.contains_any_batch(filters, ref_bank.prepare(keys),
                                    backend="kernel"), want)
    prep = port_bank.prepare(keys)
    for backend in ("kernel", "numpy"):
        got = port_bank.contains_any_batch(filters, prep, backend,
                                           device="cpu")
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="needs a device"):
        port_bank.contains_any_batch(filters, prep, "kernel")


def test_bloom_probe_runs_plain_on_cpu_and_refuses_other_devices():
    rows = torch.zeros((4, 12), dtype=torch.int32)
    keys = torch.zeros(4, dtype=torch.int64)
    # CPU tensors run the plain version, which takes any W
    assert not ops.bloom_probe(rows, keys, 3).any()
    with pytest.raises(ValueError, match="unsupported device"):
        ops.bloom_probe(rows.to("meta"), keys.to("meta"), 3)


# --------------------------------------------------- merge-join rank pass ---
def _rank_case(n, m, dom, seed):
    """Sorted table with duplicate runs (and negative keys), probes below,
    inside (exact hits included) and above the table."""
    rng = np.random.default_rng(seed)
    table = np.sort(np.repeat(rng.integers(-dom, dom, n).astype(np.int64),
                              rng.integers(1, 4, n))[:n])
    probes = rng.integers(-2 * dom, 2 * dom, m).astype(np.int64)
    if n and m:
        probes[: m // 3] = rng.choice(table, m // 3)
    return table, probes


@pytest.mark.parametrize("side", ["both", "left", "right"])
@pytest.mark.parametrize("n,m,dom", [(0, 5, 8), (7, 0, 8), (1, 1, 8),
                                     (129, 70, 1 << 40), (300, 45, 3),
                                     (257, 200, 1 << 62)])
def test_rank_plain_matches_reference(n, m, dom, side):
    table, probes = _rank_case(n, m, dom, seed=n + m)

    def both(out):
        return out if side == "both" else (out,)

    want = both(rops.merge_join_ranks(table, probes, backend="numpy",
                                      side=side))
    for g, w in zip(both(rops.merge_join_ranks(
            table, probes, backend="interpret", side=side)), want):
        np.testing.assert_array_equal(g, w)
    for backend, device in (("kernel", "cpu"), ("numpy", None)):
        got = both(ops.merge_join_ranks(table, probes, backend=backend,
                                        side=side, device=device))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == np.int64
            np.testing.assert_array_equal(g, w)
    # the tensor wrapper itself
    got = both(ops.insertion_ranks(torch.from_numpy(table),
                                   torch.from_numpy(probes), side))
    for g, w in zip(got, want):
        assert g.dtype == torch.int64
        np.testing.assert_array_equal(g.numpy(), w)


def test_rank_backend_registry():
    with pytest.raises(ValueError, match="needs a device"):
        ops.merge_join_ranks(np.array([1]), np.array([1]), backend="kernel")
    with pytest.raises(ValueError, match="unknown"):
        ops.merge_join_ranks(np.array([1]), np.array([1]), backend="cpu")
    with pytest.raises(ValueError, match="unknown rank side"):
        ops.insertion_ranks(torch.zeros(1, dtype=torch.int64),
                            torch.zeros(1, dtype=torch.int64), "middle")


@pytest.mark.parametrize("seed", range(4))
def test_relational_ops_equal_across_rank_backends(seed):
    """join / semijoin / filter_in_ranges with the rank pass on the kernel
    backend (plain version on the CPU) equal the numpy backend row for
    row."""
    rng = np.random.default_rng(seed)
    dom = [3, 16, 1 << 40, 1 << 60][seed]

    def rel(n, extra):
        return Relation({"x": rng.integers(0, dom, n).astype(np.int64),
                         "y": rng.integers(0, 4, n).astype(np.int64),
                         extra: rng.integers(0, 9, n).astype(np.int64)})

    a, b = rel(60, "a_only"), rel(45, "b_only")
    iv = np.sort(rng.integers(0, dom, (6, 2)), axis=1)
    ex = np.unique(rng.integers(0, dom, 9))
    for op, args in ((pjoin.join, (a, b)), (pjoin.semijoin, (a, b)),
                     (pjoin.filter_in_ranges, (a, "x", iv, ex))):
        want = op(*args, impl="merge", backend="numpy")
        got = op(*args, impl="merge", backend="kernel", device="cpu")
        assert list(got) == list(want)
        for c in want:
            np.testing.assert_array_equal(got[c], want[c])
