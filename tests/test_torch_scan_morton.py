"""Port vs reference: `block_scan` and `morton_encode`'s plain versions on
the CPU, exactly.

Each runs through the port's wrapper on CPU tensors (`ops.block_scan`,
`ops.morton_encode`, i.e. `kernels/ref.py`) and is held equal, bit for bit,
to the reference's Pallas kernel in interpret mode, to the reference's jnp
oracle and, for Morton codes, to the host encoder `core.morton.interleave2`.
Max, integer counts, masks and bit interleaves are exact functions.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import morton
from repro.kernels import block_scan as bs
from repro.kernels import morton_kernel as mk
from repro.kernels import ref as rref
from repro_torch.kernels import ops


@pytest.mark.parametrize("nb,bsz", [(4, 128), (16, 1024), (1, 256), (3, 7)])
@pytest.mark.parametrize("theta", [-1e30, 0.5, 2.0])
def test_block_scan_matches_reference(nb, bsz, theta):
    rng = np.random.default_rng(3)
    scores = rng.normal(0.5, 0.5, size=(nb, bsz)).astype(np.float32)
    scores[0, :2] = np.float32(theta)          # ties with theta do not survive
    got = ops.block_scan(torch.from_numpy(scores), theta)
    assert [g.dtype for g in got] == [torch.float32, torch.int32, torch.uint8]
    kern = bs.block_scan(jnp.asarray(scores), theta, interpret=True)
    oracle = rref.block_scan_ref(jnp.asarray(scores), theta)
    for want in (kern, oracle):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _coords(n, seed):
    rng = np.random.default_rng(seed)
    edge = np.array([0, 0xFFFF, 0x8000, 0xFFFF, 0, 0x8000, 1], np.int32)
    cx = np.concatenate([edge, rng.integers(0, 1 << 16, n, dtype=np.int32)])
    cy = np.concatenate([edge[::-1], rng.integers(0, 1 << 16, n,
                                                  dtype=np.int32)])
    return cx, cy


@pytest.mark.parametrize("n", [100, 1024, 5000])
def test_morton_matches_reference_and_host_encoder(n):
    cx, cy = _coords(n, 4)
    got = ops.morton_encode(torch.from_numpy(cx), torch.from_numpy(cy))
    assert got.dtype == torch.int32
    got = got.numpy()
    assert (got < 0).any(), "no code with bit 31 set"
    kern = mk.morton_encode(jnp.asarray(cx), jnp.asarray(cy), interpret=True)
    oracle = rref.morton_ref(jnp.asarray(cx), jnp.asarray(cy))
    np.testing.assert_array_equal(got, np.asarray(kern))
    np.testing.assert_array_equal(got, np.asarray(oracle))
    host = morton.interleave2(cx.astype(np.int64), cy.astype(np.int64))
    np.testing.assert_array_equal(got.view(np.uint32).astype(np.uint64),
                                  host.astype(np.uint64))


def test_morton_masks_inputs_to_16_bits():
    rng = np.random.default_rng(8)
    cx = rng.integers(-(1 << 31), (1 << 31) - 1, 4096, dtype=np.int64
                      ).astype(np.int32)
    cy = rng.integers(-(1 << 31), (1 << 31) - 1, 4096, dtype=np.int64
                      ).astype(np.int32)
    got = ops.morton_encode(torch.from_numpy(cx), torch.from_numpy(cy))
    want = rref.morton_ref(jnp.asarray(cx), jnp.asarray(cy))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    low = ops.morton_encode(torch.from_numpy(cx & 0xFFFF),
                            torch.from_numpy(cy & 0xFFFF))
    assert torch.equal(got, low)
