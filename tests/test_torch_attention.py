"""Port vs reference: flash attention's plain version on the CPU.

`repro_torch.kernels.ref.flash_attention_ref` (what `ops.flash_attention`
runs for CPU tensors) against the reference's Pallas kernel in interpret
mode and against the reference's own oracle, on the same numpy inputs, at
the MHA / GQA / MQA x causal shapes of the reference's kernel tests.

Tolerances: the reference's own 2e-4 in f32 (tests/test_kernels.py),
where the online and the two-pass softmax sum in different orders. In bf16
one rounding step, |got - want| <= 2^-7 |want| + 1e-3, inside the
reference's 5e-2: every side computes in f32 from the same bf16 operands
and rounds its output to bf16 once.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as fa
from repro.kernels import ref as rref
from repro_torch.kernels import ops, ref

SHAPES = [
    (1, 2, 2, 128, 64),     # MHA
    (1, 4, 2, 128, 64),     # GQA group 2
    (2, 8, 1, 256, 32),     # MQA
]


def _qkv(seed, b, hq, hkv, s, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, hq, s, d)).astype(np.float32),
            rng.normal(size=(b, hkv, s, d)).astype(np.float32),
            rng.normal(size=(b, hkv, s, d)).astype(np.float32))


@pytest.mark.parametrize("b,hq,hkv,s,d", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_plain_flash_matches_reference_f32(b, hq, hkv, s, d, causal):
    q, k, v = _qkv(5, b, hq, hkv, s, d)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal)
    assert got.dtype == torch.float32 and got.shape == (b, hq, s, d)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    kern = fa.flash_attention(jq, jk, jv, causal=causal, bq=64, bk=64,
                              interpret=True)
    oracle = rref.flash_attention_ref(jq, jk, jv, causal=causal)
    for want in (kern, oracle):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_flash_matches_reference_bf16(causal):
    q, k, v = _qkv(6, 1, 4, 2, 128, 64)
    got = ref.flash_attention_ref(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
        causal=causal)
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(x, dtype=jnp.bfloat16) for x in (q, k, v))
    kern = fa.flash_attention(jq, jk, jv, causal=causal, bq=64, bk=64,
                              interpret=True)
    oracle = rref.flash_attention_ref(jq, jk, jv, causal=causal)
    for want in (kern, oracle):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, dtype=np.float32),
                                   rtol=2 ** -7, atol=1e-3)


def test_causal_first_row_attends_to_itself_only():
    q, k, v = _qkv(7, 1, 2, 1, 128, 32)
    got = ref.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=True)
    for h in range(2):
        np.testing.assert_array_equal(got[0, h, 0].numpy(), v[0, 0, 0])
