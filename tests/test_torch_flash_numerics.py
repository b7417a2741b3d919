"""The bf16 flash kernel's rounding, modelled in plain torch on the CPU.

`csrc/flash_attention.cu` runs bf16 attention on tensor cores: S = Q K^T
with f32 accumulation (products of bf16 values are exact in f32), an online
softmax over 64-key tiles with f32 (m, l), and P V with P split into bf16
hi = rn(P) and lo = rn(P - hi), both multiplied with the bf16 V into one
f32 accumulator; the output is rounded once to bf16. `kernel_model` repeats
those steps tile by tile. The card holds bf16 flash to one rounding step,
|got - want| <= 2^-7 |want| + 1e-3 elementwise against the plain version
(`chip_smoke.py`, `tests/test_torch_cuda.py`); here the model must stay
within that limit, while the same model with P rounded to bf16 before P V
(the textbook FA2/FA3 kernel) must exceed it at causal shapes, where the
first rows see few keys: that is why the kernel keeps P above bf16
precision. Inputs come from a numpy seed.

Also on the CPU: each kernel's nvcc flags, read without running nvcc.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, ref

RTOL, ATOL = 2 ** -7, 1e-3          # the card's bf16 flash limit
BK = 64                             # the kernel's kv tile
LOG2E = 1.4426950408889634


def _qkv(seed, b, hq, hkv, s, d):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(b, h, s, d)).astype(
        np.float32)).to(torch.bfloat16) for h in (hq, hkv, hkv)]


def kernel_model(q, k, v, causal: bool, p_mode: str = "hi_lo"):
    """The bf16 kernel's arithmetic on the CPU. p_mode "hi_lo" is the
    kernel's P (two bf16 terms), "bf16" rounds P to bf16 before P V, "f32"
    keeps P whole."""
    b, hq, s, d = q.shape
    grp = hq // k.shape[1]
    qf = q.float()
    kf = k.repeat_interleave(grp, dim=1).float()
    vf = v.repeat_interleave(grp, dim=1).float()
    scale = torch.tensor(d ** -0.5, dtype=torch.float32)
    rows = torch.arange(s)[:, None]
    m = torch.full((b, hq, s, 1), -1e30)
    l = torch.zeros((b, hq, s, 1))
    acc = torch.zeros((b, hq, s, d))
    for k0 in range(0, s, BK):
        x = (qf @ kf[:, :, k0:k0 + BK].transpose(-1, -2)) * scale
        if causal:
            cols = torch.arange(k0, min(k0 + BK, s))[None, :]
            x = x.masked_fill(cols > rows, -1e30)
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        alpha = torch.exp2((m - m_new) * LOG2E)
        p = torch.exp2(x * LOG2E - m_new * LOG2E)
        l = alpha * l + p.sum(-1, keepdim=True)
        vt = vf[:, :, k0:k0 + BK]
        if p_mode == "f32":
            pv = p @ vt
        else:
            hi = p.to(torch.bfloat16).float()
            pv = hi @ vt
            if p_mode == "hi_lo":
                pv = pv + (p - hi).to(torch.bfloat16).float() @ vt
        acc = alpha * acc + pv
        m = m_new
    return (acc / torch.where(l == 0, 1.0, l)).to(q.dtype)


def over_limit(got, want) -> float:
    """max |got - want| / (2^-7 |want| + 1e-3): at most 1 within the limit."""
    g, w = got.float(), want.float()
    return float(((g - w).abs() / (RTOL * w.abs() + ATOL)).max())


@pytest.mark.parametrize("causal", [True, False])
def test_kernel_model_within_limit_where_bf16_p_is_not(causal):
    """B=1, H=4, S=1024, D=256 (gemma-7b's head dim). A flip of one
    rounding step at a binade's bottom alone reads up to ~0.97, so only
    <= 1 is asked of the kernel's model (0.79 causal). P rounded to bf16
    fails where rows see few keys, at the causal head (2.1); averaged over
    1,024 keys (not causal) it reads 0.49, inside the limit."""
    q, k, v = _qkv(14, 1, 4, 4, 1024, 256)
    want = ref.flash_attention_ref(q, k, v, causal)
    split = kernel_model(q, k, v, causal)
    assert split.dtype == torch.bfloat16 and split.shape == q.shape
    assert over_limit(split, want) <= 1
    if causal:
        assert over_limit(kernel_model(q, k, v, causal, "bf16"), want) > 1


@pytest.mark.parametrize("hq,hkv,d", [(48, 8, 128), (32, 32, 128),
                                      (16, 1, 256), (16, 16, 256)])
@pytest.mark.parametrize("causal", [True, False])
def test_kernel_model_within_limit_over_the_sweep_heads(hq, hkv, d, causal):
    """The GQA / MHA / MQA heads of chip_smoke.py's sweep at S = 200: a
    ragged last kv tile, several tiles. The kernel's model reads 0.49-0.85
    of the limit; with P rounded to bf16, causal, 1.9-2.4."""
    q, k, v = _qkv(hq + d, 1, hq, hkv, 200, d)
    want = ref.flash_attention_ref(q, k, v, causal)
    assert over_limit(kernel_model(q, k, v, causal), want) <= 1
    if causal:
        assert over_limit(kernel_model(q, k, v, causal, "bf16"), want) > 1


def test_model_equals_plain_version_without_rounding():
    """In f32 with P kept whole, the tiled model is the plain version up to
    the order of f32 sums: it models the algorithm, not only the limit."""
    q, k, v = (x.float() for x in _qkv(3, 1, 2, 1, 256, 64))
    want = ref.flash_attention_ref(q, k, v, True)
    got = kernel_model(q, k, v, True, "f32")
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-6)


# --------------------------------------------------------------- nvcc flags --
STREAK = ("fused_topk_join", "distance_join", "bucketed_min_core",
          "tree_descend", "bloom_probe", "merge_join_ranks")


@pytest.mark.parametrize("name", STREAK + ("block_scan", "morton_encode"))
def test_exact_kernels_build_without_fma_contraction(name):
    assert "--fmad=false" in _build.nvcc_flags(name)


def test_flash_builds_with_fma_contraction_for_sm90a():
    flags = _build.nvcc_flags("flash_attention")
    assert not any(f.startswith("--fmad") for f in flags)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert flags[flags.index("-Xptxas") + 1] == "-v"


def test_build_command_carries_each_kernels_flags(monkeypatch, tmp_path):
    """The nvcc command is made, not run: the source, its flags, the
    output."""
    commands = []

    class FakePopen:
        def __init__(self, cmd, **kwargs):
            commands.append(cmd)
            self.returncode = 1

        def communicate(self):
            return "not run", None

    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", FakePopen)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "build_logs", {})
    monkeypatch.setattr(_build, "_target",
                        lambda n: tmp_path / f"{n}-test-only.so")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.build_all()
    assert len(commands) == len(_build.KERNELS)
    for cmd in commands:
        src = cmd[-1]
        name = src.rsplit("/", 1)[-1][:-3]
        assert cmd[0] == "nvcc"
        assert cmd[1:-3] == _build.nvcc_flags(name)
        assert cmd[-3] == "-o"


def test_a_kernels_flags_move_only_its_own_target(monkeypatch):
    before = {n: _build._target(n) for n in _build.KERNELS}
    symbol, argtypes, flags = _build.KERNELS["distance_join"]
    monkeypatch.setitem(_build.KERNELS, "distance_join",
                        (symbol, argtypes, [*flags, "-lineinfo"]))
    after = {n: _build._target(n) for n in _build.KERNELS}
    assert after["distance_join"] != before["distance_join"]
    assert {n: t for n, t in after.items() if n != "distance_join"} == \
        {n: t for n, t in before.items() if n != "distance_join"}
