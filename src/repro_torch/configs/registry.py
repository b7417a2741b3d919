"""Architecture registry: the dense LM architectures the port runs.

Each entry carries the published config (`config`, source in `source`) and
a reduced `smoke` config for the CPU tests, copied from the reference's
`configs/gemma_7b.py`, `codeqwen1_5_7b.py` and `nemotron_4_15b.py`. The
reference's MoE, GNN and recsys architectures are not ported yet (ROADMAP).
"""
from __future__ import annotations

import dataclasses

from ..models.transformer import TransformerConfig


@dataclasses.dataclass(frozen=True)
class Arch:
    family: str
    source: str
    config: TransformerConfig
    smoke: TransformerConfig


ARCHS = {
    "nemotron-4-15b": Arch(
        family="lm",
        source="arXiv:2402.16819 (unverified): 32L d_model=6144 48H (GQA "
               "kv=8) d_ff=24576 vocab=256000, squared-ReLU (non-gated) FFN",
        config=TransformerConfig(
            name="nemotron-4-15b", n_layers=32, d_model=6144, n_heads=48,
            n_kv_heads=8, head_dim=128, d_ff=24576, vocab=256000,
            act="sq_relu", glu=False, norm="ln", rope_theta=1e4,
            dtype="bfloat16", remat=True, loss_chunks=16),
        smoke=TransformerConfig(
            name="nemotron-4-15b-smoke", n_layers=2, d_model=128, n_heads=4,
            n_kv_heads=2, head_dim=32, d_ff=512, vocab=512,
            act="sq_relu", glu=False, norm="ln", dtype="float32",
            remat=False)),
    "codeqwen1.5-7b": Arch(
        family="lm",
        source="hf:Qwen/CodeQwen1.5-7B: 32L d_model=4096 32H (kv=32 = MHA) "
               "d_ff=13440 vocab=92416, SwiGLU, RMSNorm",
        config=TransformerConfig(
            name="codeqwen1.5-7b", n_layers=32, d_model=4096, n_heads=32,
            n_kv_heads=32, head_dim=128, d_ff=13440, vocab=92416,
            act="silu", glu=True, norm="rms", rope_theta=1e6,
            dtype="bfloat16", remat=True, loss_chunks=16),
        smoke=TransformerConfig(
            name="codeqwen1.5-7b-smoke", n_layers=2, d_model=128, n_heads=4,
            n_kv_heads=4, head_dim=32, d_ff=320, vocab=512,
            act="silu", glu=True, norm="rms", dtype="float32", remat=False)),
    "gemma-7b": Arch(
        family="lm",
        source="arXiv:2403.08295; hf: 28L d_model=3072 16H (kv=16) "
               "d_ff=24576, GeGLU, head_dim=256, vocab=256000, tied",
        config=TransformerConfig(
            name="gemma-7b", n_layers=28, d_model=3072, n_heads=16,
            n_kv_heads=16, head_dim=256, d_ff=24576, vocab=256000,
            act="gelu", glu=True, norm="rms", rope_theta=1e4,
            tie_embeddings=True, dtype="bfloat16", remat=True,
            loss_chunks=16),
        smoke=TransformerConfig(
            name="gemma-7b-smoke", n_layers=2, d_model=128, n_heads=4,
            n_kv_heads=4, head_dim=64, d_ff=512, vocab=512,
            act="gelu", glu=True, norm="rms", tie_embeddings=True,
            dtype="float32", remat=False)),
}


def get(arch_id: str) -> Arch:
    return ARCHS[arch_id]
