"""Architecture registry: the LM architectures the port runs.

Each entry carries the published config (`config`, source in `source`) and
a reduced `smoke` config for the CPU tests, copied from the reference's
`configs/gemma_7b.py`, `codeqwen1_5_7b.py`, `nemotron_4_15b.py` (family
"lm") and `qwen2_moe_a2_7b.py`, `qwen3_moe_30b_a3b.py` (family "moe").
The reference's GNN and recsys architectures are not ported yet: they are
named in `NOT_PORTED` with their family.
"""
from __future__ import annotations

import dataclasses

from ..models.moe import MoEConfig
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
    "qwen2-moe-a2.7b": Arch(
        family="moe",
        source="hf:Qwen/Qwen1.5-MoE-A2.7B: 24L d_model=2048 16H (kv=16) "
               "per-expert d_ff=1408 vocab=151936, MoE 60 routed top-4 + 4 "
               "shared; experts padded 60 -> 64",
        config=MoEConfig(
            name="qwen2-moe-a2.7b", n_layers=24, d_model=2048, n_heads=16,
            n_kv_heads=16, head_dim=128, vocab=151936,
            n_experts=60, n_experts_padded=64, top_k=4, d_ff_expert=1408,
            n_shared=4, act="silu", norm="rms", rope_theta=1e6,
            dtype="bfloat16", remat=True, loss_chunks=16),
        smoke=MoEConfig(
            name="qwen2-moe-smoke", n_layers=2, d_model=64, n_heads=2,
            n_kv_heads=2, head_dim=32, vocab=256, n_experts=6,
            n_experts_padded=8, top_k=4, d_ff_expert=48, n_shared=2,
            act="silu", norm="rms", dtype="float32", remat=False)),
    "qwen3-moe-30b-a3b": Arch(
        family="moe",
        source="hf:Qwen/Qwen3-30B-A3B: 48L d_model=2048 32H (GQA kv=4) "
               "per-expert d_ff=768 vocab=151936, MoE 128 routed top-8",
        config=MoEConfig(
            name="qwen3-moe-30b-a3b", n_layers=48, d_model=2048, n_heads=32,
            n_kv_heads=4, head_dim=128, vocab=151936,
            n_experts=128, n_experts_padded=128, top_k=8, d_ff_expert=768,
            n_shared=0, act="silu", norm="rms", rope_theta=1e6,
            dtype="bfloat16", remat=True, loss_chunks=16),
        smoke=MoEConfig(
            name="qwen3-moe-smoke", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, head_dim=16, vocab=256, n_experts=8,
            n_experts_padded=8, top_k=8, d_ff_expert=32, n_shared=0,
            act="silu", norm="rms", dtype="float32", remat=False)),
}

# the reference's architectures the port does not run yet, by family
# (ROADMAP queue 1)
NOT_PORTED = {"gcn-cora": "gnn", "graphcast": "graphcast",
              "graphsage-reddit": "gnn", "nequip": "nequip",
              "sasrec": "recsys"}


def get(arch_id: str) -> Arch:
    return ARCHS[arch_id]


def model_module(cfg: TransformerConfig):
    """The model module that runs `cfg`: `models.moe` for the MoE family,
    `models.transformer` for the dense one."""
    from ..models import moe, transformer
    return moe if isinstance(cfg, MoEConfig) else transformer
