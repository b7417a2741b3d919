"""Architecture registry: the reference's ten architectures on the port.

Each entry carries the published config (`config`, source in `source`) and
a reduced `smoke` config for the CPU tests, copied from the reference's
`configs/gemma_7b.py`, `codeqwen1_5_7b.py`, `nemotron_4_15b.py` (family
"lm"), `qwen2_moe_a2_7b.py`, `qwen3_moe_30b_a3b.py` ("moe"),
`gcn_cora.py`, `graphsage_reddit.py` ("gnn"), `graphcast_cfg.py`
("graphcast"), `nequip_cfg.py` ("nequip") and `sasrec_cfg.py` ("recsys").
`LM_SHAPES`, `GNN_SHAPES` and `RECSYS_SHAPES` are the reference's shape
sets; each arch's `shapes` is its family's set, as each reference config
module binds `SHAPES`, and `all_cells()` lists the reference's 40 (arch,
shape) cells in its order.
"""
from __future__ import annotations

import dataclasses

from ..models.equivariant import NequIPConfig
from ..models.gnn import GNNConfig
from ..models.graphcast import GraphCastConfig
from ..models.moe import MoEConfig
from ..models.sasrec import SASRecConfig
from ..models.transformer import TransformerConfig


@dataclasses.dataclass(frozen=True)
class Arch:
    family: str
    source: str
    config: object
    smoke: object

    @property
    def shapes(self) -> dict:
        """The family's shape set (each reference config's `SHAPES`)."""
        return FAMILY_SHAPES[self.family]


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
    "gcn-cora": Arch(
        family="gnn",
        source="arXiv:1609.02907 (paper): 2L d_hidden=16 mean/sym-norm agg",
        config=GNNConfig(name="gcn-cora", arch="gcn", n_layers=2, d_in=1433,
                         d_hidden=16, d_out=7, aggregator="mean"),
        smoke=GNNConfig(name="gcn-cora-smoke", arch="gcn", n_layers=2,
                        d_in=32, d_hidden=8, d_out=4, aggregator="mean")),
    "graphcast": Arch(
        family="graphcast",
        source="arXiv:2212.12794 (unverified): 16L d_hidden=512 "
               "mesh_refinement=6 sum agg, n_vars=227 "
               "(encoder-processor-decoder)",
        config=GraphCastConfig(name="graphcast", n_layers=16, d_hidden=512,
                               n_vars=227, mesh_refinement=6,
                               aggregator="sum"),
        smoke=GraphCastConfig(name="graphcast-smoke", n_layers=2,
                              d_hidden=32, n_vars=11, mesh_refinement=2,
                              aggregator="sum", dtype="float32",
                              remat=False)),
    "graphsage-reddit": Arch(
        family="gnn",
        source="arXiv:1706.02216 (paper): 2L d_hidden=128 mean agg, "
               "neighbor sampling 25-10",
        config=GNNConfig(name="graphsage-reddit", arch="sage", n_layers=2,
                         d_in=602, d_hidden=128, d_out=41,
                         aggregator="mean", sample_sizes=(25, 10)),
        smoke=GNNConfig(name="graphsage-smoke", arch="sage", n_layers=2,
                        d_in=32, d_hidden=16, d_out=4, aggregator="mean",
                        sample_sizes=(5, 3))),
    "nequip": Arch(
        family="nequip",
        source="arXiv:2101.03164 (paper): 5L channels=32 l_max=2 n_rbf=8 "
               "cutoff=5, E(3) tensor-product message passing",
        config=NequIPConfig(name="nequip", n_layers=5, n_channels=32,
                            l_max=2, n_rbf=8, cutoff=5.0),
        smoke=NequIPConfig(name="nequip-smoke", n_layers=2, n_channels=8,
                           l_max=2, n_rbf=4, cutoff=5.0)),
    "sasrec": Arch(
        family="recsys",
        source="arXiv:1808.09781 (paper): embed_dim=50 2 blocks 1 head seq "
               "50; catalog 10^6 items (retrieval_cand scores 1M "
               "candidates)",
        config=SASRecConfig(name="sasrec", n_items=1_000_000, embed_dim=50,
                            n_blocks=2, n_heads=1, seq_len=50, d_ff=50),
        smoke=SASRecConfig(name="sasrec-smoke", n_items=1000, embed_dim=16,
                           n_blocks=2, n_heads=1, seq_len=10, d_ff=16)),
}

# the reference's shape sets, bound to each arch by its family
LM_SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}

GNN_SHAPES = {
    "full_graph_sm": dict(kind="full", n_nodes=2708, n_edges=10556,
                          d_feat=1433, n_classes=7),
    "minibatch_lg": dict(kind="sampled", n_nodes=232965, n_edges=114615892,
                         batch_nodes=1024, fanout=(15, 10), d_feat=602,
                         n_classes=41),
    "ogb_products": dict(kind="full", n_nodes=2449029, n_edges=61859140,
                         d_feat=100, n_classes=47),
    "molecule": dict(kind="batched", n_nodes=30, n_edges=64, batch=128,
                     d_feat=32, n_classes=1),
}

RECSYS_SHAPES = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="bulk", batch=262144),
    "retrieval_cand": dict(kind="retrieval", batch=1, n_candidates=1_000_000),
}

FAMILY_SHAPES = {"lm": LM_SHAPES, "moe": LM_SHAPES, "gnn": GNN_SHAPES,
                 "graphcast": GNN_SHAPES, "nequip": GNN_SHAPES,
                 "recsys": RECSYS_SHAPES}


def get(arch_id: str) -> Arch:
    return ARCHS[arch_id]


def all_cells() -> list:
    """All 40 (arch, shape) cells, in the reference's order."""
    return [(arch_id, shape) for arch_id, arch in ARCHS.items()
            for shape in arch.shapes]


def model_module(cfg):
    """The model module that runs `cfg`, by the config's type:
    `models.transformer`, `moe`, `sasrec`, `gnn`, `graphcast` or
    `equivariant`."""
    from ..models import (equivariant, gnn, graphcast, moe, sasrec,
                          transformer)
    modules = {TransformerConfig: transformer, MoEConfig: moe,
               SASRecConfig: sasrec, GNNConfig: gnn,
               GraphCastConfig: graphcast, NequIPConfig: equivariant}
    return modules[type(cfg)]
