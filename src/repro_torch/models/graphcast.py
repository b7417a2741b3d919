"""GraphCast-style encoder-processor-decoder mesh GNN [arXiv:2212.12794].

The port of the reference's `models/graphcast.py`. Three stages over two
node sets (grid, mesh):
  encode : grid -> mesh along g2m edges (per-edge MLP + sum-aggregate)
  process: `n_layers` of mesh<->mesh interaction-network blocks (edge update
           MLP on [e, src, dst], node update MLP on [node, agg]), residual;
           the weights stay STACKED (L, ...), as the reference scans them,
           and the port loops over L
  decode : mesh -> grid along m2g edges + output head (n_vars)

With `cfg.remat` each processor block is recomputed in the backward pass
(`torch.utils.checkpoint`, the reference's `jax.checkpoint`) when
gradients are taken. The grid<->mesh edge sets come from the STREAK
spatial substrate (`core.squadtree.radius_join`, in `data/graphs.py`).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from .gnn import segment_sum
from .layers import dense_init


@dataclasses.dataclass(frozen=True)
class GraphCastConfig:
    """The reference's `GraphCastConfig`, field for field."""
    name: str = "graphcast"
    n_layers: int = 16
    d_hidden: int = 512
    n_vars: int = 227
    mesh_refinement: int = 6
    aggregator: str = "sum"
    dtype: str = "bfloat16"
    remat: bool = True

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def n_params(self) -> int:
        h = self.d_hidden
        enc = self.n_vars * h + 3 * h * h          # embed + g2m edge/node MLPs
        proc = self.n_layers * (3 * h * h + 2 * h * h)
        dec = 3 * h * h + h * self.n_vars
        return enc + proc + dec


_MLPS = ("g2m_edge", "g2m_node", "m2g_edge", "m2g_node")


def param_shapes(cfg: GraphCastConfig) -> dict:
    """The shape of every parameter, in the reference's nested layout."""
    h, L = cfg.d_hidden, cfg.n_layers
    return {"grid_embed": (cfg.n_vars, h),
            **{m: {"w1": (2 * h, h), "w2": (h, h)} for m in _MLPS},
            "proc_edge": {"w1": (L, 3 * h, h), "w2": (L, h, h)},
            "proc_node": {"w1": (L, 2 * h, h), "w2": (L, h, h)},
            "out_head": (h, cfg.n_vars)}


def init_params(cfg: GraphCastConfig, seed: int = 0,
                device: torch.device | str | None = None) -> dict:
    """Random normal / sqrt(fan_in) weights of `param_shapes` (the stacked
    processor weights' fan-in their second axis), drawn from a generator
    seeded with `seed` on `device` (CUDA unless given)."""
    device = resolve_device(device, "graphcast.init_params")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def weight(shape):
        return dense_init(gen, shape, in_axis=len(shape) - 2,
                          dtype=cfg.torch_dtype)

    return {k: ({kk: weight(s) for kk, s in v.items()} if isinstance(v, dict)
                else weight(v)) for k, v in param_shapes(cfg).items()}


def _mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    return F.silu(x @ p["w1"]) @ p["w2"]


def _bipartite(edge_mlp, node_mlp, src_feats, dst_feats, edges, n_dst,
               aggregator):
    src, dst = edges[0], edges[1]
    msg = _mlp(edge_mlp, torch.cat([src_feats[src], dst_feats[dst]], dim=-1))
    agg = segment_sum(msg, dst, n_dst)
    if aggregator == "mean":
        cnt = segment_sum(msg.new_ones((src.shape[0], 1)), dst, n_dst)
        agg = agg / torch.clamp(cnt, min=1.0)
    return _mlp(node_mlp, torch.cat([dst_feats, agg], dim=-1))


def _process(m, e, src, dst, n_mesh, ew1, ew2, nw1, nw2):
    """One processor block: edge update, sum into the mesh, node update."""
    e = e + _mlp({"w1": ew1, "w2": ew2}, torch.cat([e, m[src], m[dst]], -1))
    agg = segment_sum(e, dst, n_mesh)
    m = m + _mlp({"w1": nw1, "w2": nw2}, torch.cat([m, agg], dim=-1))
    return m, e


def forward(params: dict, grid_x: torch.Tensor, g2m: torch.Tensor,
            mesh_edges: torch.Tensor, m2g: torch.Tensor, n_mesh: int,
            cfg: GraphCastConfig) -> torch.Tensor:
    """grid_x (Ng, n_vars); g2m (2, E1) grid->mesh; mesh_edges (2, Em);
    m2g (2, E2) mesh->grid. Returns the next state (Ng, n_vars), f32."""
    dt = cfg.torch_dtype
    g2m, mesh_edges, m2g = g2m.long(), mesh_edges.long(), m2g.long()
    n_grid = grid_x.shape[0]
    g = grid_x.to(dt) @ params["grid_embed"]
    m0 = g.new_zeros((n_mesh, cfg.d_hidden))
    m = m0 + _bipartite(params["g2m_edge"], params["g2m_node"], g, m0, g2m,
                        n_mesh, cfg.aggregator)
    src, dst = mesh_edges[0], mesh_edges[1]
    e = g.new_zeros((src.shape[0], cfg.d_hidden))
    pe, pn = params["proc_edge"], params["proc_node"]
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        args = (m, e, src, dst, n_mesh, pe["w1"][i], pe["w2"][i],
                pn["w1"][i], pn["w2"][i])
        m, e = (checkpoint(_process, *args, use_reentrant=False) if remat
                else _process(*args))
    g = g + _bipartite(params["m2g_edge"], params["m2g_node"], m, g, m2g,
                       n_grid, cfg.aggregator)
    return (g @ params["out_head"]).float()


def mse_loss(params: dict, grid_x, target, g2m, mesh_edges, m2g, n_mesh,
             cfg: GraphCastConfig) -> torch.Tensor:
    pred = forward(params, grid_x, g2m, mesh_edges, m2g, n_mesh, cfg)
    return torch.mean((pred - target.float()) ** 2)
