"""Message-passing GNNs: GCN [Kipf'16] and GraphSAGE [Hamilton'17].

The port of the reference's `models/gnn.py`. Message passing is a gather
by source (`h[src]`) and a scatter by destination: the reference's
segment sum is `index_add_`, its segment max `scatter_reduce("amax",
include_self=False)` on a -inf-filled output, so that a node without
in-edges gets -inf, as the reference's segment max gives it. Graphs are
edge lists (2, E) [src, dst]; GCN's symmetric normalisation counts the
self loop in each degree (deg + 1) and weighs an edge by
rsqrt(deg[src]) * rsqrt(deg[dst]).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..device import resolve_device
from .layers import dense_init


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    """The reference's `GNNConfig`, field for field (`dropout` is kept for
    equality and, as there, not applied)."""
    name: str = "gnn"
    arch: str = "gcn"              # gcn | sage
    n_layers: int = 2
    d_in: int = 1433
    d_hidden: int = 16
    d_out: int = 7
    aggregator: str = "mean"       # mean | sum | max
    dropout: float = 0.0
    sample_sizes: tuple = (25, 10)  # GraphSAGE fanouts
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def dims(self) -> list:
        return [self.d_in] + [self.d_hidden] * (self.n_layers - 1) \
            + [self.d_out]

    def n_params(self) -> int:
        dims = self.dims()
        mult = 2 if self.arch == "sage" else 1
        return sum(mult * a * b for a, b in zip(dims[:-1], dims[1:]))


def param_shapes(cfg: GNNConfig) -> dict:
    """The shape of every parameter, in the reference's nested layout."""
    dims = cfg.dims()
    names = ("w", "w_self") if cfg.arch == "sage" else ("w",)
    return {"layers": [{n: (a, b) for n in names}
                       for a, b in zip(dims[:-1], dims[1:])]}


def init_params(cfg: GNNConfig, seed: int = 0,
                device: torch.device | str | None = None) -> dict:
    """Random normal / sqrt(fan_in) weights of `param_shapes`, drawn from a
    generator seeded with `seed` on `device` (CUDA unless given)."""
    device = resolve_device(device, "gnn.init_params")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return {"layers": [{n: dense_init(gen, s, dtype=cfg.torch_dtype)
                        for n, s in layer.items()}
                       for layer in param_shapes(cfg)["layers"]]}


def segment_sum(x: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """The sum of x's rows by segment id (n segments; an empty one is 0)."""
    return x.new_zeros((n,) + x.shape[1:]).index_add(0, seg, x)


def _aggregate(msg: torch.Tensor, dst: torch.Tensor, n: int, kind: str):
    if kind == "sum":
        return segment_sum(msg, dst, n)
    if kind == "mean":
        s = segment_sum(msg, dst, n)
        c = segment_sum(msg.new_ones((msg.shape[0], 1)), dst, n)
        return s / torch.clamp(c, min=1.0)
    if kind == "max":
        return msg.new_full((n, msg.shape[1]), -torch.inf).scatter_reduce(
            0, dst[:, None].expand_as(msg), msg, "amax", include_self=False)
    raise ValueError(kind)


def forward(params: dict, x: torch.Tensor, edges: torch.Tensor,
            cfg: GNNConfig, edge_norm: torch.Tensor | None = None
            ) -> torch.Tensor:
    """x (N, F); edges (2, E) [src, dst] -> logits (N, d_out).

    For GCN pass edge_norm = deg(src)^-1/2 * deg(dst)^-1/2 per edge, or
    None to compute it here."""
    src, dst = edges[0].long(), edges[1].long()
    n = x.shape[0]
    deg = None
    if cfg.arch == "gcn":
        # D-tilde = deg + 1 (self loop); sym norm 1/sqrt(d_i d_j) per edge
        deg = segment_sum(torch.ones_like(src, dtype=x.dtype), dst, n) + 1.0
        if edge_norm is None:
            edge_norm = torch.rsqrt(deg[src]) * torch.rsqrt(deg[dst])
    h = x
    for i, lp in enumerate(params["layers"]):
        msg = h[src]
        if cfg.arch == "gcn":
            agg = _aggregate(msg * edge_norm[:, None], dst, n, "sum")
            agg = agg + h / deg[:, None]          # the A+I self-loop term
            h = agg @ lp["w"]
        else:  # sage
            agg = _aggregate(msg, dst, n, cfg.aggregator)
            h = agg @ lp["w"] + h @ lp["w_self"]
        if i < len(params["layers"]) - 1:
            h = F.relu(h)
    return h


def nll_loss(params: dict, x, edges, labels, mask, cfg: GNNConfig,
             edge_norm=None) -> torch.Tensor:
    logits = forward(params, x, edges, cfg, edge_norm).float()
    logp = torch.log_softmax(logits, dim=-1)
    gold = torch.gather(logp, 1, labels.long()[:, None])[:, 0]
    m = mask.float()
    return -(gold * m).sum() / torch.clamp(m.sum(), min=1.0)
