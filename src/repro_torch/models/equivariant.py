"""NequIP-style E(3)-equivariant interatomic potential [arXiv:2101.03164].

The port of the reference's `models/equivariant.py`. Features are direct
sums of real-spherical-harmonic irreps l <= l_max with `n_channels`
channels each. Interaction blocks:

  message m_ij = sum_{l1,l2->l3} R_{path}(|r_ij|) * CG^{l1 l2 l3} h_j^{l1} Y^{l2}(r_ij)
  update  h_i' = h_i + Linear_l( scatter_sum_j m_ij )

with a Bessel radial basis + MLP for R, and a norm gate for the l > 0
channels. The coupling tensors are real Gaunt coefficients
T[a,b,c] = ∫ Y_{l1 a} Y_{l2 b} Y_{l3 c} dΩ by exact Gauss-Legendre x
uniform-phi quadrature: `gaunt`, `allowed_paths` and `_real_sph_np` are
float64 numpy copies of the reference's, so the tensors are its own.
Neighbour lists (cutoff graphs) come from the STREAK spatial index
(`data/graphs.spatial_graph`).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from .gnn import segment_sum
from .layers import dense_init

_C1 = 0.4886025119029199
_C2 = (1.0925484305920792, 0.31539156525252005, 0.5462742152960396)
_Y00 = 0.28209479177387814


def real_sph_harm(vec: torch.Tensor, l: int) -> torch.Tensor:
    """vec (..., 3) unit vectors -> (..., 2l+1)."""
    x, y, z = vec[..., 0], vec[..., 1], vec[..., 2]
    if l == 0:
        return vec.new_full(vec.shape[:-1] + (1,), _Y00)
    if l == 1:
        return torch.stack([_C1 * y, _C1 * z, _C1 * x], dim=-1)
    if l == 2:
        c1, c2, c3 = _C2
        return torch.stack([
            c1 * x * y, c1 * y * z, c2 * (3 * z * z - 1.0),
            c1 * x * z, c3 * (x * x - y * y)], dim=-1)
    raise NotImplementedError(f"l={l}")


def _real_sph_np(vec: np.ndarray, l: int) -> np.ndarray:
    """float64 numpy twin of real_sph_harm (quadrature-grade precision)."""
    x, y, z = vec[..., 0], vec[..., 1], vec[..., 2]
    if l == 0:
        return np.full(vec.shape[:-1] + (1,), _Y00)
    if l == 1:
        return np.stack([_C1 * y, _C1 * z, _C1 * x], axis=-1)
    if l == 2:
        c1, c2, c3 = _C2
        return np.stack([
            c1 * x * y, c1 * y * z, c2 * (3 * z * z - 1.0),
            c1 * x * z, c3 * (x * x - y * y)], axis=-1)
    raise NotImplementedError(f"l={l}")


@functools.lru_cache(maxsize=None)
def gaunt(l1: int, l2: int, l3: int) -> np.ndarray:
    """Real Gaunt tensor (2l1+1, 2l2+1, 2l3+1) by exact quadrature."""
    n_theta, n_phi = 16, 33  # exact for total degree <= 2*16-1 / n_phi-1
    nodes, weights = np.polynomial.legendre.leggauss(n_theta)
    phi = np.arange(n_phi) * (2 * np.pi / n_phi)
    ct = nodes[:, None]
    st = np.sqrt(1 - ct ** 2)
    x = (st * np.cos(phi)[None, :]).ravel()
    y = (st * np.sin(phi)[None, :]).ravel()
    z = np.broadcast_to(ct, (n_theta, n_phi)).ravel()
    w = np.broadcast_to(weights[:, None] * (2 * np.pi / n_phi),
                        (n_theta, n_phi)).ravel()
    v = np.stack([x, y, z], axis=-1)
    y1 = _real_sph_np(v, l1)
    y2 = _real_sph_np(v, l2)
    y3 = _real_sph_np(v, l3)
    t = np.einsum("n,na,nb,nc->abc", w, y1, y2, y3)
    t[np.abs(t) < 1e-9] = 0.0
    nrm = np.linalg.norm(t)
    # parity-forbidden paths integrate to quadrature noise: return zeros, do
    # NOT normalize noise up to O(1)
    return (t / nrm if nrm > 1e-6 else np.zeros_like(t)).astype(np.float32)


def allowed_paths(l_max: int) -> list:
    """(l1, l2, l3) with |l1-l2| <= l3 <= l1+l2, parity-allowed, all <= l_max."""
    out = []
    for l1 in range(l_max + 1):
        for l2 in range(l_max + 1):
            for l3 in range(abs(l1 - l2), min(l1 + l2, l_max) + 1):
                if (l1 + l2 + l3) % 2 == 0:  # real Gaunt parity selection
                    out.append((l1, l2, l3))
    return out


@dataclasses.dataclass(frozen=True)
class NequIPConfig:
    """The reference's `NequIPConfig`, field for field."""
    name: str = "nequip"
    n_layers: int = 5
    n_channels: int = 32
    l_max: int = 2
    n_rbf: int = 8
    cutoff: float = 5.0
    n_species: int = 8
    radial_hidden: int = 64
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def n_params(self) -> int:
        paths = len(allowed_paths(self.l_max))
        c = self.n_channels
        radial = self.n_rbf * self.radial_hidden \
            + self.radial_hidden * paths * c
        linear = (self.l_max + 1) * c * c
        per_layer = radial + linear
        return self.n_species * c + self.n_layers * per_layer + c * 1


def bessel_basis(r: torch.Tensor, n: int, cutoff: float) -> torch.Tensor:
    """Radial Bessel basis [DimeNet] with cosine cutoff envelope."""
    r = torch.clamp(r, min=1e-9)
    freqs = torch.arange(1, n + 1, dtype=r.dtype, device=r.device) \
        * torch.pi / cutoff
    rb = (2.0 / cutoff) ** 0.5 * torch.sin(freqs * r[..., None]) \
        / r[..., None]
    env = 0.5 * (torch.cos(torch.pi * torch.clamp(r / cutoff, 0, 1)) + 1.0)
    return rb * env[..., None]


def param_shapes(cfg: NequIPConfig) -> dict:
    """The shape of every parameter, in the reference's nested layout."""
    c = cfg.n_channels
    p = len(allowed_paths(cfg.l_max))
    layer = {"radial_w1": (cfg.n_rbf, cfg.radial_hidden),
             "radial_w2": (cfg.radial_hidden, p * c),
             "mix": (cfg.l_max + 1, c, c)}
    return {"species_embed": (cfg.n_species, c),
            "layers": [dict(layer) for _ in range(cfg.n_layers)],
            "energy_head": (c, 1)}


def init_params(cfg: NequIPConfig, seed: int = 0,
                device: torch.device | str | None = None) -> dict:
    """Random normal / sqrt(fan_in) weights of `param_shapes` (`mix`'s
    fan-in its second axis), drawn from a generator seeded with `seed` on
    `device` (CUDA unless given)."""
    device = resolve_device(device, "equivariant.init_params")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    shapes = param_shapes(cfg)

    def weight(shape):
        return dense_init(gen, shape, in_axis=len(shape) - 2,
                          dtype=cfg.torch_dtype)

    return {"species_embed": weight(shapes["species_embed"]),
            "layers": [{k: weight(s) for k, s in layer.items()}
                       for layer in shapes["layers"]],
            "energy_head": weight(shapes["energy_head"])}


def forward(params: dict, species: torch.Tensor, positions: torch.Tensor,
            edges: torch.Tensor, cfg: NequIPConfig) -> torch.Tensor:
    """species (N,), positions (N, 3), edges (2, E) -> energy scalar."""
    gid = torch.zeros(species.shape[0], dtype=torch.long,
                      device=species.device)
    return forward_batched(params, species, positions, edges, gid, 1, cfg)[0]


def forward_batched(params: dict, species, positions, edges, graph_ids,
                    n_graphs: int, cfg: NequIPConfig) -> torch.Tensor:
    """Per-graph energies (n_graphs,) for a block-diagonal batch of
    molecules: the same message passing (edges never cross graphs), then
    the atom energies summed by graph id."""
    n = species.shape[0]
    src, dst = edges[0].long(), edges[1].long()
    c = cfg.n_channels
    paths = allowed_paths(cfg.l_max)
    h = {0: params["species_embed"][species.long()][:, :, None]}
    for l in range(1, cfg.l_max + 1):
        h[l] = positions.new_zeros((n, c, 2 * l + 1), dtype=cfg.torch_dtype)
    rvec = positions[dst] - positions[src]
    r = torch.sqrt(torch.sum(rvec * rvec, dim=-1) + 1e-12)
    rhat = rvec / r[:, None]
    rb = bessel_basis(r, cfg.n_rbf, cfg.cutoff)
    sh = {l: real_sph_harm(rhat, l) for l in range(cfg.l_max + 1)}
    cgs = [torch.from_numpy(gaunt(*p)).to(positions.device,
                                           cfg.torch_dtype) for p in paths]
    for lp in params["layers"]:
        rw = F.silu(rb @ lp["radial_w1"]) @ lp["radial_w2"]
        rw = rw.reshape(-1, len(paths), c)
        msg: dict = {}
        for pi, (l1, l2, l3) in enumerate(paths):
            t = torch.einsum("eca,eb,abm->ecm", h[l1][src], sh[l2], cgs[pi])
            t = t * rw[:, pi, :, None]
            msg[l3] = t if l3 not in msg else msg[l3] + t
        for l in range(cfg.l_max + 1):
            agg = segment_sum(msg[l], dst, n)
            upd = torch.einsum("ncm,cd->ndm", agg, lp["mix"][l])
            if l == 0:
                h[l] = h[l] + F.silu(upd)
            else:
                norm = torch.sqrt(torch.sum(upd * upd, dim=-1, keepdim=True)
                                  + 1e-12)
                h[l] = h[l] + upd * torch.sigmoid(norm)
    e_atom = (h[0][:, :, 0] @ params["energy_head"])[:, 0]
    return segment_sum(e_atom, graph_ids.long(), n_graphs)


def energy_loss(params: dict, species, positions, edges, target,
                cfg: NequIPConfig) -> torch.Tensor:
    e = forward(params, species, positions, edges, cfg)
    return (e - target) ** 2


def batched_energy_loss(params: dict, species, positions, edges, graph_ids,
                        targets, cfg: NequIPConfig) -> torch.Tensor:
    e = forward_batched(params, species, positions, edges, graph_ids,
                        targets.shape[0], cfg)
    return torch.mean((e - targets) ** 2)
