"""Shared model building blocks: norms, rotary embedding, activations, init.

The port of the reference's `models/layers.py`: the same functions with the
same arithmetic (f32 norms and rotary angles, results cast back to the
input's dtype). Random initialisation takes an explicit `torch.Generator`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + scale.float())).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def apply_norm(x, p, kind: str):
    if kind == "rms":
        return rms_norm(x, p["scale"])
    return layer_norm(x, p["scale"], p["bias"])


def init_norm(kind: str, d: int, dtype=torch.float32, device=None):
    if kind == "rms":
        return {"scale": torch.zeros((d,), dtype=dtype, device=device)}
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "gelu":
        # jax.nn.gelu defaults to the tanh approximation; F.gelu does not
        return F.gelu(x, approximate="tanh")
    if kind == "silu":
        return F.silu(x)
    if kind == "relu":
        return F.relu(x)
    if kind == "sq_relu":      # squared ReLU (Primer; Nemotron-4)
        r = F.relu(x)
        return r * r
    raise ValueError(f"unknown activation {kind}")


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4):
    """Rotary embedding, half-split. x (..., S, H, Dh); positions (..., S)."""
    dh = x.shape[-1]
    half = dh // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., :, None].float() * freq          # (..., S, half)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def shard_activations(x: torch.Tensor, batch_axes: tuple, seq_axes: tuple):
    """The reference's Megatron-SP residual-stream constraint, (B, S, D)
    with batch over `batch_axes` and sequence over `seq_axes`, held to the
    ambient mesh (`with mesh:`, launch/mesh.py) as the reference's is: no
    axes return x; axes with no ambient mesh raise `RuntimeError`; an axis
    the mesh lacks raises `ValueError`. The constraint never changes a
    value (`constrain`)."""
    if not batch_axes and not seq_axes:
        return x
    return constrain(x, tuple(batch_axes) or None, tuple(seq_axes) or None,
                     None)


def constrain(x: torch.Tensor, *spec):
    """x laid out as `PartitionSpec(*spec)` over the ambient mesh (the
    reference's `with_sharding_constraint`): no ambient mesh raises
    `RuntimeError`, an axis the mesh lacks `ValueError`. A DTensor (the dry
    run's SPMD step) is redistributed to it; a plain tensor stays on the
    model's device and comes back as it is."""
    from torch.distributed.tensor import DTensor

    from ..launch.mesh import (NamedSharding, PartitionSpec, ambient_mesh,
                               placements)
    mesh = ambient_mesh()
    if mesh is None:
        raise RuntimeError(
            "shard_activations: batch_axes/seq_axes need a mesh in context "
            "(`with mesh:`)")
    want = NamedSharding(mesh, PartitionSpec(*spec))
    if isinstance(x, DTensor):
        return x.redistribute(x.device_mesh, placements(
            want.spec, x.ndim, tuple(x.device_mesh.mesh_dim_names)))
    return x


def replicated_over(x: torch.Tensor, axis: str):
    """x with its blocks whole over mesh axis `axis`: a DTensor (the dry
    run's SPMD step) is redistributed to `Replicate()` there; a plain
    tensor comes back as it is."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor) \
            or axis not in (x.device_mesh.mesh_dim_names or ()):
        return x
    names = x.device_mesh.mesh_dim_names
    return x.redistribute(x.device_mesh, [
        Replicate() if n == axis else p for n, p in zip(names,
                                                         x.placements)])


def dense_init(gen: torch.Generator, shape, in_axis: int = 0,
               dtype=torch.float32):
    """Normal(0, 1) / sqrt(fan_in) drawn in f32 on `gen`'s device, then cast
    to `dtype`, as the reference draws and casts."""
    fan_in = shape[in_axis]
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return x.mul_(fan_in ** -0.5).to(dtype)
