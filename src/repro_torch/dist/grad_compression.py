"""Int8 gradient compression with error feedback.

The port of the reference's `dist/grad_compression.py`. Linear-scale int8
quantization cuts a cross-node gradient exchange 4x; plain quantization
biases the update, so `ef_compress` carries the quantization residual
forward (error feedback): the *accumulated* decompressed sum tracks the
accumulated true sum. `torch.round`, like `jnp.round`, rounds half to
even, so both packages give the same codes for the same f32 input.
"""
from __future__ import annotations

import torch

from .. import pytree


def compress(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """g (f32) -> (codes int8, scale f32 scalar): codes * scale ~= g."""
    scale = torch.max(torch.abs(g)) / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    codes = torch.clamp(torch.round(g / safe), -127, 127).to(torch.int8)
    return codes, scale


def decompress(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return codes.float() * scale


def ef_compress(g: torch.Tensor, err: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Error-feedback compression step: compresses g + carried error (in
    f32) and returns the new residual, what quantization lost this step,
    to be added to the next step's gradient."""
    target = g + err
    codes, scale = compress(target)
    new_err = target - decompress(codes, scale)
    return codes, scale, new_err


def init_error_state(params):
    """Zero f32 residuals shaped like the parameters (trainer hook)."""
    return pytree.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)


def tree_ef_compress_roundtrip(grads, err_state):
    """Compress + decompress every gradient leaf with error feedback: what
    a compressed exchange delivers. Returns (decompressed f32 grads, new
    error state), trees shaped like the inputs."""
    out_g, out_e = [], []
    for g, e in zip(pytree.leaves(grads), pytree.leaves(err_state),
                    strict=True):
        codes, scale, new_e = ef_compress(g, e)
        out_g.append(decompress(codes, scale))
        out_e.append(new_e)
    return pytree.unflatten(grads, out_g), pytree.unflatten(grads, out_e)
