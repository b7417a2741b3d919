"""AdamW with f32 moments, a cosine schedule and global-norm clipping.

The port of the reference's `train/optim.py`, on trees of tensors (nested
dicts, leaves in JAX's order, `pytree.leaves`). The moments are f32; each
update is computed in f32 and cast back to the parameter's dtype, and
there is no f32 master copy: bf16 weights stay bf16, as in the reference.
`apply_updates` writes the parameters and moments in place (the reference
returns new trees and donates the old ones).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .. import pytree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def init_state(params) -> dict:
    """Zero f32 moments shaped like `params` and the step count (int32)."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = pytree.leaves(params)[0].device
    return {"m": pytree.tree_map(zeros, params),
            "v": pytree.tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def schedule(step, cfg: AdamWConfig) -> torch.Tensor:
    """Learning rate at `step` (f32): linear warmup, then cosine decay to
    `min_lr_frac` of `lr`."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of their f32 sums of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in pytree.leaves(tree)))


@torch.no_grad()
def apply_updates(params, grads, state: dict, cfg: AdamWConfig):
    """One AdamW step, in place on `params` and the moments of `state`.
    Returns (params, new state, {"grad_norm", "lr"}) as the reference
    does."""
    step = state["step"] + 1
    stepf = step.float()
    lr = schedule(stepf, cfg)
    gn = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gn, min=1e-9), max=1.0)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1 - b1 ** stepf
    bc2 = 1 - b2 ** stepf
    for p, g, m, v in zip(pytree.leaves(params), pytree.leaves(grads),
                          pytree.leaves(state["m"]),
                          pytree.leaves(state["v"]), strict=True):
        # the reference's expressions, each product rounded before its sum;
        # in place where that keeps the rounding, to hold fewer f32 copies
        g = g.float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        delta = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
        pf = p.float()
        delta.add_(cfg.weight_decay * pf)
        p.copy_(pf.sub_(lr * delta))
    return params, {"m": state["m"], "v": state["v"], "step": step}, \
        {"grad_norm": gn, "lr": lr}
