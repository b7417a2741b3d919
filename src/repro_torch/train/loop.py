"""Training loop: one step (loss, gradients, optional compressed exchange,
AdamW in place) + checkpoint/restart + straggler guard.

The port of the reference's `train/loop.py`. The reference jits its step
and donates the old parameters; here the step runs eagerly and
`apply_updates` writes the parameters and moments in place. `fit` keeps
the reference's recovery semantics: an injected failure or a straggler
restores the latest checkpoint and the loop goes on from its step.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time

import torch

from .. import pytree
from ..dist import grad_compression
from . import checkpoint as ckpt_lib
from . import fault, optim


@dataclasses.dataclass
class TrainerConfig:
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ckpt_every: int = 50
    keep: int = 3
    step_deadline_s: float = 0.0      # 0 = no straggler guard
    max_restarts: int = 3
    log_every: int = 10
    compress_grads: bool = False      # int8 EF compression round trip


class Trainer:
    """Trains `params` (a tree of tensors, updated in place) on
    `loss_fn(params, *batch)`. The parameters are made leaves that require
    gradients."""

    def __init__(self, loss_fn, params, cfg: TrainerConfig,
                 opt_cfg: optim.AdamWConfig | None = None):
        self.cfg = cfg
        self.opt_cfg = opt_cfg or optim.AdamWConfig()
        self.loss_fn = loss_fn
        self.params = params
        self._leaves = pytree.leaves(params)
        for p in self._leaves:
            p.requires_grad_(True)
        self.opt_state = optim.init_state(params)
        self.err_state = (grad_compression.init_error_state(params)
                          if cfg.compress_grads else None)
        self.step = 0
        self.ckpt = ckpt_lib.Checkpointer(cfg.ckpt_dir, keep=cfg.keep)
        self.history: list = []
        self.metrics: dict = {}

    # ------------------------------------------------------------------
    def train_step(self, batch) -> torch.Tensor:
        """One optimizer step on `batch` (a tuple of loss_fn's arguments
        after the parameters); returns the loss before the update. Leaves
        `self.metrics` ({"grad_norm", "lr"}) and does not advance
        `self.step` (`fit` does)."""
        loss = self.loss_fn(self.params, *batch)
        grads = pytree.unflatten(
            self.params, torch.autograd.grad(loss, self._leaves))
        if self.cfg.compress_grads:
            grads, self.err_state = \
                grad_compression.tree_ef_compress_roundtrip(grads,
                                                            self.err_state)
        _, self.opt_state, self.metrics = optim.apply_updates(
            self.params, grads, self.opt_state, self.opt_cfg)
        return loss.detach()

    def state_tree(self):
        return {"params": self.params, "opt": self.opt_state,
                "step": self.step}

    def save(self, blocking: bool = False):
        self.ckpt.save(self.step, self.state_tree(), blocking=blocking)

    def maybe_restore(self) -> bool:
        if self.ckpt.latest_step() is None:
            return False
        state, _ = self.ckpt.restore(self.state_tree())
        with torch.no_grad():
            for dst, src in zip(self._leaves, pytree.leaves(state["params"]),
                                strict=True):
                dst.copy_(src)
        self.opt_state = state["opt"]
        self.step = int(state["step"])
        return True

    # ------------------------------------------------------------------
    def fit(self, batches, n_steps: int,
            injector: fault.FailureInjector | None = None):
        """Run up to n_steps over `batches` (callable step -> batch)."""
        cfg = self.cfg

        def body():
            while self.step < n_steps:
                batch = batches(self.step)
                if injector is not None:
                    injector.check(self.step)
                t0 = time.time()
                if cfg.step_deadline_s > 0:
                    with fault.StepGuard(cfg.step_deadline_s):
                        loss = self.train_step(batch)
                else:
                    loss = self.train_step(batch)
                self.step += 1
                self.history.append(float(loss))
                if self.step % cfg.log_every == 0:
                    dt = time.time() - t0
                    print(f"step {self.step}: loss {float(loss):.4f} "
                          f"({dt*1e3:.0f} ms/step)")
                if self.step % cfg.ckpt_every == 0:
                    self.save()
            self.save(blocking=True)
            return self.history

        def restore():
            self.ckpt.wait()
            self.maybe_restore()

        return fault.run_with_recovery(
            body, restore, max_restarts=cfg.max_restarts,
            on_restart=lambda n, e: print(f"[recovery #{n}] {e}; resuming "
                                          f"from step {self.step}"))
