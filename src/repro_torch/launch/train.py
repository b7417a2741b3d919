"""Training launcher: an LM or MoE arch through the fault-tolerant Trainer.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-7b \
        --smoke --steps 20 [--compress-grads] [--ckpt-dir DIR] [--device cpu]

The port of the reference launcher's LM and MoE branches: random weights
from seed 0, `TokenStream(vocab, --seq, --batch, seed=0)` batches, AdamW
with 5 warmup steps, a checkpoint every half run (the loop resumes from
the latest one in `<ckpt-dir>_<arch>`). `--smoke` takes the arch's reduced
config; without it the full published config is built, which only a
large accelerator holds. Runs on CUDA unless --device says otherwise. The
reference's GNN and recsys families are not ported yet and exit with a
message.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from ..configs import registry
from ..data.tokens import TokenStream
from ..device import resolve_device
from ..train import loop, optim


def lm_setup(cfg, batch: int, seq: int, device):
    """(params, loss_fn, batches) for a dense or MoE config on `device`."""
    model = registry.model_module(cfg)
    params = model.init_params(cfg, seed=0, device=device)
    stream = TokenStream(cfg.vocab, seq, batch, seed=0)

    def loss_fn(p, tokens):
        return model.lm_loss(p, tokens, cfg)

    def batches(step):
        return (torch.from_numpy(stream.batch(step)).to(device),)

    return params, loss_fn, batches


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True,
                    choices=list(registry.ARCHS) + list(registry.NOT_PORTED))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_launch_train"))
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    if args.arch in registry.NOT_PORTED:
        raise SystemExit(f"{args.arch}: the {registry.NOT_PORTED[args.arch]}"
                         " family is not ported yet (ROADMAP queue 1)")
    device = resolve_device(args.device, "launch.train")
    arch = registry.get(args.arch)
    cfg = arch.smoke if args.smoke else arch.config
    params, loss_fn, batches = lm_setup(cfg, args.batch, args.seq, device)
    tr = loop.Trainer(
        loss_fn, params,
        loop.TrainerConfig(ckpt_dir=f"{args.ckpt_dir}_{args.arch}",
                           ckpt_every=max(args.steps // 2, 1), log_every=5,
                           compress_grads=args.compress_grads),
        optim.AdamWConfig(warmup_steps=5, total_steps=max(args.steps, 50)))
    if tr.maybe_restore():
        print(f"resumed at step {tr.step}")
    hist = tr.fit(batches, n_steps=args.steps)
    if hist:
        print(f"{args.arch}: loss {hist[0]:.4f} -> {hist[-1]:.4f} "
              f"({tr.step} steps) on {device}")
    else:
        print(f"{args.arch}: already at step {tr.step}")
    return hist


if __name__ == "__main__":
    main()
