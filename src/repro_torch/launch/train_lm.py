"""End-to-end LM training driver with checkpoint/restart.

    PYTHONPATH=src python -m repro_torch.launch.train_lm --preset tiny \
        --steps 60 [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.train_lm --preset 100m \
        --steps 300

The port of the reference's `examples/train_lm.py`, with its two presets:
`100m` is a ~115M-parameter GQA/SwiGLU transformer (a real-run preset),
`tiny` exercises the same code path in seconds. Training resumes from the
latest checkpoint in `<ckpt-dir>_<preset>`. Runs on CUDA unless --device
says otherwise.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from ..data.tokens import TokenStream
from ..device import resolve_device
from ..models import transformer
from ..train import loop, optim

PRESETS = {
    "tiny": dict(cfg=transformer.TransformerConfig(
        name="tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=256, vocab=512, dtype="float32", remat=False,
        loss_chunks=1), batch=8, seq=64),
    "100m": dict(cfg=transformer.TransformerConfig(
        name="lm-100m", n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
        head_dim=64, d_ff=2048, vocab=32768, dtype="float32", remat=True,
        loss_chunks=4), batch=8, seq=512),
}


def make_trainer(preset: str, device, ckpt_dir: str,
                 compress_grads: bool = False, steps: int = 60):
    """(trainer, batches) for a preset: weights from seed 0, the preset's
    `TokenStream`, the reference driver's AdamW schedule."""
    p = PRESETS[preset]
    cfg = p["cfg"]
    params = transformer.init_params(cfg, seed=0, device=device)
    stream = TokenStream(cfg.vocab, p["seq"], p["batch"], seed=0)

    def loss_fn(prm, batch):
        return transformer.lm_loss(prm, batch, cfg)

    tcfg = loop.TrainerConfig(ckpt_dir=ckpt_dir, ckpt_every=25,
                              log_every=10, compress_grads=compress_grads)
    tr = loop.Trainer(loss_fn, params, tcfg,
                      optim.AdamWConfig(lr=3e-4, warmup_steps=20,
                                        total_steps=max(steps, 100)))
    return tr, lambda s: (torch.from_numpy(stream.batch(s)).to(device),)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", choices=PRESETS, default="tiny")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device, "launch.train_lm")
    cfg = PRESETS[args.preset]["cfg"]
    print(f"{cfg.name}: {cfg.n_params()/1e6:.1f}M params")
    tr, batches = make_trainer(args.preset, device,
                               f"{args.ckpt_dir}_{args.preset}",
                               args.compress_grads, args.steps)
    if tr.maybe_restore():
        print(f"resumed from step {tr.step}")
    hist = tr.fit(batches, n_steps=args.steps)
    if hist:
        print(f"done: step {tr.step}, loss {hist[0]:.3f} -> {hist[-1]:.3f} "
              f"on {device}")
    else:
        print(f"done: already at step {tr.step}")
    return hist


if __name__ == "__main__":
    main()
