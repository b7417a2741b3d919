"""SASRec retrieval serving with STREAK block-wise top-k early termination.

    PYTHONPATH=src python -m repro_torch.launch.serve_topk [--device cpu]

The port of the reference's `examples/serve_topk.py`: trains a 20,000-item
SASRec for 60 steps through the `Trainer`, then serves top-10 retrieval
for 4 users two ways, the full blocked scan and STREAK's early-terminating
scan over the norm-sorted catalog (blocks of 1,024), requires the two to
agree (ids in order and scores) and prints the blocks the STREAK scan
read: the paper's N-Plan threshold test as a recsys serving feature. The
catalog is popularity-skewed (norms scaled by log1p of a zipf(1.4) draw
from default_rng(7)), as trained item norms track popularity; a
uniform-norm catalog has nothing to terminate early on. Runs on CUDA
unless --device says otherwise.
"""
from __future__ import annotations

import argparse
import tempfile

import numpy as np
import torch

from ..data.recsys import InteractionStream
from ..device import resolve_device
from ..models import sasrec
from ..serve import retrieval
from ..train import loop, optim

CONFIG = sasrec.SASRecConfig(n_items=20_000, embed_dim=32, n_blocks=2,
                             seq_len=20, d_ff=32)
BLOCK, TOP_K, USERS = 1024, 10, 4


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device, "launch.serve_topk")
    cfg = CONFIG
    params = sasrec.init_params(cfg, seed=0, device=device)
    stream = InteractionStream(cfg.n_items, cfg.seq_len, batch=64, seed=0)

    def loss_fn(p, seq, pos, neg):
        return sasrec.bpr_loss(p, seq, pos, neg, cfg)

    with tempfile.TemporaryDirectory() as ckpt_dir:
        tr = loop.Trainer(loss_fn, params,
                          loop.TrainerConfig(ckpt_dir=ckpt_dir,
                                             ckpt_every=1000, log_every=20),
                          optim.AdamWConfig(lr=1e-3, warmup_steps=10,
                                            total_steps=200,
                                            weight_decay=0.0))
        hist = tr.fit(lambda s: tuple(torch.from_numpy(x).to(device)
                                      for x in stream.batch(s)),
                      n_steps=args.steps)

    with torch.no_grad():
        rng = np.random.default_rng(7)
        popularity = torch.from_numpy(
            rng.zipf(1.4, size=cfg.n_items).clip(1, 1000)
            .astype(np.float32)).to(device)
        items = tr.params["item_embed"].detach() \
            * torch.log1p(popularity)[:, None]
        seq = torch.from_numpy(stream.batch(999)[0][:USERS]).to(device)
        state = sasrec.user_state(tr.params, seq, cfg)
        full_s, full_i = retrieval.blocked_topk(state, items, k=TOP_K,
                                                block=BLOCK)
        items_sorted, order = retrieval.sort_items_by_norm(items, BLOCK)
        bounds = retrieval.block_bounds(items_sorted, BLOCK)
        s2, i2, blocks_read = retrieval.streak_topk(
            state, items_sorted, order, bounds, k=TOP_K, block=BLOCK)
    nb = bounds.shape[0]
    print(f"catalog {cfg.n_items} items in {nb} blocks of {BLOCK}; loss "
          f"{hist[0]:.4f} -> {hist[-1]:.4f} over {len(hist)} steps")
    print(f"STREAK early-out read {blocks_read}/{nb} blocks "
          f"({blocks_read / nb * 100:.0f}%) on {device}")
    if not (torch.equal(full_i, i2) and torch.equal(full_s, s2)):
        raise SystemExit("early-out top-10 differs from the full scan's")
    print(f"exactness check: early-out top-{TOP_K} == full-scan top-{TOP_K} "
          f"for all {USERS} users")
    return dict(losses=hist, blocks_read=blocks_read, n_blocks=nb,
                scores=s2, ids=i2)


if __name__ == "__main__":
    main()
