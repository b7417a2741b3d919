"""Training launcher: any registered arch through the fault-tolerant Trainer.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-7b \
        --smoke --steps 20 [--compress-grads] [--ckpt-dir DIR] [--device cpu]

The port of the reference launcher, family by family, random weights from
seed 0 throughout: LM and MoE on `TokenStream(vocab, --seq, --batch,
seed=0)` batches; the GNNs (gcn-cora, graphsage-reddit) full-graph on a
512-node power-law graph (`data.graphs.random_power_law_graph(512, 8,
seed=0)`) with features and labels from default_rng(0); SASRec on
`InteractionStream(n_items, seq_len, --batch, seed=0)` triples. AdamW
with 5 warmup steps, a checkpoint every half run (the loop resumes from
the latest one in `<ckpt-dir>_<arch>`). graphcast and nequip have no
branch, in the reference's launcher as here: they exit with a message.
`--smoke` takes the arch's reduced config; without it the full published
config is built, which only a large accelerator holds. Runs on CUDA unless
--device says otherwise.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from ..configs import registry
from ..data import graphs
from ..data.recsys import InteractionStream
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


GNN_NODES, GNN_AVG_DEGREE = 512, 8


def gnn_graph(cfg, device, n_nodes: int = GNN_NODES, edges=None) -> tuple:
    """(x, edges, labels, mask) on `device`: the launcher's graph, as the
    reference's `random_power_law_graph(512, 8, seed=0)`, or the given
    (2, E) edge list over `n_nodes` nodes; features and labels drawn from
    default_rng(0), every node in the loss."""
    rng = np.random.default_rng(0)
    if edges is None:
        edges = graphs.random_power_law_graph(n_nodes, GNN_AVG_DEGREE,
                                              seed=0)
    x = rng.normal(size=(n_nodes, cfg.d_in)).astype(np.float32)
    labels = rng.integers(0, cfg.d_out, n_nodes).astype(np.int32)
    return (torch.from_numpy(x).to(device), torch.from_numpy(edges).to(device),
            torch.from_numpy(labels).to(device),
            torch.ones(n_nodes, dtype=torch.bool, device=device))


def gnn_setup(cfg, device):
    """(params, loss_fn, batches) for a GNN config on `device`: the whole
    launcher's `gnn_graph` every step (the batch is a placeholder)."""
    from ..models import gnn
    params = gnn.init_params(cfg, seed=0, device=device)
    graph = gnn_graph(cfg, device)

    def loss_fn(p, _unused):
        return gnn.nll_loss(p, *graph, cfg)

    return params, loss_fn, lambda s: (torch.zeros((), device=device),)


def sasrec_setup(cfg, batch: int, device):
    """(params, loss_fn, batches) for a SASRec config on `device`."""
    from ..models import sasrec
    params = sasrec.init_params(cfg, seed=0, device=device)
    stream = InteractionStream(cfg.n_items, cfg.seq_len, batch, seed=0)

    def loss_fn(p, seq, pos, neg):
        return sasrec.bpr_loss(p, seq, pos, neg, cfg)

    def batches(step):
        return tuple(torch.from_numpy(x).to(device)
                     for x in stream.batch(step))

    return params, loss_fn, batches


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True, choices=list(registry.ARCHS))
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
    arch = registry.get(args.arch)
    if arch.family not in ("lm", "moe", "gnn", "recsys"):
        raise SystemExit(f"{args.arch}: the training launcher has no "
                         f"{arch.family} branch, as the reference's has none")
    device = resolve_device(args.device, "launch.train")
    cfg = arch.smoke if args.smoke else arch.config
    if arch.family == "gnn":
        params, loss_fn, batches = gnn_setup(cfg, device)
    elif arch.family == "recsys":
        params, loss_fn, batches = sasrec_setup(cfg, args.batch, device)
    else:
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
