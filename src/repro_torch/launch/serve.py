"""Serving launcher: continuous-batching LM decode or STREAK retrieval.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-7b \
        [--smoke] [--requests N] [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch sasrec \
        [--smoke] [--device cpu]

The reference launcher's settings. LM, for the dense and the MoE families
(`models.transformer` or `models.moe`, by the arch's family): 4 slots,
max_seq 64, prompts of 4 tokens drawn from numpy's default_rng(0), 8 new
tokens a request, random weights from seed 0. Recsys (`sasrec`): random
weights from seed 0, the item table scaled by a popularity skew
log1p(zipf(1.4) clipped to 1..1000) from default_rng(0) (trained item
norms track popularity), 8 users' states from random sequences, and
`serve.retrieval.streak_topk` (k = 10) over the norm-sorted catalog in
blocks of max(64, n_items // 16). Runs on CUDA unless --device says
otherwise.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import registry
from ..device import resolve_device
from ..models import sasrec
from ..serve import retrieval
from ..serve.engine import Request, ServeEngine

SLOTS, MAX_SEQ, PROMPT_LEN, MAX_NEW = 4, 64, 4, 8
USERS, TOP_K = 8, 10


def _device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def launcher_requests(cfg, n_requests: int) -> list:
    """The reference launcher's requests: seeded random prompts."""
    rng = np.random.default_rng(0)
    return [Request(rid=i, prompt=rng.integers(1, cfg.vocab,
                                               PROMPT_LEN).tolist(),
                    max_new=MAX_NEW) for i in range(n_requests)]


def serve_lm(cfg, n_requests: int, device=None) -> dict:
    """Serve the launcher's requests; returns the run's counts and times."""
    device = resolve_device(device, "serve_lm")
    model = registry.model_module(cfg)
    params = model.init_params(cfg, seed=0, device=device)
    eng = ServeEngine(model, params, cfg, max_batch=SLOTS,
                      max_seq=MAX_SEQ, device=device)
    reqs = launcher_requests(cfg, n_requests)
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    eng.run()
    _sync(device)
    dt = time.perf_counter() - t0
    tok = sum(len(r.out) for r in reqs)
    return dict(requests=n_requests, tokens=tok, seconds=dt,
                tokens_per_s=tok / dt, device=_device_name(device),
                outputs=[r.out for r in reqs])


def popularity_catalog(cfg, device, n_users: int = USERS):
    """The launcher's SASRec: weights from seed 0 with the item table
    scaled by the popularity skew, and `n_users` random sequences
    (B, seq_len) int32, both drawn from one default_rng(0) as the
    reference draws them."""
    params = sasrec.init_params(cfg, seed=0, device=device)
    rng = np.random.default_rng(0)
    pop = np.log1p(rng.zipf(1.4, cfg.n_items).clip(1, 1000)) \
        .astype(np.float32)
    params["item_embed"] = params["item_embed"] \
        * torch.from_numpy(pop).to(device)[:, None]
    seq = rng.integers(1, cfg.n_items, (n_users, cfg.seq_len)) \
        .astype(np.int32)
    return params, torch.from_numpy(seq).to(device)


def serve_retrieval(cfg, device=None) -> dict:
    """The launcher's STREAK retrieval: top-10 for 8 users over the
    popularity-skewed catalog; returns the run's blocks, time and answer."""
    device = resolve_device(device, "serve_retrieval")
    params, seq = popularity_catalog(cfg, device)
    with torch.no_grad():
        state = sasrec.user_state(params, seq, cfg)
        block = max(64, cfg.n_items // 16)
        items_s, order = retrieval.sort_items_by_norm(params["item_embed"],
                                                      block)
        bounds = retrieval.block_bounds(items_s, block)
        _sync(device)
        t0 = time.perf_counter()
        scores, ids, blocks_read = retrieval.streak_topk(
            state, items_s, order, bounds, k=TOP_K, block=block)
        _sync(device)
        dt = time.perf_counter() - t0
    return dict(users=USERS, items=cfg.n_items, k=TOP_K, block=block,
                blocks_read=blocks_read, n_blocks=bounds.shape[0],
                seconds=dt, device=_device_name(device), scores=scores,
                ids=ids, state=state)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True, choices=list(registry.ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args()
    arch = registry.get(args.arch)
    cfg = arch.smoke if args.smoke else arch.config
    if arch.family in ("lm", "moe"):
        r = serve_lm(cfg, args.requests, args.device)
        print(f"served {r['requests']} requests, {r['tokens']} tokens in "
              f"{r['seconds']:.2f}s ({r['tokens_per_s']:.1f} tok/s, "
              f"continuous batching over {SLOTS} slots) on {r['device']}")
    elif arch.family == "recsys":
        r = serve_retrieval(cfg, args.device)
        print(f"STREAK retrieval: top-{r['k']} for {r['users']} users over "
              f"{r['items']} items in {r['seconds']:.2f}s; early-out read "
              f"{r['blocks_read']}/{r['n_blocks']} blocks on {r['device']}")
    else:
        raise SystemExit(f"no serve path for family {arch.family}")


if __name__ == "__main__":
    main()
