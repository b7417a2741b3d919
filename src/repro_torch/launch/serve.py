"""Serving launcher: continuous-batching LM decode on the port.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-7b \
        [--smoke] [--requests N] [--device cpu]

The reference launcher's LM settings, for the dense and the MoE families
(`models.transformer` or `models.moe`, by the arch's family): 4 slots,
max_seq 64, prompts of 4 tokens drawn from numpy's default_rng(0), 8 new
tokens a request, random weights from seed 0. Runs on CUDA unless --device
says otherwise.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import registry
from ..device import resolve_device
from ..serve.engine import Request, ServeEngine

SLOTS, MAX_SEQ, PROMPT_LEN, MAX_NEW = 4, 64, 4, 8


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
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    tok = sum(len(r.out) for r in reqs)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    return dict(requests=n_requests, tokens=tok, seconds=dt,
                tokens_per_s=tok / dt, device=name,
                outputs=[r.out for r in reqs])


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
    r = serve_lm(cfg, args.requests, args.device)
    print(f"served {r['requests']} requests, {r['tokens']} tokens in "
          f"{r['seconds']:.2f}s ({r['tokens_per_s']:.1f} tok/s, continuous "
          f"batching over {SLOTS} slots) on {r['device']}")


if __name__ == "__main__":
    main()
