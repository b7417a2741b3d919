"""K-SDJ spatial analytics on the synthetic LGD workload: runs the
benchmark queries through STREAK and the full-scan baseline and prints plan
decisions, SIP pruning and early-termination behaviour per query (the
paper's §5 analysis, live).

    PYTHONPATH=src python -m repro_torch.launch.analytics [--n 2000] \
        [--device cpu]

Runs on CUDA unless --device says otherwise; each time ends in a device
synchronise.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..core.baselines import FullScanEngine
from ..core.executor import ExecConfig, StreakEngine
from ..data import synth_rdf
from ..device import resolve_device


def _wall_ms(fn, device: torch.device):
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, (time.perf_counter() - t0) * 1e3


def analytics(n: int = 2000, device=None) -> dict:
    """Build `make_lgd(n)` and run Q1-Q8 through a fresh `StreakEngine` and
    a `FullScanEngine` each; returns the store's sizes and one row a query
    (wall ms, plan counts, join rows, early stop, and whether both engines
    gave the same scores)."""
    device = resolve_device(device, "analytics")
    t0 = time.perf_counter()
    ds = synth_rdf.make_lgd(n_per_class=n, seed=0, block=512)
    tree = ds.store.tree
    out = dict(build_s=time.perf_counter() - t0, n_quads=ds.store.n_quads,
               n_objects=tree.n_objects, n_nodes=tree.n_nodes,
               tree_mib=tree.nbytes() / 2 ** 20,
               tree_share=tree.nbytes() / ds.raw_nbytes,
               device=(torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"), queries=[])
    for q in ds.queries:
        eng = StreakEngine(ds.store, ExecConfig(block=512), device=device)
        (scores, _, st), t_streak = _wall_ms(lambda: eng.execute(q), device)
        full = FullScanEngine(ds.store, device=device)
        (full_scores, _, _), t_full = _wall_ms(lambda: full.execute(q),
                                               device)
        out["queries"].append(dict(
            streak_ms=t_streak, fullscan_ms=t_full,
            ratio=t_full / max(t_streak, 1e-6), plan_n=st.plan_n,
            plan_s=st.plan_s, join_rows=st.driven_rows_after_sip,
            early=st.early_terminated,
            same=bool(np.array_equal(np.sort(scores),
                                     np.sort(full_scores)))))
    return out


def main(argv: list | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=2000, help="entities per class")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    r = analytics(args.n, args.device)
    print(f"built LGD-like store in {r['build_s']:.1f}s: {r['n_quads']} "
          f"quads, {r['n_objects']} spatial entities, S-QuadTree "
          f"{r['n_nodes']} nodes ({r['tree_mib']:.2f} MiB, "
          f"{r['tree_share'] * 100:.1f}% of raw) on {r['device']}\n")
    print(f"{'query':>6s} {'streak':>9s} {'fullscan':>9s} {'speedup':>8s} "
          f"{'plans(N/S)':>10s} {'join rows':>10s} {'early':>6s}")
    for qi, row in enumerate(r["queries"]):
        print(f"    Q{qi + 1} {row['streak_ms']:8.1f}ms "
              f"{row['fullscan_ms']:8.1f}ms {row['ratio']:7.1f}x "
              f"{row['plan_n']:>5d}/{row['plan_s']:<4d} "
              f"{row['join_rows']:>10d} {str(row['early']):>6s}")
    return r


if __name__ == "__main__":
    main()
