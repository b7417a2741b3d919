#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA GPU.

    python3 chip_smoke.py [--out report.json]

Needs one CUDA device, the CUDA toolkit (nvcc) and this checkout's `src/`.
In order it:

1. prints the card's name and power limit (nvidia-smi);
2. builds the nine CUDA kernels of `src/repro_torch/csrc/` and prints the
   build time and each kernel's ptxas register and shared-memory use; for
   each flash instantiation (dtype, head dim) its registers, spills,
   shared memory and the tensor-core instructions in its SASS (cuobjdump),
   failing on a spill or on a bf16 instantiation without them; then,
   before any profiler session (once torch.profiler has traced the card,
   every CUDA call of the process costs more on the host), times the
   engine's rank call (numpy in and out) against numpy's search, the
   engine's pair call and Bloom probe at the main path's median and largest
   inputs (recorded in one pass of each set with the matrix join) against
   the routes they replaced, and LGD Q1-Q8 with the Bloom probes and the
   rank pass on numpy and on their kernels, then both query sets with the
   rank pass alone, in turns; then the multi-tenant serving loop on the
   LGD data ("serve" lines): the reference benchmark's traffic
   (benchmarks/bench_serve.py, eight tenants on eight slots, k in 5-120;
   `hotq` Q1 eight times, `mixed` Q1-Q8) under the fused join (kcap
   "auto") and the matrix join, a batch through a fresh
   `SpatialServeEngine` against `serial_perquery` (a fresh engine a
   query) and `serial_warm` (one warmed engine), in turns, medians, every
   request equal to serial execution; then the paper's baseline engines
   ("baseline turns": the full scan, the sync R-tree engine and both fixed
   plans beside STREAK on LGD Q1-Q8, the full scan and STREAK on the YAGO
   queries, three turns, per-query medians and the full scan's over
   STREAK's, Fig. 10's shape);
3. holds each kernel against its plain torch version on the card, at the
   shapes the main path gives it: bit-identical output for the STREAK
   kernels (the rank kernel in both of its layouts, at the main path's
   median and largest call shapes, at ~1M keys and on edge tables; the
   distance join as a matrix and as candidate pairs, with a pair at d ==
   dist, NaN boxes, none passing and all passing past the pair buffer,
   which must run the call again once; the Bloom probe per row and per
   filter, and a bank probed, added to and probed again),
   `block_scan` and `morton_encode`, the reference's tolerances
   (f32 2e-4, bf16 5e-2) for `flash_attention` (gemma-7b's prefill shape
   and a sweep of GQA/MHA/MQA heads, dtypes, masks and lengths); times
   both per call with CUDA events (`ms`, `plain_ms`: the wrapper's host
   overhead included), the kernel alone from a torch.profiler trace
   (`device_ms`), one PyTorch call computing the same function where
   there is one (`library_ms`, its device time), the kernel alone from
   CUDA events around calls queued back to back (`event_ms`, never empty
   where a trace misses a kernel), and computes the kernel's bound (bytes
   over the memory rate or operations over the f32 or bf16 rate, the
   larger);
4. drives the main path — `StreakEngine.execute` on `device="cuda"`, top-k
   spatial distance joins over `make_lgd(n_per_class=6000)` (Q1-Q8) and
   `make_scale(1_000_000)` (Q1-Q2) with the fused Phase-3 join, then both
   with the matrix join, under the accelerator policy (every stage on its
   kernel) — with the launch counts set to 0 just before and read just
   after, requires every STREAK kernel to have launched, and requires
   every answer, plan log and statistic to equal a `device="cpu"` run;
   runs the YAGO queries (`make_yago(600)`, Q1-Q8) the same way; requires
   one refinement launch for each refinement call, and that every
   distance-join and Bloom launch was a pair call (matrix join and overflow
   recovery) or a per-filter probe; records the (N, M) of every rank
   launch and the inputs of every `tree_descend`, `fused_topk_join`,
   grouped `bucketed_min_core`, pair call and per-filter probe, then holds
   each against its plain version at each of those inputs, times
   `tree_descend` at each tree's median one, and the others at every one
   ("case" lines per query set: launches, summed device ms from CUDA
   events and from a trace, summed bound, the median launch); prints the
   uploads of each store's Bloom banks (at most one each in the run);
5. drives the second entry point the same way: the Geographica shapes
   over the LGD data, spatial join and kNN under both joins, range and
   within (which never reach the Phase-3 join) under one, each equal to its
   `device="cpu"` run, every STREAK kernel launched;
6. drives the third entry point, the serving loop, over the same traffic
   with the counts set to 0 before and read after: every STREAK kernel
   launched, no fault counter above 0 and no request with an error, each
   batch equal request by request and counter by counter to the same
   batch on the CPU and each request to serial CUDA execution, the mixed
   fused batch pooled (a launch with two or more query ids, more SIP rows
   than SIP calls); every recorded `fused_topk_join`, `tree_descend`, pair
   call and per-filter probe of those batches replayed bit for bit
   against its plain version ("case" lines with `"path": "serve"`), the
   fused launches' rows, columns, qids and splits, then one traced batch
   of each ("serve trace": device busy, idle share, launches a step,
   memcpy);
7. drives the main path over Morton-prefix sharded stores (`shard_store`:
   lgd at S = 2, 4, 8 with Q1-Q8, scale1m at S = 4 with Q1-Q2, both joins,
   the accelerator policy) with the counts set to 0 before and read after:
   every STREAK kernel launched, every `tree_descend` launch one
   `ops.tree_descend_sharded` call (one launch over all shards), rows,
   scores and order equal to the unsharded card run's, lgd at S = 4 equal
   to its CPU run in full, each shard tree's Bloom banks uploaded at most
   once; then the serving loop's hotq and mixed traffic on the lgd S = 4
   store, each request equal to serial execution; every recorded sharded
   descent replayed bit for bit against its plain version ("case" lines
   with a "sharded" path: launches, event and trace ms, bound); then the
   multi-device layer ("mesh" lines, launch/mesh.py): both sharded
   retrievals over sasrec's 10^6 x 50 catalog (16 blocks of 62,500) at
   B = 1 and 512, k = 100, laid out P("model") over a 4-entry mesh on the
   card (and over `make_host_mesh(1, n)` with n >= 2 cards), ids and
   scores equal to the unsharded scans', blocks read and ms; lgd at S = 8
   through `make_shard_mesh(8)` (every card) and through a 4-position mesh
   on the card, counts set to 0 before and read after: one `tree_descend`
   launch a mesh position a descent, masks equal to the plain version's
   and, over several positions, to the single launch's, answers equal to
   the unsharded run's, events ms; and
   `device_put` -> `shrink_mesh` -> `reshard_tree` of a (12, 4) tensor
   over a data-4 mesh, reassembled bit-equal;
8. the failover layer ("failover" lines): lgd Q1 with each of the seven
   chained ops failed once and corrupted, answering as the clean run with
   the plain attempt counted; a delay past an armed watchdog; three
   exhausted chains opening a breaker that demotes the stage at a
   `resolve()` under the plan and at none once the plan is gone; launch
   errors, more than open the kernel's breaker, each propagating with no
   plain attempt and no demotion.
   Every other phase ends by requiring the fault layer clean: no plan, no
   watchdog, every `FaultStats` counter 0, no fallback launch counted;
9. drives the baseline engines (core/baselines.py), the ingested GTFS
   sample, the differential fuzzer and the analytics launcher, each with
   the counts set to 0 before and read after: "baselines" (the full scan
   and STREAK on LGD and YAGO Q1-Q8, the sync R-tree engine and both fixed
   plans on LGD; each equal to its CPU run and to STREAK's scores, a sync
   R-tree join over both full sides refined to the full scan's candidates,
   every refinement launch replayed bit for bit, the full scan's largest,
   ~1.16M pairs, on its own, the rank kernel at the median and largest
   recorded calls); "ingest" (`build_stops_store` on the port's sample,
   the top-k query and the four shapes under both joins, equal to the full
   scan on the card and to the CPU); "fuzz" (50 seeded random queries of
   the fuzzer's generator on its two stores, equal to the full scan on the
   card, every STREAK kernel launched, then again under a fault rate of
   0.05: the same answers, with fallbacks); "analytics" (one
   `repro_torch.launch.analytics --n 2000` run, STREAK equal to the full
   scan on each query);
10. calls the reference's kernel entry points `ops.block_scan` (64 x 1024)
   and `ops.morton_encode` (1M codes), counts set to 0 before;
11. drives the dense-LM serving stack at gemma-7b's full width and depth
   (random bf16 weights from a seed, 8.54 B parameters): the 4,096-token
   prefill through `forward_with_cache` with the flash kernel (28 launches
   a call), held against the plain path and `forward` + `logits_fn`, with
   an fp8-attention control that the tolerance must reject; then
   `ServeEngine` on the launcher's requests, request 0's decode logits held
   against the full forward over its prefix; then the three dense smoke
   configs (f32) on the card against the CPU;
   then the MoE family: qwen2-moe-a2.7b (all 24 layers, 64 experts) and
   qwen3-moe-30b-a3b (all 48 layers where the card holds them, else the
   depth printed) at full width, bf16, random weights: the 4,096-token
   prefill through the flash kernel against the plain path with the flash
   pass's routing replayed, the SDPA control passing and the fp8 one
   failing, the per-layer routing agreement of the free plain pass and the
   pairs dropped at capacity ("moe prefill"); `ServeEngine` on qwen2-moe
   with the launcher's requests, request 0's decode logits against the
   prefill over its prefix with its routing replayed, two planted cache
   faults failing ("moe serve"); the two MoE smokes card against CPU
   ("moe smoke"); then training ("train"): the `tiny` preset and the MoE
   smokes, six `Trainer` steps on the card against the CPU; gemma-7b (4 of
   28 layers) and qwen2-moe (2 of 24) at full width, 4,096 tokens a step,
   the first loss bit-equal to `lm_loss`, ms a step, tokens/s and peak
   memory; and a `tiny` run saved, restored and continued, and one
   recovered from an injected failure, bit-identical to the uninterrupted
   run under deterministic algorithms;
12. the recsys and GNN families, each phase with its checks and, beside
   every time, its bound (bytes / 3.35 TB/s or operations / 67 TFLOP/s
   f32, 989 bf16, the larger): "retrieval" (the full sasrec catalog, 10^6
   items x 50 f32, popularity-skewed as `launch.serve` makes it;
   `streak_topk` and `blocked_topk` at retrieval_cand (B=1, k=100),
   serve_p99 (B=512, k=100) and the launcher's 8 users (k=10), each against
   a dense `torch.topk` of the full score matrix and the two against each
   other, with the blocks read below the block count; serve_bulk
   (B=262,144, k=100) through `blocked_topk` in blocks of 4,096, 256
   sampled rows against the dense top-k; a 50,000-item catalog on the card
   and on the CPU: ids and blocks read equal; `launch.serve --arch sasrec`
   and `launch.serve_topk` on the card); "recsys train" (full-width SASRec
   through the `Trainer`: three steps card against CPU at B=64, six
   steps against three + restore + three, bit-identical under
   `torch.use_deterministic_algorithms(True)` without warn_only, and
   train_batch (65,536 x 50) steps timed); "gnn" (gcn-cora at full width
   on a Cora-sized synthetic graph, 2,708 nodes and 10,556 edges, and
   graphsage-reddit at full width on 232,965 nodes with 1,024-seed
   `NeighborSampler` blocks at (25, 10): a forward and three steps, card
   against CPU); "graphcast" (the full config, 16 layers, 512 wide, 227
   variables, bf16, on the 0.25-degree grid and a 40,962-node mesh, edges
   from the STREAK radius join: the bf16 forward within 5e-2 relative RMS
   of an f32 run of the same weights, a dropped processor residual failing
   that, one training step with each block recomputed); "nequip" (the full
   config on 128 molecules x 30 atoms through `forward_batched`: energies
   invariant under rotation and translation and under an atom permutation,
   card against CPU); "ogb gcn" (gcn-cora's architecture at ogb_products'
   counts, 2,449,029 nodes x 100 features and 61,859,140 edges drawn on
   the card, 47 classes, no edge cut: a forward and three Trainer steps,
   ms and peak memory; the logits and first loss within 1e-4 of a sparse
   product's, half the edges failing that); then "roofline": the gemma-7b 4,096-token prefill,
   the qwen2-moe prefill, the gemma-7b 4-layer training step, GraphCast's
   forward and the ogb_products GCN forward and step counted on fake
   tensors by `roofline/op_count.record` (dot FLOPs, HBM bytes,
   collectives of the plain path: every eager op's operands and results),
   their three terms on the H100 model (`roofline/analysis.analyze`) and
   roofline fraction, each beside the wall ms of the same plain path from
   this run and the counted time's share of it (the prefills' flash ms
   beside, with no share); the records go to artifacts/roofline_torch/;
   then "cells": each of the 40 (arch x shape) cells of
   `launch/cells.py` gets its one-device dry-run record
   (`launch/dryrun.run_cell` on a 1x1 mesh, counted on fake tensors in
   CELL_WORKERS processes beside the card's work), and each cell whose
   predicted args + temps + results fit CELL_MEM_SHARE of the card runs
   one warm and one measured step at the full reference size on real
   seeded tensors ("cell" lines: predicted and measured peak GiB, their
   ratio, step ms by CUDA events); a measured peak above CELL_PEAK_SLACK
   times the prediction, an output that is not finite, or one of the
   smallest cells (CELLS_VS_CPU) that disagrees with its CPU run fails it;
13. traces one more pass of each query set on the card: host ms per
   executor layer, device busy ms (by kind: each kernel, memcpy) and the
   device's idle share; then the LGD and 1M-quad sets (fused join) with
   the rank pass alone on numpy and on its kernel, in turns ("rank turn");
   then the Bloom bank uploads over the run and each pass's memcpy ms;
14. prints the kernels line (JSON; `moe_prefill_launches`,
   `serve_launches`, `sharded_launches`,
   `baselines_launches`, `ingest_launches`, `fuzz_launches` and
   `analytics_launches` beside `launches`, tree_descend's `sharded` and
   `mesh` figures, bucketed_min_core's `fullscan_largest`), then the ok
   line (JSON) last.

Any failed phase raises, so the script exits non-zero without the ok line.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import ctypes
import dataclasses
import functools
import json
import math
import pathlib
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
try:
    from repro_torch.roofline.analysis import H100_SXM
except ImportError:
    sys.exit("chip_smoke: src/repro_torch not found beside this script")
# H100 SXM peaks (NVIDIA data sheet, roofline/analysis.py's hardware
# model): HBM rate, the scalar rate outside the tensor cores (f32; the
# integer kernels are held to the same rate) and the dense bf16 rate
HBM_BYTES_PER_S = H100_SXM.hbm_bw
F32_OPS_PER_S = H100_SXM.f32_flops
BF16_OPS_PER_S = H100_SXM.bf16_flops
# the reference's accelerator policy: every stage on its kernel
SLICE_POLICY = dict(probe="kernel", rank="kernel", impl="merge",
                    kcap="fixed", descend="kernel")
# the first slice's policy: Bloom probes and rank pass on the host
HOST_PROBE_RANK = dict(SLICE_POLICY, probe="numpy", rank="numpy")
REPLACES = {
    "fused_topk_join": "src/repro/kernels/fused_topk_join.py:110",
    "distance_join": "src/repro/kernels/distance_join.py:36",
    "bucketed_min_core": "src/repro/kernels/geom_refine.py:72",
    "tree_descend": "src/repro/kernels/tree_descend.py:75",
    "bloom_probe": "src/repro/kernels/bloom_probe.py:54",
    "merge_join_ranks": "src/repro/kernels/merge_join.py:106",
    "block_scan": "src/repro/kernels/block_scan.py:27",
    "morton_encode": "src/repro/kernels/morton_kernel.py:31",
    "flash_attention": "src/repro/kernels/flash_attention.py:76",
}
STREAK_KERNELS = ("fused_topk_join", "distance_join", "bucketed_min_core",
                  "tree_descend", "bloom_probe", "merge_join_ranks")
OPS_KERNELS = ("block_scan", "morton_encode")
# the reference's flash-attention tolerances (tests/test_kernels.py), held
# as a floor: max |got - want| of at most these
FLASH_TOL = {torch.float32: 2e-4, torch.bfloat16: 5e-2}
# In bf16 every element is also held to |got - want| <= 2^-7 |want| + 1e-3.
# The plain version computes in f32 from the bf16 operands, the kernel sums
# in f32 with P kept to ~16 bits (bf16 hi + lo); both round once to bf16,
# so they may differ by one rounding step, at most 2^-7 |want|; 1e-3
# covers the f32 sums' order near zero. Where a row averages over ~2,000
# keys, |o| ~ 0.04 and 5e-2 alone would pass a kernel that dropped a kv
# tile (the planted faults in check_flash).
FLASH_BF16_RTOL, FLASH_BF16_ATOL = 2 ** -7, 1e-3


def bound_ms(n_bytes: float, n_ops: float,
             ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, reps: int) -> float:
    """Mean device time of `fn` over `reps` calls, after two warm-up calls."""
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, symbol: str | None = None, reps: int = 20,
              cold_l2: bool = False) -> float | None:
    """Mean device time per call of `fn` of the kernels whose name holds
    `symbol` (of everything `fn` runs on the device when None), from a
    torch.profiler trace; None when the trace holds no such kernel. With
    `cold_l2`, 64 MB are written before each call, so that `fn`'s inputs
    come from device memory and not from the 50 MB L2 (needs `symbol`)."""
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda") \
        if cold_l2 else None
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if flush is not None:
                flush.zero_()
            fn()
        torch.cuda.synchronize()
    total_us = sum(stop - start for start, stop, name in device_spans(prof)
                   if symbol is None or symbol in name)
    return total_us / reps / 1e3 if total_us else None


def event_ms(fn, reps: int = 20, cold_l2: bool = False) -> float:
    """Mean device time per call of `fn` from two CUDA events around `reps`
    calls queued behind a sleep kernel that outlasts their enqueue, so the
    host's time between launches stays out of it: what the device spends
    on the calls, back to back. Never empty, unlike a trace. With
    `cold_l2` a 64 MB write precedes each call, and its own time, measured
    the same way, is taken off."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda") \
        if cold_l2 else None

    def body():
        if flush is not None:
            flush.zero_()
        fn()
    body()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        body()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(4e9 * host_s) + 2_000_000)   # ~2 GHz: twice over
    start.record()
    for _ in range(reps):
        body()
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / reps
    if flush is not None:
        ms -= event_ms(flush.zero_, reps)
    return ms


def kernel_ms(fn, symbol: str, reps: int = 20, cold_l2: bool = False
              ) -> dict:
    """{device_ms, event_ms} of the kernels `fn` launches: the trace's time
    (None where it holds no such kernel) beside the events'."""
    return dict(device_ms=device_ms(fn, symbol, reps, cold_l2),
                event_ms=event_ms(fn, reps, cold_l2))


def require_equal(name: str, got, want) -> float:
    """Bit-identical outputs, or raise; returns the max abs error (0)."""
    for g, w in zip(got, want):
        if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(g, w):
            raise AssertionError(
                f"{name}: kernel disagrees with its plain version "
                f"({g.dtype} {tuple(g.shape)} vs {w.dtype} {tuple(w.shape)}, "
                f"{int((g != w).sum()) if g.shape == w.shape else '?'} "
                "elements differ)")
    return 0.0


# --------------------------------------------------------- per-kernel phase --
def _boxes(rng, n, size=0.01):
    lo = rng.random((n, 2))
    return np.concatenate([lo, lo + rng.random((n, 2)) * size], axis=1) \
        .astype(np.float32)


def check_distance_join(ops, ref, dev, entry, cases):
    """The matrix form at 1024 x 4096 (and N % 4 != 0), then the pair call
    at the main path's largest launch shape (scale1m's 523 x 8954): random
    boxes, dist equal to one of the distances, NaN boxes, nothing passing,
    and everything passing at a size above the pair buffer's capacity, which
    must run the call again once. Each against its plain version."""
    rng = np.random.default_rng(1)
    for m, n in ((33, 1027), (1024, 4096)):
        a = torch.from_numpy(_boxes(rng, m)).to(dev)
        b = torch.from_numpy(_boxes(rng, n)).to(dev)
        err = require_equal(f"distance_join {m}x{n}",
                            [ops.distance_join(a, b)],
                            [ref.distance_join_ref(a, b)])
    entry.update(
        shape=f"M={m} N={n}", max_abs_err=err,
        ms=time_ms(lambda: ops.distance_join(a, b), 50),
        **kernel_ms(lambda: ops.distance_join(a, b), "distance_join_kernel"),
        plain_ms=time_ms(lambda: ref.distance_join_ref(a, b), 10))
    entry["bound_ms"], entry["bound_by"] = bound_ms(
        (m + n) * 16 + m * n * 4, m * n * 12)
    m, n = 523, 8954
    a = torch.from_numpy(_boxes(rng, m)).to(dev)
    b = torch.from_numpy(_boxes(rng, n)).to(dev)
    d = ref.distance_join_ref(a, b)
    at = float(d.flatten().sort().values[d.numel() // 200])   # 0.5% pass
    nan_a, nan_b = a.clone(), b.clone()
    nan_a[::3, 2] = float("nan")
    nan_b[1::4, 1] = float("nan")
    for label, (x, y, dist) in {
            "random": (a, b, 0.02), "d == dist": (a, b, at),
            "nan boxes": (nan_a, nan_b, 0.02),
            "none pass": (a, b, -1.0)}.items():
        got = ops.distance_join_pairs(x, y, dist)
        want = ref.distance_join_pairs_ref(x, y, dist)
        require_equal(f"distance_join_pairs {label}",
                      [torch.from_numpy(g) for g in got],
                      [w.cpu() for w in want])
        if label == "d == dist" and not bool(
                (d[want] == np.float32(at)).any()):
            raise AssertionError("distance_join_pairs: no pair at d == dist")
        cases.append(dict(kernel="distance_join_pairs", case=label, M=m, N=n,
                          pairs=len(got[0])))
    # everything passes, more pairs than the buffer holds
    cap = ops.pairs_capacity(dev)
    n = 4096
    m = cap // n + 1
    x = torch.from_numpy(_boxes(rng, m)).to(dev)
    y = torch.from_numpy(_boxes(rng, n)).to(dev)
    retries, launches = ops.pair_capacity_retries, ops.LAUNCHES[
        "distance_join"]
    got = ops.distance_join_pairs(x, y, 4.0)
    retried = ops.pair_capacity_retries - retries
    launched = ops.LAUNCHES["distance_join"] - launches
    require_equal("distance_join_pairs all pass",
                  [torch.from_numpy(g) for g in got],
                  [w.cpu() for w in ref.distance_join_pairs_ref(x, y, 4.0)])
    if len(got[0]) != m * n or retried != 1 or launched != 2:
        raise AssertionError(f"distance_join_pairs all pass: {len(got[0])} "
                             f"pairs of {m * n}, {retried} retries, "
                             f"{launched} launches (want 1 and 2)")
    case = dict(kernel="distance_join_pairs", case="all pass", M=m, N=n,
                pairs=len(got[0]), capacity_before=cap, retries=retried,
                launches=launched, capacity_after=ops.pairs_capacity(dev))
    cases.append(case)
    print("pair capacity retry " + json.dumps(case), flush=True)


def pairs_bound(m: int, n: int, pairs: int) -> tuple[float, str]:
    """The boxes read once, the pairs (8 bytes each) and a count written
    once; ~15 operations a tested pair (the distance, then the compare)."""
    return bound_ms((m + n) * 16 + pairs * 8 + 8, m * n * 15)


def check_fused(ops, ref, dev, entry):
    rng = np.random.default_rng(2)
    m, n = 1024, 4096
    a = torch.from_numpy(_boxes(rng, m)).to(dev)
    b = torch.from_numpy(_boxes(rng, n)).to(dev)
    # keys on a 1/64 grid: many equal bounds, so ties are exercised
    dk = torch.from_numpy((rng.integers(0, 64, m) / 64).astype(np.float32))
    vk = torch.from_numpy((rng.integers(0, 64, n) / 64).astype(np.float32))
    dk, vk = dk.to(dev), vk.to(dev)
    dist = torch.full((m,), 0.06, dtype=torch.float32, device=dev)
    zq_r = torch.zeros(m, dtype=torch.int32, device=dev)
    zq_c = torch.zeros(n, dtype=torch.int32, device=dev)
    mixed_r = torch.from_numpy(rng.integers(0, 3, m).astype(np.int32)).to(dev)
    mixed_c = torch.from_numpy(rng.integers(0, 3, n).astype(np.int32)).to(dev)
    overflowed = False
    for k in (100, 64, 1024):
        for theta_v in (-np.inf, 1.2):
            for rq, cq in ((zq_r, zq_c), (mixed_r, mixed_c)):
                theta = torch.full((m,), theta_v, dtype=torch.float32,
                                   device=dev)
                args = (a, b, dk, vk, dist, theta)
                got = ops.fused_topk_join(*args, k=k, row_qid=rq, col_qid=cq)
                want = ref.fused_topk_join_ref(*args, rq, cq, k)
                require_equal(f"fused_topk_join k={k} theta={theta_v}",
                              got, want)
                overflowed |= bool((got[2] > k).any())
    if not overflowed:
        raise AssertionError("fused_topk_join: no case overflowed k")
    theta = torch.full((m,), -np.inf, dtype=torch.float32, device=dev)
    args = (a, b, dk, vk, dist, theta)

    def call():
        return ops.fused_topk_join(*args, k=100, row_qid=zq_r, col_qid=zq_c)
    entry.update(
        shape=f"M={m} N={n} k=100 theta=-inf", max_abs_err=0.0,
        ms=time_ms(call, 20), **kernel_ms(call, "fused_topk_join_kernel"),
        plain_ms=time_ms(lambda: ref.fused_topk_join_ref(
            *args, zq_r, zq_c, 100), 5))
    entry["bound_ms"], entry["bound_by"] = fused_bound(m, n, 100)


def check_bucketed(ops, ref, dev, entry, cases):
    rng = np.random.default_rng(3)
    nb = 4096
    for dims in (2, 3):
        for m_pad in (1, 8, 32, 128):
            for n_pad in (1, 8, 32, 128):
                a = torch.from_numpy(rng.uniform(
                    -1, 1, (dims, nb, m_pad)).astype(np.float32)).to(dev)
                b = torch.from_numpy(rng.uniform(
                    -1, 1, (dims, nb, n_pad)).astype(np.float32)).to(dev)
                want = ref.bucketed_min_core_ref(a, b)
                require_equal(f"bucketed_min_core {dims}d {m_pad}x{n_pad}",
                              [ops.bucketed_min_core(a, b)], [want])
                # timed as the path calls it: a packed buffer on the card
                group = ops.min_core_group(dims, [(nb, m_pad, n_pad)])
                buf = torch.cat([torch.from_numpy(
                    group.pack()[:group.header]).to(dev), a.reshape(-1),
                    b.reshape(-1)])

                def call():
                    return ops.bucketed_min_core_group(buf, group)
                require_equal(f"bucketed_min_core {dims}d {m_pad}x{n_pad} "
                              "packed", [call()], [want])
                ms = time_ms(call, 20)
                km = kernel_ms(call, "bucketed_min_core_kernel")
                plain = time_ms(lambda: ref.bucketed_min_core_ref(a, b), 3)
                bnd, by = bound_ms(dims * nb * (m_pad + n_pad) * 4 + nb * 4,
                                   nb * m_pad * n_pad * 3 * dims)
                cases.append(dict(kernel="bucketed_min_core", dims=dims,
                                  B=nb, m_pad=m_pad, n_pad=n_pad, ms=ms,
                                  **km, plain_ms=plain,
                                  bound_ms=bnd, bound_by=by))
                if (dims, m_pad, n_pad) == (2, 8, 8):
                    entry.update(shape=f"dims=2 B={nb} m_pad=8 n_pad=8",
                                 max_abs_err=0.0, ms=ms, **km,
                                 plain_ms=plain, bound_ms=bnd, bound_by=by)
    # grouped launches mixing every layout: classes from 1 x 1 to 128 x 128
    for dims, shapes in ((2, [(300, 1, 1), (77, 2, 8), (1024, 8, 8),
                              (50, 16, 4), (40, 4, 32), (33, 32, 32),
                              (20, 128, 16), (9, 128, 128), (12, 1, 128),
                              (5, 3, 5)]),
                         (3, [(210, 1, 4), (130, 8, 8), (70, 32, 16),
                              (30, 64, 128)])):
        group = ops.min_core_group(dims, shapes)
        buf = group.pack()
        for g in range(len(shapes)):
            for p in group.planes(buf, g):
                p[:] = rng.uniform(-1, 1, p.shape)
        t = torch.from_numpy(buf).to(dev)
        require_equal(f"bucketed_min_core grouped {dims}d",
                      [ops.bucketed_min_core_group(t, group)],
                      [ref.bucketed_min_core_group_ref(t, group.desc, dims)])


def check_tree_descend(ops, ref, dev, entry, trees, cases):
    rng = np.random.default_rng(4)
    nb, m = 8, 1024
    for name, tree in trees.items():
        n = tree.n_nodes
        node_keys = torch.from_numpy(ops.f64_sort_keys(
            np.ascontiguousarray(tree.node_mbr.T))).to(dev)
        pick = rng.integers(0, tree.n_objects, (nb, m))
        boxes = tree.obj_mbr[pick] + np.array([-0.02, -0.02, 0.02, 0.02])
        keys = ops.f64_sort_keys(boxes)
        keys[:, m - 100:] = ops.DESCEND_PAD_BOX      # ragged last rows
        box_keys = torch.from_numpy(keys).to(dev)
        cs = torch.from_numpy(rng.random(n) < 0.9).to(dev)
        got = ops.tree_descend(node_keys, cs, box_keys)
        require_equal(f"tree_descend {name}", [got],
                      [ref.tree_descend_ref(node_keys, cs, box_keys)])
        tests = descend_tests(node_keys, cs, box_keys)
        ms = time_ms(lambda: ops.tree_descend(node_keys, cs,
                                                     box_keys), 50)
        km = kernel_ms(
            lambda: ops.tree_descend(node_keys, cs, box_keys),
                        "tree_descend_kernel")
        plain = time_ms(lambda: ref.tree_descend_ref(
            node_keys, cs, box_keys), 10)
        bnd, by = bound_ms(4 * n * 8 + n + nb * m * 32 + nb * n, tests * 4)
        cases.append(dict(kernel="tree_descend", tree=name, B=nb, M=m, N=n,
                          ms=ms, **km, plain_ms=plain,
                          bound_ms=bnd,
                          bound_by=by))
        if name == "lgd":
            entry.update(shape=f"B={nb} M={m} N={n}", max_abs_err=0.0,
                         ms=ms, **km, plain_ms=plain,
                          bound_ms=bnd,
                         bound_by=by)


def descend_tests(node_keys, cs, box_keys) -> int:
    """Box tests that these inputs need: for each live (b, node), the
    boxes up to its first hit, all M where nothing hits it."""
    m = box_keys.shape[1]
    tests = 0
    for bi in range(box_keys.shape[0]):
        bx = box_keys[bi]
        hit = ((node_keys[0][None] <= bx[:, 2:3])
               & (bx[:, 0:1] <= node_keys[2][None])
               & (node_keys[1][None] <= bx[:, 3:4])
               & (bx[:, 1:2] <= node_keys[3][None]))
        first = torch.where(hit.any(0), hit.int().argmax(0) + 1, m)
        tests += int(first[cs].sum())
    return tests


def check_descend_path(ops, ref, captured, entry, cases, lgd_nodes):
    """`tree_descend` at the inputs the main path gave it: every captured
    launch bit-identical to the plain version, then, per tree, the launch
    at the median M timed (the kernel alone, a call, the plain version)
    beside its bound. The kernels line takes LGD's."""
    by_tree = collections.defaultdict(list)
    for args in captured:
        require_equal(f"tree_descend path B={args[2].shape[0]} "
                      f"M={args[2].shape[1]} N={args[0].shape[1]}",
                      [ops.tree_descend(*args)], [ref.tree_descend_ref(*args)])
        by_tree[args[0].shape[1]].append(args)
    for n, launches in sorted(by_tree.items()):
        launches.sort(key=lambda a: a[2].shape[1])
        node_keys, cs, box_keys = launches[len(launches) // 2]
        nb, m = box_keys.shape[0], box_keys.shape[1]
        tests = descend_tests(node_keys, cs, box_keys)
        ms = time_ms(lambda: ops.tree_descend(node_keys, cs, box_keys), 50)
        km = kernel_ms(
            lambda: ops.tree_descend(node_keys, cs, box_keys),
                        "tree_descend_kernel")
        plain = time_ms(lambda: ref.tree_descend_ref(node_keys, cs,
                                                     box_keys), 10)
        bnd, by = bound_ms(4 * n * 8 + n + nb * m * 32 + nb * n, tests * 4)
        case = dict(kernel="tree_descend", tree=f"path N={n}", B=nb, M=m,
                    N=n, live=int(cs.sum()), launches=len(launches),
                    box_tests=tests, ms=ms, **km,
                    plain_ms=plain,
                    bound_ms=bnd, bound_by=by)
        cases.append(case)
        print("case " + json.dumps(case), flush=True)
        if n == lgd_nodes:
            entry["synthetic"] = {k: entry[k] for k in (
                "shape", "ms", "device_ms", "event_ms", "plain_ms",
                "bound_ms", "bound_by")}
            entry.update(shape=f"B={nb} M={m} N={n} (the LGD path's median "
                         "launch)", ms=ms, **km,
                         plain_ms=plain,
                         bound_ms=bnd, bound_by=by)


def fused_bound(m: int, n: int, k: int) -> tuple[float, str]:
    """Per pair: 12 ops of distance, 1 add, 3 compares; the inputs read
    once (32 bytes a driver row, 24 a driven column), the (M, k) partials
    and counts written once."""
    return bound_ms(m * 32 + n * 24 + m * k * 8 + m * 4, m * n * 16)


def min_core_bound(group) -> tuple[float, str]:
    """The packed buffer read once, the cores written once; ~3 ops per
    dimension of a point pair."""
    pairs = int((group.desc[:, 3].astype(np.int64) * group.desc[:, 4]
                 * group.desc[:, 5]).sum())
    return bound_ms((group.header + group.n_floats + group.n_rows) * 4,
                    pairs * 3 * group.dims)


def _outputs(x) -> list:
    return list(x) if isinstance(x, (tuple, list)) else [x]


def check_path_replays(name, symbol, launches, entry, cases, groups=None):
    """Every recorded main-path launch of one kernel (dicts of set, shape,
    kernel and plain calls, bound, and for a call that synchronises its
    kernel's launch alone, `launch`) replayed on the card: bit-identical to
    the plain version, then timed. Per launch, the device time from CUDA
    events queued back to back (`event_ms`, of `launch` where there is one)
    and from a trace of five replays of the whole sequence (`device_ms`,
    None where the trace misses launches). A "case" line per query set, for lgd + scale1m (the
    path PR 15 timed) and for all sets: launches, summed ms and bound, and
    the median launch (by event time) with its plain version's time; every
    launch's times in the report only. The kernels line takes all sets, its
    synthetic figures under `synthetic`. `groups` ({path label: launches})
    replaces those groups, and with `entry` None the kernels line is left
    as it is (the serving loop's replays)."""
    from torch.profiler import ProfilerActivity, profile
    for r in launches:
        require_equal(f"{name} path {r['set']} {r['shape']}",
                      _outputs(r["kernel"]()), _outputs(r["plain"]()))
    for r in launches:
        r["event_ms"] = event_ms(r.get("launch", r["kernel"]), 10)
    reps = 5
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            for r in launches:
                r["kernel"]()
        torch.cuda.synchronize()
    spans = [stop - start for start, stop, ev in device_spans(prof)
             if symbol in ev]
    traced = len(spans) == reps * len(launches)
    for i, r in enumerate(launches):
        r["device_ms"] = (sum(spans[i::len(launches)]) / reps / 1e3
                          if traced else None)
    if groups is None:
        groups = {s: [r for r in launches if r["set"] == s]
                  for s in dict.fromkeys(r["set"] for r in launches)}
        groups["lgd+scale1m"] = [r for r in launches
                                 if r["set"] in ("lgd", "scale1m")]
        groups["all"] = launches
    for label, rs in groups.items():
        if not rs:
            continue
        med = sorted(rs, key=lambda r: r["event_ms"])[len(rs) // 2]
        case = dict(
            kernel=name, path=label, launches=len(rs),
            event_ms_sum=sum(r["event_ms"] for r in rs),
            device_ms_sum=(sum(r["device_ms"] for r in rs)
                           if traced else None),
            trace_spans=len(spans), trace_spans_expected=reps * len(launches),
            bound_ms_sum=sum(r["bound"][0] for r in rs),
            median_shape=med["shape"], median_event_ms=med["event_ms"],
            median_device_ms=med["device_ms"],
            median_call_ms=time_ms(med["kernel"], 20),
            median_plain_ms=time_ms(med["plain"], 5),
            median_bound_ms=med["bound"][0], median_bound_by=med["bound"][1])
        cases.append(case)
        print("case " + json.dumps(case), flush=True)
    cases.append(dict(kernel=name, path="every launch", launches=[
        dict(set=r["set"], shape=r["shape"], event_ms=r["event_ms"],
             device_ms=r["device_ms"], bound_ms=r["bound"][0])
        for r in launches]))
    if entry is None:
        return
    entry["synthetic"] = {k: entry[k] for k in (
        "shape", "ms", "device_ms", "event_ms", "plain_ms", "bound_ms",
        "bound_by")}
    entry.update(
        shape=f"main path: {case['launches']} launches, median "
              f"{case['median_shape']}",
        ms=case["median_event_ms"], event_ms=case["median_event_ms"],
        device_ms=case["median_device_ms"], call_ms=case["median_call_ms"],
        plain_ms=case["median_plain_ms"], bound_ms=case["median_bound_ms"],
        bound_by=case["median_bound_by"], path_event_ms=case["event_ms_sum"],
        path_device_ms=case["device_ms_sum"],
        path_bound_ms=case["bound_ms_sum"])


def check_bloom_probe(rt, ops, ref, dev, entry, lgd, cases):
    """The main path's shape (every node of the LGD tree x the driven-CS
    keys of LGD Q1, from the store's `bloom_self`), then random banks over
    W in {8, 16, 32} x k in {2, 3, 4} with inserted keys and absent keys
    that have the high bit set."""
    from repro_torch.core.charsets import BloomBank
    from repro_torch.core.planner import plan_query
    tree = lgd.store.tree
    plan = plan_query(lgd.store, lgd.queries[0],
                      policy=rt.BackendPolicy(join="fused", **SLICE_POLICY))
    bank, cs = tree.bloom_self, plan.driven_cs
    n, c = tree.n_nodes, len(cs)
    rows = torch.from_numpy(bank.bits[np.repeat(np.arange(n), c)]
                            .view(np.int32)).to(dev)
    keys = torch.from_numpy(np.tile(cs, n)).to(dev)
    got = ops.bloom_probe(rows, keys, bank.k)
    require_equal("bloom_probe lgd Q1", [got],
                  [ref.bloom_probe_ref(rows, keys, bank.k)])
    rng = np.random.default_rng(5)
    for w in ops.BLOOM_WORDS:
        for k in (2, 3, 4):
            rbank = BloomBank.empty(1024, words=w, k=k)
            ins = rng.integers(0, 1 << 62, 4096, dtype=np.int64)
            ins_f = rng.integers(0, 1024, 4096)
            rbank.add(ins_f, ins)
            absent = rng.integers(-(1 << 63), -1, 4096, dtype=np.int64)
            fi = np.concatenate([ins_f, rng.integers(0, 1024, 4096)])
            r = torch.from_numpy(rbank.bits[fi].view(np.int32)).to(dev)
            kk = torch.from_numpy(np.concatenate([ins, absent])).to(dev)
            g = ops.bloom_probe(r, kk, k)
            require_equal(f"bloom_probe W={w} k={k}", [g],
                          [ref.bloom_probe_ref(r, kk, k)])
            if not bool(g[:4096].all()):
                raise AssertionError(f"bloom_probe W={w} k={k}: an "
                                     "inserted key tested absent")
            cases.append(dict(kernel="bloom_probe", W=w, k=k, B=8192,
                              members=int(g.sum())))
            # the per-filter form: key sets within one and across the
            # kernel's 256-key chunks, filters repeated
            fi_any = rng.integers(0, 1024, 2000)
            bits = torch.from_numpy(rbank.bits.view(np.int32)).to(dev)
            for n_keys in (5, 300, 600):
                keys_any = np.concatenate([ins[:3], absent[:n_keys - 3]])
                got_any = require_any(ops, ref, f"bloom_probe_any W={w} "
                                      f"k={k} C={n_keys}", bits, fi_any,
                                      keys_any, k)
                if not got_any[np.isin(fi_any, ins_f[:3])].all():
                    raise AssertionError(f"bloom_probe_any W={w} k={k}: a "
                                         "filter holding a key tested absent")
    # LGD Q1's probe of every node, against a copy of the store's bank made
    # here (the store's own copy is made by the main path, once)
    require_any(ops, ref, "bloom_probe_any lgd Q1",
                torch.from_numpy(bank.bits.view(np.int32)).to(dev),
                np.arange(n), cs, bank.k)
    # a bank probed, added to and probed again: `add` drops the resident
    # copy, so the added key is found, after a second upload
    fresh = BloomBank.empty(n, words=8, k=3)
    fresh.add(rng.integers(0, n, 4000), rng.integers(0, 1 << 62, 4000))
    key = np.array([(1 << 62) + 12345], dtype=np.int64)
    prep = fresh.prepare(key)
    uploads = ops.bloom_bank_uploads
    first = fresh.contains_any_batch(np.arange(n), prep, "kernel", dev)
    target = int(np.flatnonzero(~first)[0])
    fresh.add(np.array([target]), key)
    after = fresh.contains_any_batch(np.arange(n), prep, "kernel", dev)
    uploads = ops.bloom_bank_uploads - uploads
    if not (after[target] and uploads == 2 and np.array_equal(
            after, fresh.contains_any_batch(np.arange(n), prep, "numpy"))):
        raise AssertionError(f"bloom_probe_any after add: found "
                             f"{bool(after[target])}, {uploads} uploads")
    cases.append(dict(kernel="bloom_probe_any", case="after add",
                      filters=n, uploads=uploads))
    # what this data needs: per row its key, its verdict, and the words up
    # to its first clear bit; ~40 integer ops of hashing plus ~7 a word
    pos = ref.bloom_positions(keys, bank.k, bank.nbits)
    words = rows.to(torch.int64) & 0xFFFFFFFF
    bit = (torch.gather(words, 1, pos // 32) >> (pos % 32)) & 1
    tested = torch.where((bit == 0).any(1),
                         (bit == 0).int().argmax(1) + 1, bank.k)
    n_words = int(tested.sum())
    b = n * c
    entry.update(
        shape=f"B={b} (N={n} nodes x C={c} keys) W={bank.words} k={bank.k}",
        max_abs_err=0.0,
        ms=time_ms(lambda: ops.bloom_probe(rows, keys, bank.k), 50),
        **kernel_ms(lambda: ops.bloom_probe(rows, keys, bank.k),
                            "bloom_probe_kernel"),
        plain_ms=time_ms(lambda: ref.bloom_probe_ref(rows, keys, bank.k),
                         10),
        library_note="no PyTorch call computes a double-hashed Bloom test")
    entry["bound_ms"], entry["bound_by"] = bound_ms(
        b * (8 + 1) + n_words * 4, b * 40 + n_words * 7)


def require_any(ops, ref, label, bits, fi, keys, k) -> np.ndarray:
    """`ops.bloom_probe_any` bit-identical to its plain version; returns
    the verdicts."""
    got = ops.bloom_probe_any(bits, fi, keys, k)
    want = ref.bloom_probe_any_ref(bits, torch.from_numpy(fi).to(bits.device),
                                   torch.from_numpy(keys).to(bits.device), k)
    require_equal(label, [torch.from_numpy(got)], [want.cpu()])
    return got


def any_bound(ref, bits, fi, keys, k) -> tuple[float, str]:
    """What this per-filter probe needs: the filter indices, the keys and
    the verdicts once, and per filter the words that its tested probes
    land in; ~40 integer operations to hash a key (once), ~7 a probe, for
    each filter's keys up to its first member and each key's probes up to
    its first clear bit."""
    dev = bits.device
    kt = torch.from_numpy(keys).to(dev)
    pos = ref.bloom_positions(kt, k, bits.shape[1] * 32)          # (C, k)
    rows = bits[torch.from_numpy(fi).to(dev)].to(torch.int64) & 0xFFFFFFFF
    bit = (rows[:, pos // 32] >> (pos % 32)) & 1                 # (F, C, k)
    clear = bit == 0
    probes = torch.where(clear.any(2), clear.int().argmax(2) + 1, k)
    member = ~clear.any(2)                                       # (F, C)
    keys_tested = torch.where(member.any(1), member.int().argmax(1) + 1,
                              len(keys))
    tested = torch.arange(len(keys), device=dev)[None] < keys_tested[:, None]
    n_probes = int((probes * tested).sum())
    words = len(torch.unique(pos // 32))
    return bound_ms(len(fi) * (8 + 1 + words * 4) + len(keys) * 8,
                    len(keys) * 40 + n_probes * 7)


def rank_words_touched(table, probes) -> tuple[int, int]:
    """Distinct table words, and distinct 32-byte sectors, that the rank
    kernel's binary-lifting searches (lower and upper bound) read for these
    probes: the same search run in torch, its positions marked. Raises if
    the search's ranks differ from torch.searchsorted's."""
    n = table.shape[0]
    seen = torch.zeros(n + (-n) % 4, dtype=torch.bool, device=table.device)
    step0 = 1 << (n.bit_length() - 1)
    for side, strict in (("left", True), ("right", False)):
        pos = torch.zeros_like(probes)
        step = step0
        while step:
            nxt = pos + step
            ok = nxt <= n
            idx = (nxt - 1).clamp(max=n - 1)
            seen[idx[ok]] = True
            v = table[idx]
            pred = (v < probes) if strict else (v <= probes)
            pos = torch.where(ok & pred, nxt, pos)
            step >>= 1
        if not torch.equal(pos, torch.searchsorted(table, probes, side=side)):
            raise AssertionError(f"rank search model disagrees ({side})")
    return int(seen.sum()), int(seen.view(-1, 4).any(1).sum())


# (N, M) of the rank timings: the main path's median and largest call
# (the recorded shapes of its 998 calls), then the synthetic shapes of the
# earlier runs: ~1M keys against 4,096 probes and against as many probes
RANK_SHAPES = ((6_000, 304), (222_222, 111_111), (1_000_003, 4_096),
               (1_000_003, 1_000_003))


def _rank_inputs(rng, n, m):
    """A sorted int64 table of n keys in runs of 1-4 duplicates, and m
    probes below, above, at (exact hits) and inside the table."""
    base = np.sort(rng.integers(-(1 << 40), 1 << 40, n))
    table = np.repeat(base, rng.integers(1, 5, n))[:n]
    lo_v, hi_v = int(table[0]), int(table[-1])
    probes = np.concatenate([
        rng.integers(lo_v - (1 << 41), lo_v, m // 8),          # below
        rng.integers(hi_v + 1, hi_v + (1 << 41), m // 8),      # above
        rng.choice(table, m // 4),                             # hits
        rng.integers(lo_v, hi_v, m - m // 8 * 2 - m // 4)])    # inside
    return table, rng.permutation(probes)


def _rank_edge_inputs(rng):
    """{name: (table, probes)}: a run of equal keys longer than the
    warp's 32-key gallop window, one repeated key, int64 extremes."""
    lo, hi = -(1 << 63), (1 << 63) - 1
    run = np.sort(np.concatenate([rng.integers(-500, 500, 3000),
                                  np.full(5000, 7)]))
    return {
        "long run": (run, np.array([7, 6, 8, 0, -501, 501] * 9)),
        "one key": (np.full(4096, 42), np.array([42, 41, 43, lo, hi] * 9)),
        "int64 extremes": (
            np.sort(np.concatenate([[lo, lo, hi, hi],
                                    rng.integers(lo, hi, 999)])),
            np.array([lo, lo + 1, hi, hi - 1, 0, -1] * 9)),
    }


def _require_ranks(ops, ref, name, table, probes):
    """Every side, through the wrapper and each layout (a thread a probe,
    a warp a probe), bit-identical to the plain version."""
    for side in ("both", "left", "right"):
        want = ref.merge_join_ranks_ref(table, probes, side)
        want = list(want) if side == "both" else [want]
        got = ops.insertion_ranks(table, probes, side)
        require_equal(f"merge_join_ranks {name} side={side}",
                      list(got) if side == "both" else [got], want)
        for lanes in (1, 32):
            out = torch.empty((len(want), probes.shape[0]),
                              dtype=torch.int64, device=probes.device)
            ops._rank_launch(table, probes, out, side, lanes)
            require_equal(f"merge_join_ranks {name} side={side} "
                          f"lanes={lanes}", list(out), want)


def host_call_ms(fn, reps: int) -> float:
    """Mean host wall ms of `fn`, which synchronises itself, after two
    warm-up calls."""
    for _ in range(2):
        fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def rank_call_times(ops, dev) -> dict:
    """{(N, M): host ms} of the engine's numpy-in, numpy-out rank call at
    RANK_SHAPES: on the kernel with the table resident on the card
    (`numpy_call_ms`) and uploaded beside the probes
    (`numpy_call_upload_ms`), and numpy's searchsorted left + right
    (`host_searchsorted_ms`). Run before any profiler session: once
    torch.profiler has traced the card, every CUDA call of the process
    costs more on the host."""
    rng = np.random.default_rng(6)
    out = {}
    for n, m in RANK_SHAPES:
        table_np, probes_np = _rank_inputs(rng, n, m)
        resident = ops.device_table(table_np, dev)
        out[(n, m)] = dict(
            numpy_call_ms=host_call_ms(lambda: ops.merge_join_ranks(
                table_np, probes_np, "kernel", "both", dev,
                table_on_device=resident), 50),
            numpy_call_upload_ms=host_call_ms(lambda: ops.merge_join_ranks(
                table_np, probes_np, "kernel", "both", dev), 50),
            host_searchsorted_ms=host_call_ms(lambda: ops.merge_join_ranks(
                table_np, probes_np, "numpy", "both"), 3 if m > 1e5 else 50))
    return out


def path_call_times(rt, ops, datasets, dev) -> dict:
    """Host ms of the pair call and the Bloom probe as the engine makes
    them, beside the routes they replaced, at the main path's own inputs:
    one untraced pass of each set with the matrix join records the inputs
    of every pair call (host boxes) and Bloom probe, then, at the median and
    the largest of each (by M x N, by filters), `call_ms` (the call now),
    `matrix_route_ms` (the (M, N) f32 matrix on the card, copied back,
    compared and `np.nonzero`-ed on the host) and for the probe
    `gather_route_ms` (F x C rows gathered and keys tiled on the host,
    uploaded, probed per row, verdicts reduced on the host) and `numpy_ms`
    (the numpy probe). Each route's answer must equal the call's. Run
    before any profiler session (see `rank_call_times`)."""
    from repro_torch.core.charsets import BloomBank
    pair_in, probe_in = [], []
    pairs, probe = ops.distance_join_pairs, ops.bloom_probe_any

    def recording_pairs(driver, driven, dist, device=None):
        if isinstance(driver, np.ndarray):
            pair_in.append((driver.copy(), driven.copy(), dist))
        return pairs(driver, driven, dist, device)

    def recording_probe(bits, fi, keys, k):
        probe_in.append((bits, np.array(fi), np.array(keys), k))
        return probe(bits, fi, keys, k)
    ops.distance_join_pairs, ops.bloom_probe_any = recording_pairs, \
        recording_probe
    try:
        for ds, n_q in datasets.values():
            eng = rt.StreakEngine(ds.store, rt.ExecConfig(
                policy=rt.BackendPolicy(join="kernel", **SLICE_POLICY)),
                device="cuda")
            for qi in range(n_q):
                eng.execute(ds.queries[qi])
    finally:
        ops.distance_join_pairs, ops.bloom_probe_any = pairs, probe
    out = {}
    pair_in.sort(key=lambda r: len(r[0]) * len(r[1]))
    for label, (a, b, dist) in (("median", pair_in[len(pair_in) // 2]),
                                ("largest", pair_in[-1])):
        def matrix_route(a=a, b=b, dist=dist):
            d = ops.distance_join(*(torch.from_numpy(np.ascontiguousarray(
                x, dtype=np.float32)).to(dev) for x in (a, b)))
            return np.nonzero(d.cpu().numpy() <= np.float32(dist))

        def call(a=a, b=b, dist=dist):
            return ops.distance_join_pairs(a, b, dist, dev)
        got = call()
        if not all(np.array_equal(g, w) for g, w in zip(got, matrix_route())):
            raise AssertionError(f"pair call {label}: the matrix route "
                                 "differs")
        out[f"pair call {label}"] = dict(
            M=len(a), N=len(b), pairs=len(got[0]),
            call_ms=host_call_ms(call, 50),
            matrix_route_ms=host_call_ms(matrix_route, 50))
    probe_in.sort(key=lambda r: len(r[1]))
    for label, (bits, fi, keys, k) in (("median", probe_in[len(probe_in) // 2]),
                                       ("largest", probe_in[-1])):
        bank = BloomBank(bits.cpu().numpy().view(np.uint32), k)
        prep = bank.prepare(keys)

        def gather_route(bank=bank, fi=fi, keys=keys, k=k):
            rows = bank.bits[np.repeat(fi, len(keys))].view(np.int32)
            hit = ops.bloom_probe(torch.from_numpy(rows).to(dev),
                                  torch.from_numpy(np.tile(keys, len(fi)))
                                  .to(dev), k)
            return hit.cpu().numpy().reshape(len(fi), len(keys)).any(-1)

        def call(bank=bank, fi=fi, prep=prep):
            return bank.contains_any_batch(fi, prep, "kernel", dev)

        def numpy_route(bank=bank, fi=fi, prep=prep):
            return bank.contains_any_batch(fi, prep, "numpy")
        got = call()
        if not (np.array_equal(got, gather_route())
                and np.array_equal(got, numpy_route())):
            raise AssertionError(f"bloom call {label}: a route differs")
        out[f"bloom call {label}"] = dict(
            F=len(fi), C=len(keys), W=bank.words, k=k,
            members=int(got.sum()), call_ms=host_call_ms(call, 50),
            gather_route_ms=host_call_ms(gather_route, 50),
            numpy_ms=host_call_ms(numpy_route, 50))
    return out


def pair_replay(ops, ref, build, label, route, a, b, dist, pairs) -> dict:
    """One recorded pair call for `check_path_replays`: the call, its plain
    version, its kernel alone (no copy, no synchronise) writing into a
    pinned buffer of its own, and its bound."""
    out = torch.empty(pairs + 1, dtype=torch.int64, pin_memory=True)
    counters = torch.zeros(2, dtype=torch.int64, device=a.device)
    launcher = build.launcher("distance_join_pairs_launch")
    dist32 = float(np.float32(dist))

    def launch():
        err = launcher(a.data_ptr(), b.data_ptr(), len(a), len(b), dist32,
                       counters.data_ptr(), out.data_ptr(), pairs,
                       torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"distance_join_pairs_launch: error {err}")
    return dict(
        set=label, route=route, shape=f"M={len(a)} N={len(b)} pairs={pairs}",
        tested=len(a) * len(b), pairs=pairs,
        kernel=lambda: [torch.from_numpy(x)
                        for x in ops.distance_join_pairs(a, b, dist)],
        plain=lambda: [x.cpu() for x in ref.distance_join_pairs_ref(
            a, b, dist)],
        launch=launch, bound=pairs_bound(len(a), len(b), pairs))


def any_replay(ops, ref, build, label, bits, fi, keys, k) -> dict:
    """One recorded per-filter Bloom probe for `check_path_replays`, as
    `pair_replay`: the kernel alone reads the indices and keys from device
    memory and writes its verdicts there."""
    dev = bits.device
    idx_keys = torch.from_numpy(np.concatenate([fi, keys])).to(dev)
    fi_t, keys_t = idx_keys[:len(fi)], idx_keys[len(fi):]
    out = torch.empty(len(fi), dtype=torch.uint8, device=dev)
    launcher = build.launcher("bloom_probe_any_launch")

    def launch():
        err = launcher(bits.data_ptr(), bits.shape[1], k, idx_keys.data_ptr(),
                       len(fi), len(keys), out.data_ptr(),
                       torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"bloom_probe_any_launch: error {err}")
    return dict(
        set=label, shape=f"F={len(fi)} C={len(keys)} W={bits.shape[1]} k={k}",
        kernel=lambda: [torch.from_numpy(ops.bloom_probe_any(bits, fi, keys,
                                                             k))],
        plain=lambda: [ref.bloom_probe_any_ref(bits, fi_t, keys_t, k).cpu()],
        launch=launch, bound=any_bound(ref, bits, fi, keys, k))


@contextlib.contextmanager
def recording_launches(ops, ref, build, spatial_join, tag,
                       rank_inputs: bool = False):
    """For the duration of the block, wrap the kernel entry points the
    STREAK paths call so that each call is recorded for a replay against
    its plain version; yields {"rank_shapes": (N, M, resident table?) of
    every rank call, "rank_in": with `rank_inputs`, the (table, probes)
    host arrays of each that launches on the card, "descend_in": the inputs of every `tree_descend`
    launch and "descend_sets" the set of each, "fused_in"/"refine_in"/
    "pairs_in"/"any_in": replay dicts (see
    `check_path_replays`) of every `fused_topk_join` launch, grouped
    refinement launch, pair call and per-filter probe, "refine_calls": [the
    `pool_min_dist` calls on the card with pairs]}. tag["set"] names the
    set running."""
    rec = dict(rank_shapes=[], rank_in=[], descend_in=[], descend_sets=[],
               fused_in=[], refine_in=[], refine_calls=[0], pairs_in=[],
               any_in=[])
    merge_join_ranks, tree_descend = ops.merge_join_ranks, ops.tree_descend
    fused_topk_join = ops.fused_topk_join
    refine_group = ops.bucketed_min_core_group
    pool_min_dist = spatial_join.pool_min_dist
    distance_join_pairs = ops.distance_join_pairs
    bloom_probe_any = ops.bloom_probe_any

    def recording_ranks(table, probes, *args, **kwargs):
        if len(table) and len(probes):        # calls that launch
            rec["rank_shapes"].append(
                (len(table), len(probes),
                 kwargs.get("table_on_device") is not None))
            if rank_inputs and ops.resolve_rank_backend(
                    kwargs.get("backend")) == "kernel" and torch.device(
                    kwargs.get("device") or "cpu").type == "cuda":
                rec["rank_in"].append(
                    (np.asarray(table, dtype=np.int64),
                     np.array(probes, dtype=np.int64)))
        return merge_join_ranks(table, probes, *args, **kwargs)

    def recording_descend(node_keys, cs, box_keys):
        rec["descend_in"].append((node_keys, cs.clone(), box_keys.clone()))
        rec["descend_sets"].append(tag["set"])
        return tree_descend(node_keys, cs, box_keys)

    def recording_fused(driver, driven, dk, vk, dist, theta, k,
                        row_qid=None, col_qid=None):
        m, n = driver.shape[0], driven.shape[0]
        zeros = functools.partial(torch.zeros, dtype=torch.int32,
                                  device=driver.device)
        args = tuple(t.clone() for t in (
            driver, driven, dk, vk, dist, theta,
            zeros(m) if row_qid is None else row_qid,
            zeros(n) if col_qid is None else col_qid))
        rows, splits, width = ops.fused_plan(m, n, k)
        rec["fused_in"].append(dict(
            set=tag["set"], shape=f"M={m} N={n} k={k}", m=m, n=n, k=k,
            qids=int(torch.unique(args[6]).numel()),
            plan=dict(block_rows=rows, splits=splits, split_width=width),
            kernel=lambda: ops.fused_topk_join(*args[:6], k=k,
                                               row_qid=args[6],
                                               col_qid=args[7]),
            plain=lambda: ref.fused_topk_join_ref(*args, k),
            bound=fused_bound(m, n, k)))
        return fused_topk_join(driver, driven, dk, vk, dist, theta, k,
                               row_qid, col_qid)

    def recording_refine(buf, group):
        b = buf.clone()
        classes = sorted({(int(x[4]), int(x[5])) for x in group.desc})
        rec["refine_in"].append(dict(
            set=tag["set"], shape=f"dims={group.dims} rows={group.n_rows} "
            f"buckets={len(group.desc)} classes={classes}",
            rows=group.n_rows,
            kernel=lambda: ops.bucketed_min_core_group(b, group),
            plain=lambda: ref.bucketed_min_core_group_ref(b, group.desc,
                                                          group.dims),
            bound=min_core_bound(group)))
        return refine_group(buf, group)

    def recording_pairs(driver, driven, dist, device=None):
        out = distance_join_pairs(driver, driven, dist, device)
        host = isinstance(driver, np.ndarray)
        a, b = ((torch.from_numpy(np.ascontiguousarray(
            x, dtype=np.float32)).to(device) for x in (driver, driven))
            if host else (driver.clone(), driven.clone()))
        if len(a) and len(b):
            rec["pairs_in"].append(pair_replay(
                ops, ref, build, tag["set"],
                "matrix join" if host else "overflow recovery", a, b, dist,
                len(out[0])))
        return out

    def recording_any(bits, fi, keys, k):
        out = bloom_probe_any(bits, fi, keys, k)
        fi = np.array(fi, dtype=np.int64)
        keys = np.array(keys, dtype=np.int64)
        if len(fi) and len(keys):
            rec["any_in"].append(any_replay(ops, ref, build, tag["set"],
                                            bits, fi, keys, k))
        return out

    def counting_refine(pool, rows_a, rows_b, metric="euclid", device=None,
                        **kwargs):
        rec["refine_calls"][0] += len(rows_a) > 0 \
            and torch.device(device).type == "cuda"
        return pool_min_dist(pool, rows_a, rows_b, metric, device, **kwargs)

    ops.merge_join_ranks, ops.tree_descend = recording_ranks, \
        recording_descend
    ops.fused_topk_join = recording_fused
    ops.bucketed_min_core_group = recording_refine
    spatial_join.pool_min_dist = counting_refine
    ops.distance_join_pairs = recording_pairs
    ops.bloom_probe_any = recording_any
    try:
        yield rec
    finally:
        ops.merge_join_ranks, ops.tree_descend = merge_join_ranks, \
            tree_descend
        ops.fused_topk_join = fused_topk_join
        ops.bucketed_min_core_group = refine_group
        spatial_join.pool_min_dist = pool_min_dist
        ops.distance_join_pairs = distance_join_pairs
        ops.bloom_probe_any = bloom_probe_any


def check_merge_join_ranks(ops, ref, dev, entry, cases, call_ms):
    """RANK_SHAPES, every side and both kernel layouts bit-identical to the
    plain version, then the edge tables; times per shape: the kernel alone
    (device_ms) in the layout the wrapper picks and in each layout, a
    tensor call (ms) and torch.searchsorted left + right, beside the
    engine's call times from `rank_call_times` (`call_ms`)."""
    for name, (t_np, p_np) in _rank_edge_inputs(
            np.random.default_rng(7)).items():
        _require_ranks(ops, ref, name, torch.from_numpy(t_np).to(dev),
                       torch.from_numpy(p_np).to(dev))
    rng = np.random.default_rng(6)      # the data of rank_call_times
    for n, m in RANK_SHAPES:
        table_np, probes_np = _rank_inputs(rng, n, m)
        table = torch.from_numpy(table_np).to(dev)
        probes = torch.from_numpy(probes_np).to(dev)
        _require_ranks(ops, ref, f"N={n} M={m}", table, probes)
        words, sectors = rank_words_touched(table, probes)
        ms = time_ms(lambda: ops.insertion_ranks(table, probes), 20)
        km = kernel_ms(lambda: ops.insertion_ranks(table, probes),
                        "merge_join_ranks_kernel")
        out = torch.empty((2, m), dtype=torch.int64, device=dev)
        layout_ms = {
            f"lanes={lanes}": kernel_ms(
                lambda: ops._rank_launch(table, probes, out, "both", lanes),
                "merge_join_ranks_kernel")
            for lanes in (1, 32)}
        plain = time_ms(lambda: ref.merge_join_ranks_ref(table, probes), 5)

        def library():
            return (torch.searchsorted(table, probes, side="left"),
                    torch.searchsorted(table, probes, side="right"))
        # the library's device time, like the kernel's device_ms
        lib = device_ms(library)
        lib_call = time_ms(library, 20)
        # probes read and both ranks written once, each distinct table word
        # that a binary search of these probes reaches read once; ~4
        # integer operations per search step, two searches per probe
        bnd, by = bound_ms(m * 8 * 3 + words * 8,
                           2 * m * int(n).bit_length() * 4)
        case = dict(kernel="merge_join_ranks", N=n, M=m, side="both",
                    lanes=32 if m <= ops.RANK_WARP_MAX_M else 1,
                    table_words=words, table_sectors=sectors, ms=ms,
                    **km, ms_by_layout=layout_ms,
                    **call_ms.get((n, m), {}), plain_ms=plain,
                    library_ms=lib, library_call_ms=lib_call,
                    bound_ms=bnd, bound_by=by)
        cases.append(case)
        if (n, m) == RANK_SHAPES[1]:
            # where the wrapper's choice of layout by M (RANK_WARP_MAX_M)
            # comes from: both layouts over M on the largest path table
            for mm in (1024, 4096, 8192, 16384, 32768, 65536):
                sub = probes[:mm].contiguous()
                o = torch.empty((2, mm), dtype=torch.int64, device=dev)
                cases.append(dict(
                    kernel="merge_join_ranks", sweep="layout", N=n, M=mm,
                    ms_by_layout={
                        f"lanes={lanes}": kernel_ms(
                            lambda: ops._rank_launch(table, sub, o, "both",
                                                     lanes),
                            "merge_join_ranks_kernel")
                        for lanes in (1, 32)}))
        if (n, m) == RANK_SHAPES[0]:
            entry.update(shape=f"N={n} M={m} side=both (the main path's "
                         "median call)", max_abs_err=0.0, ms=ms,
                         **km, plain_ms=plain,
                         library_ms=lib,
                         library_call_ms=lib_call,
                         **call_ms.get((n, m), {}), bound_ms=bnd,
                         bound_by=by)


def check_block_scan(ops, ref, dev, entry, cases):
    """The benchmark's shape (64 x 1024, benchmarks/bench_kernels.py:47) and
    4096 x 4096, theta -1e30 (every score survives) and 0.5; bit-exact."""
    rng = np.random.default_rng(7)
    for nb, bsz in ((64, 1024), (4096, 4096)):
        s = torch.from_numpy(rng.normal(0.5, 0.5, (nb, bsz))
                             .astype(np.float32)).to(dev)
        for theta in (-1e30, 0.5):
            require_equal(f"block_scan {nb}x{bsz} theta={theta}",
                          ops.block_scan(s, theta),
                          ref.block_scan_ref(s, theta))
        ms = time_ms(lambda: ops.block_scan(s, 0.5), 50)
        km = kernel_ms(lambda: ops.block_scan(s, 0.5),
                                "block_scan_kernel",
                        cold_l2=True)
        plain = time_ms(lambda: ref.block_scan_ref(s, 0.5), 10)
        # scores read once, the mask byte and 8 bytes a row written once
        bnd, by = bound_ms(nb * bsz * 5 + nb * 8, nb * bsz * 3)
        cases.append(dict(kernel="block_scan", nb=nb, B=bsz, ms=ms,
                          **km, plain_ms=plain,
                          bound_ms=bnd,
                          bound_by=by))
        if nb == 64:
            entry.update(shape=f"nb={nb} B={bsz}", max_abs_err=0.0, ms=ms,
                         **km, plain_ms=plain,
                          bound_ms=bnd,
                         bound_by=by, library_note="no single PyTorch call "
                         "gives row max, count and mask together")


def morton_inputs(dev, n: int = 1 << 20):
    """n int32 coordinate pairs: 0, 0xFFFF, bit-15 (sign-bit code) cases
    and negative inputs (masked to 16 bits) first, then random ones."""
    rng = np.random.default_rng(8)
    cx = rng.integers(-(1 << 31), (1 << 31) - 1, n).astype(np.int32)
    cy = rng.integers(0, 1 << 16, n).astype(np.int32)
    edge = [(0, 0), (0xFFFF, 0), (0, 0xFFFF), (0xFFFF, 0xFFFF),
            (0x8000, 0x8000), (0, 0x8000), (-1, -1), (-(1 << 31), 0x7FFF)]
    cx[:len(edge)], cy[:len(edge)] = zip(*edge)
    return torch.from_numpy(cx).to(dev), torch.from_numpy(cy).to(dev)


def check_morton(ops, ref, dev, entry):
    x, y = morton_inputs(dev)
    n = x.shape[0]
    got = ops.morton_encode(x, y)
    require_equal("morton_encode 1M", [got], [ref.morton_ref(x, y)])
    if got[:4].tolist() != [0, 0x55555555, -0x55555556, -1]:
        raise AssertionError(f"morton_encode edge codes {got[:4].tolist()}")
    if not bool((got < 0).any()):
        raise AssertionError("morton_encode: no sign-bit code")
    bnd, by = bound_ms(n * 12, n * 16)
    entry.update(
        shape=f"n={n}", max_abs_err=0.0,
        ms=time_ms(lambda: ops.morton_encode(x, y), 50),
        **kernel_ms(lambda: ops.morton_encode(x, y),
                            "morton_encode_kernel", cold_l2=True),
        plain_ms=time_ms(lambda: ref.morton_ref(x, y), 10),
        bound_ms=bnd, bound_by=by,
        library_note="no PyTorch call interleaves bits")


def _qkv(dev, dtype, b, hq, hkv, s, d, seed=0):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return [torch.randn((b, h, s, d), generator=g, device=dev).to(dtype)
            for h in (hq, hkv, hkv)]


def flash_ops(q, causal: bool) -> float:
    """The algorithm's operations: 4*B*Hq*S^2*D, halved when causal."""
    b, hq, s, d = q.shape
    return 4 * b * hq * s * s * d / (2 if causal else 1)


def flash_bound(q, k, causal: bool) -> tuple[float, str]:
    """q/k/v read and o written once; flash_ops at the bf16 tensor-core
    rate or the f32 rate by the dtype."""
    n_bytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    rate = BF16_OPS_PER_S if q.dtype == torch.bfloat16 else F32_OPS_PER_S
    return bound_ms(n_bytes, flash_ops(q, causal), rate)


def flash_p_bf16(q, k, v, causal: bool):
    """The plain version with P = exp(logit - row max) rounded to bf16
    before P V, l summed from the f32 P: a textbook FA2/FA3 kernel's
    rounding, a planted fault of check_flash."""
    s, d = q.shape[2], q.shape[3]
    g = q.shape[1] // k.shape[1]
    kk = k.repeat_interleave(g, dim=1).float()
    vv = v.repeat_interleave(g, dim=1).float()
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * d ** -0.5
    if causal:
        keep = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, float("-inf"))
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    del logits
    l = p.sum(-1, keepdim=True)
    return (torch.einsum("bhqk,bhkd->bhqd", p.to(torch.bfloat16).float(), vv)
            / l).to(q.dtype)


def ptxas_entries(log: str) -> dict:
    """Entry symbol -> registers, spill bytes, static shared memory and
    whether ptxas serialized its wgmma instructions, from a `-Xptxas -v`
    log."""
    entries: dict = {}

    def entry(symbol: str) -> dict:
        return entries.setdefault(symbol, dict(
            registers=None, spill_store_bytes=0, spill_load_bytes=0,
            static_smem_bytes=0, wgmma_serialized=False))
    cur = None
    for ln in log.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", ln):
            cur = entry(m.group(1))
        elif "wgmma.mma_async instructions are serialized" in ln:
            # ptxas names the function, before or after compiling it
            m = re.search(r"function '([^']+)'", ln)
            if m or cur is not None:
                (entry(m.group(1)) if m else cur)["wgmma_serialized"] = True
        elif cur is not None:
            if m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", ln):
                cur["spill_store_bytes"] = int(m.group(1))
                cur["spill_load_bytes"] = int(m.group(2))
            if m := re.search(r"Used (\d+) registers", ln):
                cur["registers"] = int(m.group(1))
            if m := re.search(r"(\d+) bytes smem", ln):
                cur["static_smem_bytes"] = int(m.group(1))
    return entries


def flash_build_report(build) -> list:
    """One row per flash instantiation (dtype, D): ptxas's registers,
    spills and static shared memory, the dynamic shared memory its launcher
    asks for, and the tensor-core instructions (HGMMA, HMMA) in its SASS.
    Raises on a spill, or on a bf16 instantiation without HGMMA."""
    lib = build._target("flash_attention")
    smem = ctypes.CDLL(str(lib)).flash_attention_smem_bytes
    smem.argtypes = [ctypes.c_int, ctypes.c_int]
    sass = subprocess.run(
        [str(pathlib.Path(build._nvcc()).parent / "cuobjdump"), "-sass",
         str(lib)], capture_output=True, text=True, check=True,
        timeout=300).stdout
    mma: collections.Counter = collections.Counter()
    fn = None
    for ln in sass.splitlines():
        if m := re.search(r"Function : (\S+)", ln):
            fn = m.group(1)
        elif fn and (m := re.search(r"\b(HGMMA|HMMA)\.", ln)):
            mma[fn, m.group(1)] += 1
    rows = []
    for sym, info in ptxas_entries(build.build_logs["flash_attention"]).items():
        m = re.search(r"flash_attention_kernel_(bf16|f32)ILi(\d+)E", sym)
        if m is None:
            continue
        dtype, d = m.group(1), int(m.group(2))
        row = dict(dtype=dtype, D=d, **info,
                   dynamic_smem_bytes=smem(d, int(dtype == "bf16")),
                   hgmma=mma[sym, "HGMMA"], hmma=mma[sym, "HMMA"])
        if dtype == "bf16":
            row["registers_note"] = ("ptxas's count at launch; setmaxnreg "
                                     "then gives consumer threads 240, the "
                                     "producer's 24")
        rows.append(row)
    rows.sort(key=lambda r: (r["dtype"], r["D"]))
    if len(rows) != 8:
        raise AssertionError(f"flash build: {len(rows)} instantiations in "
                             "the ptxas log, not 8")
    for r in rows:
        if r["spill_store_bytes"] or r["spill_load_bytes"]:
            raise AssertionError(f"flash build: {r['dtype']} D={r['D']} "
                                 "spills registers")
        if r["dtype"] == "bf16" and not r["hgmma"]:
            raise AssertionError(f"flash build: bf16 D={r['D']} has no "
                                 "HGMMA in its SASS")
    return rows


def flash_errors(got, want) -> tuple[float, float]:
    """(max |got - want|, max |got - want| / (2^-7 |want| + 1e-3)); the
    second is at most 1 within the bf16 limit."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    return (float(diff.max()), float((diff / (
        FLASH_BF16_RTOL * w.abs() + FLASH_BF16_ATOL)).max()))


def require_flash(label: str, got, want) -> tuple[float, float]:
    """The reference's tolerance, and in bf16 the elementwise limit."""
    err, excess = flash_errors(got, want)
    if not err <= FLASH_TOL[want.dtype]:
        raise AssertionError(f"flash_attention {label}: max abs err {err} "
                             f"> {FLASH_TOL[want.dtype]}")
    if want.dtype == torch.bfloat16 and not excess <= 1:
        raise AssertionError(
            f"flash_attention {label}: an element is {excess:.3g}x its "
            f"limit 2^-7 |want| + {FLASH_BF16_ATOL}")
    return err, excess


def check_flash(ops, ref, dev, entry, cases):
    """The LM prefill's shape (gemma-7b: B=1, Hq=Hkv=16, S=4096, D=256,
    bf16, causal), in f32 too, then a sweep: nemotron's GQA (48/8, D=128),
    codeqwen's MHA (32/32, D=128), MQA (16/1, D=256) and gemma's heads at S
    = 128, 256, 1024 (nemotron also 2048), f32 and bf16, causal and not,
    and the MoE prefills' heads (qwen2-moe 16/16, qwen3-moe 32/4, D=128)
    at S = 4096, f32 and bf16, causal; each against the plain version within the reference's tolerance and,
    in bf16, within 2^-7 |want| + 1e-3 elementwise. Three planted faults at
    the prefill shape, computed by the plain version, must fail the bf16
    limit: the last kv tile (32 keys) skipped, q, k, v rounded to fp8
    (e4m3), and P rounded to bf16 before P V (what the kernel's hi + lo
    split avoids). The entry also gets the kernel's achieved TFLOP/s
    (the algorithm's operations over its device time) and its share of
    the bound."""
    import torch.nn.functional as F
    sweep = [(name, hq, hkv, d, s)
             for name, hq, hkv, d in (("nemotron", 48, 8, 128),
                                      ("codeqwen", 32, 32, 128),
                                      ("mqa", 16, 1, 256),
                                      ("gemma", 16, 16, 256))
             for s in (128, 256, 1024)] + [("nemotron", 48, 8, 128, 2048)]
    moe_heads = [("qwen2-moe", 16, 16, 128, 4096),
                 ("qwen3-moe", 32, 4, 128, 4096)]
    for name, hq, hkv, d, s in sweep + moe_heads:
        for dtype in (torch.float32, torch.bfloat16):
            for causal in ((True,) if s == 4096 else (True, False)):
                q, k, v = _qkv(dev, dtype, 1, hq, hkv, s, d, seed=s + hq)
                got = ops.flash_attention(q, k, v, causal)
                want = ref.flash_attention_ref(q, k, v, causal)
                err, excess = require_flash(
                    f"{name} S={s} {dtype} causal={causal}", got, want)
                case = dict(kernel="flash_attention", heads=name, Hq=hq,
                            Hkv=hkv, D=d, S=s, dtype=str(dtype)[6:],
                            causal=causal, max_abs_err=err,
                            elements_differing=int((got != want).sum()))
                if dtype == torch.bfloat16:
                    case["max_err_over_limit"] = excess
                if causal and (dtype == torch.bfloat16 or s == 4096):
                    case.update(kernel_ms(
                        lambda: ops.flash_attention(q, k, v, causal),
                        "flash_attention_kernel", 5))
                    case["bound_ms"], case["bound_by"] = flash_bound(
                        q, k, causal)
                if s == 4096:                   # the MoE prefills' shapes
                    case["plain_ms"] = time_ms(
                        lambda: ref.flash_attention_ref(q, k, v, causal), 2)
                    print("flash moe " + json.dumps(case), flush=True)
                cases.append(case)
    b, h, s, d = 1, 16, 4096, 256
    q, k, v = _qkv(dev, torch.float32, b, h, h, s, d, seed=1)
    err32, _ = require_flash("at the prefill shape in f32",
                             ops.flash_attention(q, k, v, True),
                             ref.flash_attention_ref(q, k, v, True))
    cases.append(dict(kernel="flash_attention", heads="gemma", Hq=h, Hkv=h,
                      D=d, S=s, dtype="float32", causal=True,
                      max_abs_err=err32, **kernel_ms(
                          lambda: ops.flash_attention(q, k, v, True),
                          "flash_attention_kernel", 3)))
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    got = ops.flash_attention(q, k, v, True)
    want = ref.flash_attention_ref(q, k, v, True)
    err, excess = require_flash("at the prefill shape", got, want)
    # planted faults, each held to the same two limits as the kernel
    tail = want.clone()
    tail[:, :, -32:] = ref.flash_attention_ref(
        q[:, :, -32:], k[:, :, :-32], v[:, :, :-32], False)
    fp8 = ref.flash_attention_ref(
        *(x.to(torch.float8_e4m3fn).to(x.dtype) for x in (q, k, v)), True)
    p_bf16 = flash_p_bf16(q, k, v, True)
    faults = {}
    for fault, out in (("last_kv_tile_skipped", tail),
                       ("fp8_operands", fp8), ("p_rounded_to_bf16", p_bf16)):
        f_err, f_excess = flash_errors(out, want)
        faults[fault] = dict(max_abs_err=f_err, max_err_over_limit=f_excess,
                             passes_reference_tol=f_err <= FLASH_TOL[
                                 torch.bfloat16])
        if not f_excess > 1:
            raise AssertionError(f"flash_attention: the planted fault "
                                 f"{fault} passes the bf16 limit")
    del tail, fp8, p_bf16

    def library():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              enable_gqa=True)
    lib_err, lib_excess = flash_errors(library(), want)
    entry["bound_ms"], entry["bound_by"] = flash_bound(q, k, True)
    entry.update(
        shape=f"B={b} Hq={h} Hkv={h} S={s} D={d} bf16 causal",
        max_abs_err=err, max_err_over_limit=excess,
        tolerance=f"{FLASH_TOL[torch.bfloat16]} abs and 2^-7|want| + "
                  f"{FLASH_BF16_ATOL} elementwise",
        agreement=f"max abs err {err:.3g} <= {FLASH_TOL[torch.bfloat16]}, "
                  f"largest element {excess:.3g} of 2^-7|want| + "
                  f"{FLASH_BF16_ATOL}; f32 {err32:.3g} <= "
                  f"{FLASH_TOL[torch.float32]}",
        f32_max_abs_err=err32, planted_faults=faults,
        ms=time_ms(lambda: ops.flash_attention(q, k, v, True), 5),
        **kernel_ms(lambda: ops.flash_attention(q, k, v, True),
                            "flash_attention_kernel", 5),
        plain_ms=time_ms(lambda: ref.flash_attention_ref(q, k, v, True), 3),
        library_ms=device_ms(library, reps=5),
        library_call_ms=time_ms(library, 5), library_max_abs_err=lib_err,
        library_max_err_over_limit=lib_excess,
        library_note="F.scaled_dot_product_attention(is_causal=True, "
                     "enable_gqa=True), device time")
    # the trace's time where the trace holds the kernel (it drops spans
    # now and then), else the events'
    t_ms, clock = ((entry["device_ms"], "trace")
                   if entry["device_ms"] is not None
                   else (entry["event_ms"], "events"))
    entry["tflops"] = flash_ops(q, True) / t_ms / 1e9
    entry["bound_share"] = entry["bound_ms"] / t_ms
    entry["rate_clock"] = clock
    print("flash planted faults " + json.dumps(faults), flush=True)
    print(f"flash rate: {entry['tflops']:.1f} TFLOP/s of the algorithm's "
          f"{flash_ops(q, True) / 1e9:.1f} GFLOP, {entry['bound_share']:.3f}"
          f" of the bound (by {clock})", flush=True)


# ------------------------------------------------------- end-to-end phase --
def run_queries(rt, datasets, join, device, tag=None):
    """{(dataset, qi): ((scores, rows, stats), wall ms)} for one backend;
    tag["set"] names the set running."""
    out = {}
    for name, (ds, n_q) in datasets.items():
        if tag is not None:
            tag["set"] = name
        cfg = rt.ExecConfig(policy=rt.BackendPolicy(join=join,
                                                    **SLICE_POLICY))
        eng = rt.StreakEngine(ds.store, cfg, device=device)
        for qi in range(n_q):
            t0 = time.perf_counter()
            res = eng.execute(ds.queries[qi])
            if device == "cuda":
                torch.cuda.synchronize()
            out[(name, qi)] = (res, (time.perf_counter() - t0) * 1e3)
    return out


def shape_queries(rt, ds) -> dict:
    """The Geographica shapes over hotels <-> parks, built as in
    tests/test_shapes.py: {name: Query}."""
    ns, Var, TP = ds.ns, rt.Var, rt.TriplePattern
    pa, pb = Var("place"), Var("nplace")
    patterns = (
        TP(pa, Var("typePred1"), ns["class:hotel"], g=Var("r")),
        TP(Var("r"), ns["hasConfidence"], Var("conf")),
        TP(pa, ns["hasGeometry"], Var("g1")),
        TP(pb, Var("typePred2"), ns["class:park"], g=Var("r1")),
        TP(Var("r1"), ns["hasConfidence"], Var("conf1")),
        TP(pb, ns["hasGeometry"], Var("g2")))
    filters = {
        "range": rt.SpatialFilter(Var("g1"), None,
                                  window=(15.0, 10.0, 70.0, 60.0)),
        "within": rt.SpatialFilter(Var("g1"), None, dist=18.0,
                                   center=(50.0, 30.0)),
        "join": rt.SpatialFilter(Var("g1"), Var("g2"), dist=1.0),
        "knn": rt.SpatialFilter(Var("g1"), Var("g2"), knn=4),
    }
    return {name: rt.Query(select=(pa, pb), patterns=patterns, spatial=f,
                           ranking=None) for name, f in filters.items()}


def run_shapes(rt, ds, queries, join, device) -> dict:
    """{shape: ((scores, rows, stats), wall ms)} for one backend."""
    cfg = rt.ExecConfig(policy=rt.BackendPolicy(join=join, **SLICE_POLICY))
    eng = rt.StreakEngine(ds.store, cfg, device=device)
    out = {}
    for name, q in queries.items():
        t0 = time.perf_counter()
        res = eng.execute(q)
        if device == "cuda":
            torch.cuda.synchronize()
        out[name] = (res, (time.perf_counter() - t0) * 1e3)
    return out


def passes_in_turns(rt, ds, n_q, turns) -> list:
    """A query set (fused join) once per (label, policy) of `turns`, one
    fresh engine per pass, untraced: wall ms per pass on the card."""
    passes = []
    for label, pol in turns:
        cfg = rt.ExecConfig(policy=rt.BackendPolicy(join="fused", **pol))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng = rt.StreakEngine(ds.store, cfg, device="cuda")
        for qi in range(n_q):
            eng.execute(ds.queries[qi])
        torch.cuda.synchronize()
        passes.append(dict(label=label,
                           wall_ms=(time.perf_counter() - t0) * 1e3))
    return passes


def untraced_turns(rt, datasets) -> dict:
    """Before any profiler session (see `rank_call_times`), after one
    warm-up pass of each set: LGD Q1-Q8 with the Bloom probes and the rank
    pass on the host and on their kernels, in turns (host, kernel, kernel,
    host), then each set with the rank pass alone on numpy and on its
    kernel, in turns."""
    for ds, n_q in datasets.values():
        passes_in_turns(rt, ds, n_q, [("warm-up", SLICE_POLICY)])
    order = ("numpy", "kernel", "kernel", "numpy")
    ds, n_q = datasets["lgd"]
    out = {"probe/rank lgd": passes_in_turns(rt, ds, n_q, [
        (x, HOST_PROBE_RANK if x == "numpy" else SLICE_POLICY)
        for x in order])}
    for name, (ds, n_q) in datasets.items():
        out[f"rank {name}"] = passes_in_turns(
            rt, ds, n_q, [(x, dict(SLICE_POLICY, rank=x)) for x in order])
    return out


def device_spans(prof) -> list:
    """(start us, end us, name) of every kernel and copy in a trace."""
    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)


def busy_union_us(spans) -> float:
    """Microseconds in which the device ran at least one of the spans."""
    busy_us, end = 0.0, float("-inf")
    for start, stop, _ in spans:
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
    return busy_us


# chip_smoke's layer labels, by the program's spans (`repro_torch.tracing`)
# whose self times each sums
LAYER_SPANS = {"plan": ("exec.plan",),
               "driver blocks": ("exec.materialize",),
               "phase 1-2 (SIP)": ("sip.select", "sip.descend",
                                   "sip.node_select"),
               "APS": ("driven.aps",),
               "driven retrieval": ("driven.nplan", "driven.splan"),
               "phase 3": ("phase3.prepare", "phase3.join", "phase3.flush"),
               "refine + top-k": ("refine.emit", "refine.exact")}


def layer_ms(spans: dict, names: list) -> dict:
    """{layer label: host ms} of drained program spans: the self times of
    each label's spans (so no nested layer counts twice)."""
    from repro_torch import tracing
    by_name = np.bincount(spans["name"], weights=tracing.self_ns(spans),
                          minlength=len(names)) / 1e6
    return {label: float(sum(by_name[names.index(n)] for n in parts
                             if n in names))
            for label, parts in LAYER_SPANS.items()}


def trace_queries(rt, name, ds, n_q, join, policy=SLICE_POLICY) -> dict:
    """One traced pass of a query set on the card: host ms per executor
    layer (the self times of the program's spans), device busy ms (the
    union of the kernel and copy intervals of a torch.profiler trace) and
    the device's idle share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import tracing
    cfg = rt.ExecConfig(policy=rt.BackendPolicy(join=join, **policy))
    torch.cuda.synchronize()
    tracing.drain()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tracing.enable()
        t0 = time.perf_counter()
        eng = rt.StreakEngine(ds.store, cfg, device="cuda")
        for qi in range(n_q):
            eng.execute(ds.queries[qi])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        tracing.disable()
    host = layer_ms(*tracing.drain())
    spans = device_spans(prof)
    busy_us = busy_union_us(spans)
    by_kind: dict = collections.defaultdict(float)
    for start, stop, ev_name in spans:
        kind = next((k for k in REPLACES if k in ev_name),
                    "memcpy" if "memcpy" in ev_name.lower() else "other")
        by_kind[kind] += (stop - start) / 1e3
    host["other"] = wall_ms - sum(host.values())
    return dict(dataset=name, join=join, probe=policy["probe"],
                rank=policy["rank"], queries=n_q, wall_ms=wall_ms,
                device_busy_ms=busy_us / 1e3 if spans else None,
                device_idle_share=1 - busy_us / 1e3 / wall_ms
                if spans else None,
                device_ms_by_kind=dict(by_kind), host_ms_by_layer=host)


def same_answer(got, want) -> bool:
    (gs, gr, gst), (ws, wr, wst) = got, want
    return (np.array_equal(gs, ws) and list(gr) == list(wr)
            and all(np.array_equal(gr[c], wr[c]) for c in wr)
            and dataclasses.asdict(gst) == dataclasses.asdict(wst))


def check_answers(label: str, runs: dict, cpu_runs: dict) -> None:
    """Every CUDA answer well formed and equal to its CPU run, or raise."""
    for key, (res, _) in runs.items():
        scores, rows, _ = res
        if not (np.isfinite(scores).all()
                and all(len(v) == len(scores) for v in rows.values())):
            raise AssertionError(f"{label} {key}: malformed answer")
        if not same_answer(res, cpu_runs[key][0]):
            raise AssertionError(f"{label} {key}: CUDA answer differs from "
                                 "the CPU run")


def store_bank_uploads(sets, bank_uploads, dev) -> dict:
    """{"set bank": uploads to the card so far} of the stores' Bloom banks
    (`bank_uploads` counts `ops.device_bloom_bank` by bank and device);
    raises where a bank went up more than once."""
    out = {}
    for name, (ds, _) in sets.items():
        for which in ("self", "in", "out"):
            bank = getattr(ds.store.tree, f"bloom_{which}")
            out[f"{name} {which}"] = bank_uploads[id(bank.bits), dev.type]
    if max(out.values()) > 1 or not any(out.values()):
        raise AssertionError(f"Bloom banks: uploads {out}, not one a bank "
                             "probed")
    return out


def require_launched(path: str, launches: dict, names) -> None:
    for name in names:
        if launches[name] == 0:
            raise AssertionError(f"{name} never launched on {path}")


# ------------------------------------------------ the STREAK serving loop --
# the reference benchmark's traffic (benchmarks/bench_serve.py:55-75):
# eight tenants on eight slots, one k each
SERVE_KS = (5, 10, 20, 40, 60, 80, 100, 120)
SERVE_SLOTS = 8
SERVE_POLICIES = {"fused": dict(SLICE_POLICY, join="fused", kcap="auto"),
                  "kernel": dict(SLICE_POLICY, join="kernel")}
# counters that must read 0 on the card: the loop's crash isolation must
# not hide a kernel or device fault
SERVE_FAULT_COUNTERS = ("faults", "pooled_fallbacks", "failed_requests",
                        "admission_failures")


def serve_mixes(ds) -> dict:
    """hotq: Q1 eight times, one k each; mixed: Q1-Q8, one k each."""
    return {"hotq": [dataclasses.replace(ds.queries[0], k=k)
                     for k in SERVE_KS],
            "mixed": [dataclasses.replace(q, k=k)
                      for q, k in zip(ds.queries, SERVE_KS)]}


def serve_config(rt, policy: str):
    return rt.ExecConfig(policy=rt.BackendPolicy(**SERVE_POLICIES[policy]))


def serve_batch(rt, ds, policy: str, queries, device: str):
    """One batch of tenants through a fresh `SpatialServeEngine`:
    (engine, requests), synchronised on the card."""
    from repro_torch.serve.spatial import SpatialServeEngine
    srv = SpatialServeEngine(ds.store, serve_config(rt, policy),
                             max_slots=SERVE_SLOTS, device=device)
    reqs = srv.serve(queries)
    if device == "cuda":
        torch.cuda.synchronize()
    return srv, reqs


def require_clean_serve(label: str, srv, reqs) -> None:
    """Every request done without an error, every fault counter 0."""
    bad = {c: getattr(srv.stats, c) for c in SERVE_FAULT_COUNTERS
           if getattr(srv.stats, c)}
    errs = {r.rid: repr(r.error) for r in reqs
            if r.error is not None or not r.done}
    if bad or errs:
        raise AssertionError(f"serve {label}: fault counters {bad}, "
                             f"requests with errors {errs}")


def require_same_rows(label: str, scores, rows, want) -> None:
    ws, wr = want[0], want[1]
    if not (np.array_equal(scores, ws) and list(rows) == list(wr)
            and all(np.array_equal(rows[c], wr[c]) for c in wr)):
        raise AssertionError(f"{label}: served answer differs")


def serve_turns(rt, ds, rounds: int = 2) -> list:
    """Before any profiler session: for each policy and mix, a batch
    through a fresh serving engine against the reference benchmark's two
    baselines, `serial_perquery` (a fresh engine a query) and `serial_warm`
    (one engine, warmed, back to back), in turns (serve, perquery, warm,
    warm, perquery, serve) `rounds` times; wall ms on the host clock ending
    in a synchronise, medians. Every served request equal to serial
    execution."""
    out = []
    for policy in SERVE_POLICIES:
        cfg = serve_config(rt, policy)
        for mix, queries in serve_mixes(ds).items():
            serial = [rt.StreakEngine(ds.store, cfg, device="cuda")
                      .execute(q) for q in queries]
            warm = rt.StreakEngine(ds.store, cfg, device="cuda")
            for q in queries:
                warm.execute(q)
            serve_batch(rt, ds, policy, queries, "cuda")        # warm-up
            samples = collections.defaultdict(list)
            for _ in range(rounds):
                for label in ("serve", "serial_perquery", "serial_warm",
                              "serial_warm", "serial_perquery", "serve"):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    if label == "serve":
                        srv, reqs = serve_batch(rt, ds, policy, queries,
                                                "cuda")
                    elif label == "serial_perquery":
                        res = [rt.StreakEngine(ds.store, cfg, device="cuda")
                               .execute(q) for q in queries]
                    else:
                        res = [warm.execute(q) for q in queries]
                    torch.cuda.synchronize()
                    samples[label].append((time.perf_counter() - t0) * 1e3)
                    if label == "serve":
                        require_clean_serve(f"{policy} {mix}", srv, reqs)
                        res = [(r.scores, r.rows) for r in reqs]
                    for i, (got, want) in enumerate(zip(res, serial)):
                        require_same_rows(f"{label} {policy} {mix} #{i}",
                                          got[0], got[1], want)
            med = {k: float(np.median(v)) for k, v in samples.items()}
            out.append(dict(
                policy=policy, mix=mix, queries=len(queries),
                serve_ms=med["serve"],
                serial_perquery_ms=med["serial_perquery"],
                serial_warm_ms=med["serial_warm"],
                queries_per_s=len(queries) / med["serve"] * 1e3,
                speedup_vs_serial_perquery=med["serial_perquery"]
                / med["serve"],
                speedup_vs_serial_warm=med["serial_warm"] / med["serve"],
                samples_ms=dict(samples), steps=srv.stats.steps,
                sip_batches=srv.stats.sip_batches,
                sip_blocks=srv.stats.sip_blocks,
                join_launches=srv.stats.join_launches))
    return out


def trace_serve(rt, ops, ds, policy: str, mix: str, queries) -> dict:
    """One traced serve batch on the card: wall ms, device busy ms (the
    union of kernel and copy intervals), idle share, kernel launches (all
    kernels, `ops.LAUNCHES`) a step, memcpy device ms and count, spans
    by kind."""
    from torch.profiler import ProfilerActivity, profile
    before = sum(ops.LAUNCHES.values())
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        srv, reqs = serve_batch(rt, ds, policy, queries, "cuda")
        wall_ms = (time.perf_counter() - t0) * 1e3
    require_clean_serve(f"traced {policy} {mix}", srv, reqs)
    launches = sum(ops.LAUNCHES.values()) - before
    spans = device_spans(prof)
    busy_ms = busy_union_us(spans) / 1e3
    by_kind: dict = collections.defaultdict(float)
    n_kind: collections.Counter = collections.Counter()
    for start, stop, ev_name in spans:
        kind = next((k for k in REPLACES if k in ev_name),
                    "memcpy" if "memcpy" in ev_name.lower() else "other")
        by_kind[kind] += (stop - start) / 1e3
        n_kind[kind] += 1
    return dict(policy=policy, mix=mix, wall_ms=wall_ms,
                steps=srv.stats.steps, launches=launches,
                launches_per_step=launches / srv.stats.steps,
                device_busy_ms=busy_ms if spans else None,
                device_idle_share=1 - busy_ms / wall_ms if spans else None,
                memcpy_ms=by_kind.get("memcpy", 0.0),
                memcpy_count=n_kind["memcpy"],
                device_ms_by_kind=dict(by_kind),
                spans_by_kind=dict(n_kind))


def descend_replays(ops, ref, captured, sets) -> list:
    """`tree_descend` launches in `check_path_replays`' form."""
    out = []
    for args, label in zip(captured, sets):
        node_keys, cs, box_keys = args
        nb, m, n = box_keys.shape[0], box_keys.shape[1], node_keys.shape[1]
        tests = descend_tests(node_keys, cs, box_keys)
        out.append(dict(
            set=label, shape=f"B={nb} M={m} N={n}",
            kernel=lambda a=args: ops.tree_descend(*a),
            plain=lambda a=args: ref.tree_descend_ref(*a),
            bound=bound_ms(4 * n * 8 + n + nb * m * 32 + nb * n, tests * 4)))
    return out


def check_serve_ranks(ops, ref, rank_in, cases, path="serve") -> None:
    """The serving loop's rank calls, from their recorded tables and
    probes: the median and the largest call by (probes, table rows), every
    side through the wrapper and through both layouts bit-identical to the
    plain version (`_require_ranks`, as `check_merge_join_ranks` holds the
    serial path's shapes), then timed; a "case" line each, with "path":
    "serve", or `path`)."""
    if not rank_in:
        raise AssertionError(f"{path}: no merge_join_ranks launch recorded")
    by_size = sorted(range(len(rank_in)), key=lambda i: (
        len(rank_in[i][1]), len(rank_in[i][0]), i))
    for label, i in (("median", by_size[len(by_size) // 2]),
                     ("largest", by_size[-1])):
        table, probes = (torch.from_numpy(x).cuda() for x in rank_in[i])
        n, m = table.shape[0], probes.shape[0]
        _require_ranks(ops, ref, f"{path} {label} N={n} M={m}", table,
                       probes)
        words, sectors = rank_words_touched(table, probes)
        bnd, by = bound_ms(m * 8 * 3 + words * 8,
                           2 * m * int(n).bit_length() * 4)
        case = dict(
            kernel="merge_join_ranks", path=path, call=label,
            launches=len(rank_in), N=n, M=m, side="both",
            lanes=32 if m <= ops.RANK_WARP_MAX_M else 1, table_words=words,
            table_sectors=sectors,
            **kernel_ms(lambda: ops.insertion_ranks(table, probes),
                        "merge_join_ranks_kernel"),
            plain_ms=time_ms(lambda: ref.merge_join_ranks_ref(table, probes),
                             5),
            bound_ms=bnd, bound_by=by)
        cases.append(case)
        print("case " + json.dumps(case), flush=True)


# the kernels whose calls `recording_launches` keeps for a replay: name,
# the symbol of its trace spans, the record's key
RECORDED = (("fused_topk_join", "fused_topk_join_kernel", "fused_in"),
            ("tree_descend", "tree_descend_kernel", "descend_in"),
            ("distance_join", "distance_join_kernel", "pairs_in"),
            ("bucketed_min_core", "bucketed_min_core_kernel", "refine_in"),
            ("bloom_probe", "bloom_probe_any_kernel", "any_in"))


def require_recorded(path: str, launches: dict, rec, retries: int) -> None:
    """Every launch of a recorded run (`launches`, the counts read right
    after it) is one recorded call: a `fused_topk_join` launch, a pair call
    or a capacity retry, a refinement call, a descent with nodes and
    boxes, a per-filter probe, a rank call on the card."""
    calls = dict(
        fused_topk_join=len(rec["fused_in"]),
        distance_join=len(rec["pairs_in"]) + retries,
        bucketed_min_core=rec["refine_calls"][0],
        tree_descend=sum(1 for nk, _, b in rec["descend_in"]
                         if nk.shape[1] and b.shape[0]),
        bloom_probe=len(rec["any_in"]), merge_join_ranks=len(rec["rank_in"]))
    if {n: launches[n] for n in STREAK_KERNELS} != calls:
        raise AssertionError(
            f"{path}: launches {launches} for the recorded calls {calls} "
            f"({retries} pair capacity retries): every launch must be one "
            "recorded call, one refinement launch a refinement call")


def replay_recorded(ops, ref, rec, cases, path: str, required=STREAK_KERNELS,
                    by_set: bool = False) -> None:
    """Every call that `recording_launches` (with `rank_inputs`) kept,
    replayed on the card bit for bit against its plain version and timed
    (`check_path_replays`; "case" lines with "path": `path`, or one a set
    with `by_set`), and the rank kernel at the median and largest recorded
    call (`check_serve_ranks`). A kernel of `required` with no recorded
    call fails."""
    launching = [(a, s) for a, s in zip(rec["descend_in"],
                                        rec["descend_sets"])
                 if a[0].shape[1] and a[2].shape[0]]
    recorded = dict(rec, descend_in=descend_replays(
        ops, ref, [a for a, _ in launching], [s for _, s in launching]))
    print(f"{path} descend launches (B, M, N): " + json.dumps(sorted(
        collections.Counter(r["shape"] for r in recorded["descend_in"])
        .items())), flush=True)
    for name, symbol, key in RECORDED:
        rs = recorded[key]
        if not rs:
            if name in required:
                raise AssertionError(f"{path}: no {name} launch recorded")
            continue
        groups = ({s: [r for r in rs if r["set"] == s]
                   for s in dict.fromkeys(r["set"] for r in rs)}
                  if by_set else {path: rs})
        check_path_replays(name, symbol, rs, None, cases, groups=groups)
    if rec["rank_in"] or "merge_join_ranks" in required:
        check_serve_ranks(ops, ref, rec["rank_in"], cases, path=path)


def check_serve(rt, ops, ref, build, spatial_join, ds, cases) -> dict:
    """The serving loop on the card, both policies and both mixes, with
    the counts set to 0 before and read after: every STREAK kernel
    launched; each batch clean (`require_clean_serve`), equal request by
    request and counter by counter to the same batch on the CPU, and
    every request equal to serial CUDA execution on a fresh engine; under
    the fused join the mixed batch must pool (a launch with two or more
    query ids, more SIP rows than SIP calls). Every launch must be one
    recorded call (one refinement launch a refinement call). Then every
    recorded `fused_topk_join`, `tree_descend`, pair call, grouped
    refinement and per-filter probe replayed bit for bit against its
    plain version, and the rank kernel at the median and largest recorded
    call (`check_serve_ranks`) ("case" lines with "path": "serve"), and
    one traced batch of each ("serve trace")."""
    tag: dict = {}
    runs, run_launches = {}, {}
    with recording_launches(ops, ref, build, spatial_join, tag,
                            rank_inputs=True) as rec:
        ops.reset_launch_counts()
        retries = ops.pair_capacity_retries
        for policy in SERVE_POLICIES:
            for mix, queries in serve_mixes(ds).items():
                tag["set"] = f"serve {policy} {mix}"
                before = dict(ops.LAUNCHES)
                runs[policy, mix] = serve_batch(rt, ds, policy, queries,
                                                "cuda")
                run_launches[f"{policy} {mix}"] = {
                    n: ops.LAUNCHES[n] - before[n] for n in STREAK_KERNELS}
        launches = dict(ops.LAUNCHES)
        retries = ops.pair_capacity_retries - retries
    require_launched("the serving loop", launches, STREAK_KERNELS)
    require_recorded("serving loop", launches, rec, retries)
    stats = {}
    for (policy, mix), (srv, reqs) in runs.items():
        label = f"{policy} {mix}"
        require_clean_serve(label, srv, reqs)
        cpu_srv, cpu_reqs = serve_batch(rt, ds, policy,
                                        serve_mixes(ds)[mix], "cpu")
        if dataclasses.asdict(srv.stats) != dataclasses.asdict(cpu_srv.stats):
            raise AssertionError(f"serve {label}: ServeStats {srv.stats} on "
                                 f"the card, {cpu_srv.stats} on the CPU")
        cfg = serve_config(rt, policy)
        for req, cpu_req in zip(reqs, cpu_reqs):
            if not (same_answer((req.scores, req.rows, req.stats),
                                (cpu_req.scores, cpu_req.rows,
                                 cpu_req.stats))
                    and (req.steps, req.waited) == (cpu_req.steps,
                                                    cpu_req.waited)):
                raise AssertionError(f"serve {label} #{req.rid}: the card's "
                                     "request differs from the CPU's")
            serial = rt.StreakEngine(ds.store, cfg, device="cuda").execute(
                req.query)
            require_same_rows(f"serve {label} #{req.rid} vs serial",
                              req.scores, req.rows, serial)
            if not (np.isfinite(req.scores).all()
                    and len(req.scores) <= req.query.k
                    and all(len(v) == len(req.scores)
                            for v in req.rows.values())):
                raise AssertionError(f"serve {label} #{req.rid}: malformed")
        if not any(len(r.scores) == r.query.k for r in reqs):
            raise AssertionError(f"serve {label}: no request filled its k")
        stats[label] = dataclasses.asdict(srv.stats)
        print(f"serve run {label}: {len(reqs)} requests = cpu = serial; "
              f"stats {json.dumps(stats[label])}; launches "
              f"{json.dumps(run_launches[label])}", flush=True)
    mixed_fused = [r for r in rec["fused_in"] if r["set"] == "serve fused mixed"]
    srv = runs["fused", "mixed"][0]
    if not (any(r["qids"] >= 2 for r in mixed_fused)
            and srv.stats.sip_blocks > srv.stats.sip_batches):
        raise AssertionError(
            f"serve fused mixed: no pooling (qids a launch "
            f"{[r['qids'] for r in mixed_fused]}, sip_blocks "
            f"{srv.stats.sip_blocks}, sip_batches {srv.stats.sip_batches})")
    fused_launches = [dict(set=r["set"], rows=r["m"], cols=r["n"], k=r["k"],
                           qids=r["qids"], **r["plan"])
                      for r in rec["fused_in"]]
    qids = collections.Counter(r["qids"] for r in fused_launches)
    print(f"serve fused launches: {len(fused_launches)}; qids a launch "
          f"{dict(sorted(qids.items()))}; rows max "
          f"{max(r['rows'] for r in fused_launches)}, cols max "
          f"{max(r['cols'] for r in fused_launches)}; splits "
          f"{dict(collections.Counter(r['splits'] for r in fused_launches))}",
          flush=True)
    replay_recorded(ops, ref, rec, cases, "serve")
    traces = [trace_serve(rt, ops, ds, policy, mix, queries)
              for policy in SERVE_POLICIES
              for mix, queries in serve_mixes(ds).items()]
    for t in traces:
        print("serve trace " + json.dumps(t), flush=True)
    return dict(launches={n: launches[n] for n in STREAK_KERNELS},
                run_launches=run_launches, stats=stats,
                fused_launches=fused_launches, traces=traces)


# ------------------------------------------------- the sharded store ----
# shard counts per set: lgd at 2, 4 and 8 (Q1-Q8), scale1m at 4 (Q1-Q2)
SHARD_SETS = {"lgd": (2, 4, 8), "scale1m": (4,)}
# the sharded lgd store the CPU run, the serving loop and the failover
# phase use
SHARD_CHECKED = ("lgd", 4)


def sharded_bound(node_keys, cs, box_keys) -> tuple[float, str]:
    """One sharded descent: the stacked planes, root-path masks and boxes
    read once, the (S, B, N_max) masks written once; four compares a box
    test, counted over the S·N_max columns as one launch sees them."""
    s, _, n = node_keys.shape
    nb, m = box_keys.shape[0], box_keys.shape[1]
    tests = descend_tests(node_keys.transpose(0, 1).reshape(4, s * n),
                          cs.reshape(s * n), box_keys)
    return bound_ms(4 * s * n * 8 + s * n + nb * m * 32 + nb * s * n,
                    tests * 4)


def require_same_rows_by_name(label: str, scores, rows, want) -> None:
    """Equal scores and rows, in order, column by column: a sharded run's
    relation may list its columns in another order than an unsharded
    one's (as the reference's does)."""
    ws, wr = want[0], want[1]
    if not (np.array_equal(scores, ws) and sorted(rows) == sorted(wr)
            and all(np.array_equal(rows[c], wr[c]) for c in wr)):
        raise AssertionError(f"{label}: the answer differs")


def check_sharded(rt, ops, ref, datasets, unsharded, bank_uploads, dev,
                  entry, cases) -> dict:
    """The main path over Morton-prefix sharded stores (`shard_store`):
    lgd at S = 2, 4, 8 (Q1-Q8) and scale1m at S = 4 (Q1-Q2), both joins,
    under the accelerator policy, with the counts set to 0 before and read
    after: every STREAK kernel launched, every `tree_descend` launch one
    `ops.tree_descend_sharded` call (one launch over all shards); rows,
    scores and order equal to the unsharded card run's (`unsharded`), and
    lgd at S = 4 equal to its CPU run in full (plan log and statistics: a
    sharded run logs one APS decision a shard); every shard tree's Bloom
    banks uploaded at most once. Then the serving loop's hotq and mixed
    traffic on the lgd S = 4 store, each request equal to serial CUDA
    execution, and every recorded sharded descent replayed bit for bit
    against its plain version ("case" lines with a "sharded" path).
    Returns the report; `entry` (tree_descend's) gains "sharded"."""
    import types
    from repro_torch.core import shard as shard_mod
    stores, report = {}, dict(stores={})
    for name, counts in SHARD_SETS.items():
        ds, n_q = datasets[name]
        for s in counts:
            t0 = time.perf_counter()
            store = shard_mod.shard_store(ds.store, s)
            sizes = [sh.tree.n_nodes for sh in store.tree_shards]
            stores[name, s] = types.SimpleNamespace(store=store,
                                                    queries=ds.queries)
            report["stores"][f"{name} S={s}"] = dict(
                build_s=time.perf_counter() - t0, shard_nodes=sizes,
                shard_tree_bytes=store.shard_tree_nbytes())
            print(f"shard {name} S={s}: shard trees of {sizes} nodes "
                  f"({datasets[name][0].store.tree.n_nodes} unsharded), "
                  f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    recorded: list = []
    tag: dict = {}
    sharded_descend = ops.tree_descend_sharded

    def recording(node_keys, cs, box_keys):
        out = sharded_descend(node_keys, cs, box_keys)
        recorded.append((tag["set"], node_keys, cs.clone(), box_keys.clone()))
        return out

    runs = {}
    ops.tree_descend_sharded = recording
    try:
        ops.reset_launch_counts()
        for (name, s), sds in stores.items():
            for join in ("fused", "kernel"):
                tag["set"] = f"{name} S={s}"
                runs[name, s, join] = run_queries(
                    rt, {name: (sds, datasets[name][1])}, join, "cuda")
        launches = dict(ops.LAUNCHES)
    finally:
        ops.tree_descend_sharded = sharded_descend
    require_launched("the sharded path", launches, STREAK_KERNELS)
    if launches["tree_descend"] != len(recorded) or not recorded:
        raise AssertionError(
            f"sharded path: {launches['tree_descend']} tree_descend launches "
            f"for {len(recorded)} sharded descents: not one launch a call")
    for (name, s, join), got in runs.items():
        for key, (res, _) in got.items():
            scores, rows, _ = res
            if not np.isfinite(scores).all():
                raise AssertionError(f"sharded {name} S={s} {join} {key}: "
                                     "malformed answer")
            require_same_rows_by_name(
                f"sharded {name} S={s} {join} Q{key[1] + 1} vs unsharded",
                scores, rows, unsharded[join][key][0])
    name, s = SHARD_CHECKED
    for join in ("fused", "kernel"):
        check_answers(f"sharded {name} S={s} {join}", runs[name, s, join],
                      run_queries(rt, {name: (stores[name, s],
                                              datasets[name][1])},
                                  join, "cpu"))
    uploads = {}
    for (name, s), sds in stores.items():
        for si, sh in enumerate(sds.store.tree_shards):
            for which in ("self", "in", "out"):
                bank = getattr(sh.tree, f"bloom_{which}")
                uploads[f"{name} S={s} shard {si} {which}"] = bank_uploads[
                    id(bank.bits), dev.type]
    if max(uploads.values()) > 1 or not any(uploads.values()):
        raise AssertionError(f"sharded Bloom banks: uploads {uploads}, not "
                             "one a bank probed")
    print("sharded bloom bank uploads " + json.dumps(uploads), flush=True)
    shapes = collections.Counter(
        (nk.shape[0], b.shape[0], b.shape[1], nk.shape[2])
        for _, nk, _, b in recorded)
    print(f"sharded descents on the path: {len(recorded)}; (S, B, M, N_max) "
          f"{sorted(shapes.items())}", flush=True)
    report.update(launches={n: launches[n] for n in STREAK_KERNELS},
                  clean_q1=runs["lgd", 4, "fused"]["lgd", 0][0],
                  descents=len(recorded), bloom_uploads=uploads,
                  descent_shapes=[[*k, v] for k, v in sorted(shapes.items())])

    # the serving loop on the lgd S = 4 store
    sds = stores[SHARD_CHECKED]
    lgd = datasets["lgd"][0]
    ops.reset_launch_counts()
    served = {(policy, mix): serve_batch(rt, sds, policy, queries, "cuda")
              for policy in SERVE_POLICIES
              for mix, queries in serve_mixes(sds).items()}
    serve_launches = {n: ops.LAUNCHES[n] for n in STREAK_KERNELS}
    require_launched("the serving loop on a sharded store", serve_launches,
                     STREAK_KERNELS)
    for (policy, mix), (srv, reqs) in served.items():
        label = f"sharded serve {policy} {mix}"
        require_clean_serve(label, srv, reqs)
        serial = rt.StreakEngine(lgd.store, serve_config(rt, policy),
                                 device="cuda")
        for req in reqs:
            require_same_rows_by_name(f"{label} #{req.rid} vs serial",
                                      req.scores, req.rows,
                                      serial.execute(req.query))
        print(f"{label}: {len(reqs)} requests = serial (unsharded); stats "
              f"{json.dumps(dataclasses.asdict(srv.stats))}", flush=True)
    report["serve_launches"] = serve_launches

    launches_in = []
    for label, nk, cs, b in recorded:
        args = (nk, cs, b)
        launches_in.append(dict(
            set=label, shape=f"S={nk.shape[0]} B={b.shape[0]} "
            f"M={b.shape[1]} N_max={nk.shape[2]}",
            kernel=lambda a=args: ops.tree_descend_sharded(*a),
            plain=lambda a=args: ref.tree_descend_sharded_ref(*a),
            bound=sharded_bound(*args)))
    groups = {f"sharded {k}": [r for r in launches_in if r["set"] == k]
              for k in dict.fromkeys(r["set"] for r in launches_in)}
    groups["sharded all"] = launches_in
    n_cases = len(cases)
    check_path_replays("tree_descend", "tree_descend_kernel", launches_in,
                       None, cases, groups=groups)
    # the trace of a whole replay sequence may miss spans: the median launch
    # of each group is traced alone too, the mean over the spans the trace
    # holds, with their count, beside its events
    medians = {}
    for label, rs in groups.items():
        med = sorted(rs, key=lambda r: r["event_ms"])[len(rs) // 2]
        trace_ms, spans = traced_spans(med["kernel"], "tree_descend_kernel",
                                       20)
        medians[label] = dict(shape=med["shape"], launches=len(rs),
                              trace_ms=trace_ms, trace_spans=spans,
                              trace_spans_expected=20,
                              event_ms=event_ms(med["kernel"]),
                              bound_ms=med["bound"][0],
                              bound_by=med["bound"][1])
        print(f"sharded descent median {label}: "
              + json.dumps(medians[label]), flush=True)
    summary = next(c for c in cases[n_cases:]
                   if c.get("path") == "sharded all")
    entry["sharded"] = {k: summary[k] for k in (
        "launches", "event_ms_sum", "device_ms_sum", "bound_ms_sum",
        "median_shape", "median_event_ms", "median_device_ms",
        "median_call_ms", "median_plain_ms", "median_bound_ms",
        "median_bound_by")}
    entry["sharded"]["medians"] = medians
    report["tree_descend"] = entry["sharded"]
    report["turns"] = sharded_turns(rt, datasets["lgd"][0], stores)
    return report


def traced_spans(fn, symbol: str, reps: int) -> tuple[float | None, int]:
    """(mean device ms of the spans of kernels named `symbol` that a trace
    of `reps` calls of `fn` holds, how many it holds): unlike `device_ms`,
    a span the trace misses does not lower the mean."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = [stop - start for start, stop, name in device_spans(prof)
             if symbol in name]
    return (sum(spans) / len(spans) / 1e3 if spans else None), len(spans)


def sharded_turns(rt, lgd, stores) -> list:
    """Host wall ms of lgd Q1-Q8 (fused join, accelerator policy, a fresh
    engine a pass, untraced, ending in a synchronise) over the unsharded
    store (S = 1) and the sharded ones, in turns (1, 2, 4, 8, 8, 4, 2, 1).
    Taken after the profiler sessions of the earlier phases, which make
    every CUDA call of the process cost more on the host, for both sides
    alike."""
    rows = []
    for s in (1, 2, 4, 8, 8, 4, 2, 1):
        store = lgd.store if s == 1 else stores["lgd", s].store
        eng = rt.StreakEngine(store, rt.ExecConfig(policy=rt.BackendPolicy(
            join="fused", **SLICE_POLICY)), device="cuda")
        t0 = time.perf_counter()
        for q in lgd.queries:
            eng.execute(q)
        torch.cuda.synchronize()
        rows.append(dict(S=s, wall_ms=(time.perf_counter() - t0) * 1e3))
    print("sharded turns " + json.dumps(rows), flush=True)
    return rows


# ------------------------------------------------------ the failover layer --
# each chained op with the join whose lgd Q1 run dispatches it under the
# accelerator policy, the shard count of its store and the attempt that
# takes over from the kernel
FAILOVER_OPS = {
    "distance_join_matrix": ("kernel", 1, "plain"),
    "fused_topk_join": ("fused", 1, "plain"),
    "bucketed_min_core": ("fused", 1, "plain"),
    "merge_join_ranks": ("fused", 1, "plain"),
    "tree_descend": ("fused", 1, "plain"),
    "bloom_probe": ("fused", 1, "plain"),
    "tree_descend_sharded": ("fused", 4, "sequential"),
}


def require_clean_fault_layer(fault, ops, label: str) -> None:
    """No plan installed, no watchdog armed, every `FaultStats` counter 0
    and no fallback attempt counted in `ops.LAUNCHES`: outside the failover
    phase nothing may fail over, and nothing may fail."""
    stats = {k: v for k, v in dataclasses.asdict(fault.STATE.stats).items()
             if v}
    fallbacks = {k: v for k, v in ops.LAUNCHES.items() if ":" in k and v}
    if fault.STATE.plan is not None or fault.STATE.watchdog_s is not None \
            or stats or fallbacks:
        raise AssertionError(
            f"{label}: the fault layer is not clean: plan "
            f"{fault.STATE.plan}, watchdog {fault.STATE.watchdog_s}, "
            f"counters {stats}, fallback launches {fallbacks}")


def check_failover(rt, ops, fault, lgd, clean, dev) -> list:
    """The fault layer on the card, over lgd Q1 under the accelerator
    policy: each chained op failed once (`FaultRule(op, call=0)`) and
    corrupted once must answer as the clean run (`clean`: {(join, shards):
    answer}), with a fallback counted and the plain attempt in
    `ops.LAUNCHES`, the corruption detected; a delay under an armed
    watchdog times out and recovers; three exhausted chains open a breaker
    and demote the stage at a `resolve()` under the plan, and at none
    after it; launch errors (outside the fault classes), more than open
    the kernel's breaker, propagate with no plain attempt and no demotion.
    Ends with the fault layer reset."""
    from repro_torch.core import shard as shard_mod
    stores = {1: lgd.store, 4: shard_mod.shard_store(lgd.store, 4)}
    q = lgd.queries[0]

    def run(join, shards):
        eng = rt.StreakEngine(stores[shards], rt.ExecConfig(
            policy=rt.BackendPolicy(join=join, **SLICE_POLICY)),
            device="cuda")
        res = eng.execute(q)
        torch.cuda.synchronize()
        return res

    rows = []
    for op, (join, shards, takeover) in FAILOVER_OPS.items():
        # a corruption of every call: one with an empty result (a pair call
        # with no pairs) has nothing to poison
        for rule in (dict(call=0), dict(mode="corrupt")):
            fault.STATE.reset()
            ops.reset_launch_counts()
            plan = fault.FaultPlan(rules=(fault.FaultRule(op=op, **rule),))
            t0 = time.perf_counter()
            with fault.fault_plan(plan):
                res = run(join, shards)
            ms = (time.perf_counter() - t0) * 1e3
            st = fault.STATE.stats
            key = f"{op}:{takeover}"
            row = dict(op=op, mode=rule.get("mode", "fail"),
                       injected=plan.injected, calls=plan.calls.get(op, 0),
                       fallbacks=st.fallbacks,
                       corruptions=st.corruptions_detected,
                       takeover_launches=ops.LAUNCHES.get(key, 0), ms=ms)
            print("failover " + json.dumps(row), flush=True)
            if not same_answer(res, clean[join, shards]):
                raise AssertionError(f"failover {op} {row['mode']}: the "
                                     "answer differs from the clean run")
            if plan.injected < 1 or st.fallbacks < 1 \
                    or row["takeover_launches"] < 1 or (
                        row["mode"] == "corrupt"
                        and st.corruptions_detected < 1):
                raise AssertionError(f"failover {op}: {row}")
            rows.append(row)

    # a delay past an armed watchdog times out; the plain version answers
    fault.STATE.reset()
    ops.reset_launch_counts()
    plan = fault.FaultPlan(rules=(fault.FaultRule(
        op="fused_topk_join", call=0, mode="delay", delay_s=1.0),))
    with fault.fault_plan(plan), fault.watchdog(0.25):
        res = run("fused", 1)
    row = dict(op="fused_topk_join", mode="delay", injected=plan.injected,
               timeouts=fault.STATE.stats.timeouts,
               takeover_launches=ops.LAUNCHES.get("fused_topk_join:plain", 0))
    if not fault.STATE.join_abandoned(timeout=60):
        raise AssertionError("failover: an abandoned attempt never ended")
    print("failover " + json.dumps(row), flush=True)
    if not (same_answer(res, clean["fused", 1]) and row["timeouts"] >= 1
            and row["takeover_launches"] >= 1):
        raise AssertionError(f"failover watchdog: {row}")
    rows.append(row)

    # three exhausted chains open the kernel's breaker; resolve() demotes
    fault.STATE.reset()
    node_keys = torch.zeros((4, 64), dtype=torch.int64, device=dev)
    cs = torch.ones(64, dtype=torch.bool, device=dev)
    boxes = torch.zeros((2, 8, 4), dtype=torch.int64, device=dev)
    with fault.fault_plan(fault.FaultPlan(rules=(
            fault.FaultRule(op="tree_descend", attempts=99),))):
        for _ in range(fault.STATE.breaker_threshold):
            try:
                ops.tree_descend(node_keys, cs, boxes)
            except fault.FallbackExhausted:
                continue
            raise AssertionError("failover: an exhausted chain answered")
        demoted = rt.BackendPolicy(**SLICE_POLICY).resolve()
    # with the plan gone, the open breaker reroutes nothing
    idle = rt.BackendPolicy(**SLICE_POLICY).resolve()
    row = dict(op="tree_descend", mode="breaker",
               breaker_open=fault.STATE.breaker("tree_descend", "kernel").open,
               descend=demoted.descend, probe=demoted.probe,
               descend_with_no_plan=idle.descend,
               policy_demotions=fault.STATE.stats.policy_demotions)
    print("failover " + json.dumps(row), flush=True)
    if not (row["breaker_open"] and demoted.descend == "numpy"
            and demoted.probe == "kernel" and idle.descend == "kernel"
            and row["policy_demotions"] == 1):
        raise AssertionError(f"failover breaker: {row}")
    rows.append(row)

    # a launch error is no fault of the fault layer's: it propagates, and
    # no plain attempt runs, plan or no plan
    fault.STATE.reset()
    ops.reset_launch_counts()
    launcher = ops._build.launcher

    def failing(name):
        return (lambda *args: 700) if name == "tree_descend" \
            else launcher(name)
    ops._build.launcher = failing
    raised = []
    try:
        # under an empty plan, then with none: more launch errors than open
        # the kernel's breaker, and still no call leaves the kernel
        for plan, n in ((fault.FaultPlan(), 1),
                        (None, fault.STATE.breaker_threshold)):
            with fault.fault_plan(plan):
                for call in ([lambda: ops.tree_descend(node_keys, cs, boxes)]
                             * n + [lambda: run("fused", 1)]):
                    try:
                        call()
                    except RuntimeError as e:
                        raised.append(type(e).__name__ + ": " + str(e))
        idle = rt.BackendPolicy(**SLICE_POLICY).resolve()
    finally:
        ops._build.launcher = launcher
    row = dict(op="tree_descend", mode="launch error", raised=raised,
               breaker_open=fault.STATE.breaker("tree_descend", "kernel").open,
               descend=idle.descend,
               policy_demotions=fault.STATE.stats.policy_demotions,
               fallbacks=fault.STATE.stats.fallbacks,
               plain_launches=ops.LAUNCHES.get("tree_descend:plain", 0))
    print("failover " + json.dumps(row), flush=True)
    if len(raised) != 3 + fault.STATE.breaker_threshold \
            or not all(r.startswith("RuntimeError") and "error 700" in r
                       for r in raised) \
            or not row["breaker_open"] or idle.descend != "kernel" \
            or row["policy_demotions"] or row["fallbacks"] \
            or row["plain_launches"]:
        raise AssertionError(f"failover launch error: {row}")
    rows.append(row)
    fault.STATE.reset()
    ops.reset_launch_counts()
    return rows

# ------------------------------------------------ the baseline engines --
# the paper's comparisons (core/baselines.py) beside STREAK (APS), each a
# fresh engine under the accelerator policy with the fused join; the
# baselines run on lgd, the full scan and STREAK on yago too
BASELINE_ENGINES = {"lgd": ("streak", "fullscan", "sync_rtree", "fixed_n",
                            "fixed_s"),
                    "yago": ("streak", "fullscan")}


def baseline_engine(rt, store, which: str, device: str):
    from repro_torch.core import baselines
    cfg = rt.ExecConfig(policy=rt.BackendPolicy(join="fused",
                                                **SLICE_POLICY))
    if which == "fullscan":
        return baselines.FullScanEngine(store, device=device)
    if which == "sync_rtree":
        return baselines.SyncRTreeEngine(store, cfg, device=device)
    if which in ("fixed_n", "fixed_s"):
        return baselines.fixed_plan_engine(store, which[-1].upper(), cfg,
                                           device=device)
    return rt.StreakEngine(store, cfg, device=device)


def baseline_turns(rt, sets, turns: int = 3) -> dict:
    """Before any profiler session: per set, the engines of
    `BASELINE_ENGINES` over Q1-Q8 in turns (forward, reversed, forward), a
    fresh engine a pass, untraced; per engine and query the wall ms of each
    turn (ending in a synchronise) and their median, and per query the
    full scan's median over STREAK's (the paper's Fig. 10)."""
    out = {}
    for name, engines in BASELINE_ENGINES.items():
        ds = sets[name]
        ms = {e: [[] for _ in ds.queries] for e in engines}
        for t in range(turns):
            for which in (engines if t % 2 == 0 else engines[::-1]):
                eng = baseline_engine(rt, ds.store, which, "cuda")
                for qi, q in enumerate(ds.queries):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    eng.execute(q)
                    torch.cuda.synchronize()
                    ms[which][qi].append((time.perf_counter() - t0) * 1e3)
        med = {e: [float(np.median(x)) for x in ms[e]] for e in engines}
        out[name] = dict(
            turns=ms, median_ms=med,
            pass_median_ms={e: sum(med[e]) for e in engines},
            fullscan_over_streak=[f / s for f, s in zip(med["fullscan"],
                                                        med["streak"])])
    return out


def sync_join_candidates(store, full, q, dev) -> int:
    """The candidate pairs of one sync R-tree join over both full sides'
    entity boxes (`rtree.build_str`, `sync_distance_join` at the plan's
    normalized distance), refined on the card: the pairs the full scan's
    cell-list filter keeps, found by another index."""
    from repro_torch.core import rtree, spatial_join
    plan = full._plan(q)
    ents = []
    for side in (plan.driver, plan.driven):
        e = np.unique(full._full_side(side)[side.entity_var])
        boxes = store.spatial_box_of(e)
        ok = ~np.isnan(boxes[:, 0])
        ents.append((e[ok], boxes[ok]))
    (ua, ba), (ub, bb) = ents
    i, j = rtree.sync_distance_join(rtree.build_str(ba), rtree.build_str(bb),
                                    plan.dist_norm)
    keep = spatial_join.refine(i, j, store.geom_pool,
                               store.geom_rows(ua[i]), store.geom_rows(ub[j]),
                               plan.dist_world, plan.metric, device=dev)
    return int(keep.sum())


def check_baselines(rt, ops, ref, build, spatial_join, sets, cases,
                    entry) -> dict:
    """The baseline engines on the card, with the counts set to 0 before
    and read after: on each set the full scan and STREAK, on lgd also the
    sync R-tree engine and both fixed plans. Each equals its CPU run
    (rows, scores, statistics) and STREAK's scores; on lgd a sync R-tree
    join over both full sides refines to the full scan's candidates.
    `bucketed_min_core` and `merge_join_ranks` must have launched, every
    launch one recorded call, and every recorded call is replayed bit for
    bit ("case" lines with the engine and set as path); the full scan's
    largest refinement launch again on its own, with its trace and event
    times (`entry["fullscan_largest"]`)."""
    tag: dict = {}
    runs = {}
    with recording_launches(ops, ref, build, spatial_join, tag,
                            rank_inputs=True) as rec:
        ops.reset_launch_counts()
        retries = ops.pair_capacity_retries
        for name, engines in BASELINE_ENGINES.items():
            ds = sets[name]
            for which in engines:
                tag["set"] = f"{which} {name}"
                eng = baseline_engine(rt, ds.store, which, "cuda")
                runs[name, which] = [eng.execute(q) for q in ds.queries]
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        retries = ops.pair_capacity_retries - retries
    require_launched("the baselines", launches,
                     ("bucketed_min_core", "merge_join_ranks"))
    require_recorded("baselines", launches, rec, retries)
    rows = []
    for name, engines in BASELINE_ENGINES.items():
        ds = sets[name]
        full = baseline_engine(rt, ds.store, "fullscan", "cuda")
        for which in engines:
            cpu = baseline_engine(rt, ds.store, which, "cpu")
            for qi, q in enumerate(ds.queries):
                got = runs[name, which][qi]
                if not same_answer(got, cpu.execute(q)):
                    raise AssertionError(f"baselines {which} {name} Q{qi + 1}"
                                         ": the card differs from the CPU")
                want = runs[name, "streak"][qi][0]
                if not np.array_equal(np.sort(got[0]), np.sort(want)):
                    raise AssertionError(f"baselines {which} {name} Q{qi + 1}"
                                         ": scores differ from STREAK's")
        for qi, q in enumerate(ds.queries):
            st = runs[name, "fullscan"][qi][2]
            row = dict(set=name, q=qi + 1,
                       rows=len(runs[name, "streak"][qi][0]),
                       **dataclasses.asdict(st))
            if name == "lgd":
                row["sync_join_candidates"] = sync_join_candidates(
                    ds.store, full, q, "cuda")
                row["sync_rtree_join"] = dataclasses.asdict(
                    runs[name, "sync_rtree"][qi][2].join)
                row["plan_logs"] = {
                    w: "".join(runs[name, w][qi][2].plan_log)
                    for w in ("streak", "sync_rtree", "fixed_n", "fixed_s")}
                if row["sync_join_candidates"] != st.candidates:
                    raise AssertionError(
                        f"baselines lgd Q{qi + 1}: the sync R-tree join "
                        f"refines to {row['sync_join_candidates']} pairs, "
                        f"the full scan to {st.candidates}")
            rows.append(row)
            print("baselines " + json.dumps(row), flush=True)
    if not any(r["candidates"] for r in rows):
        raise AssertionError("baselines: no query had a candidate pair")
    replay_recorded(ops, ref, rec, cases, "baselines",
                    required=("bucketed_min_core", "merge_join_ranks"),
                    by_set=True)
    largest = max((r for r in rec["refine_in"]
                   if r["set"].startswith("fullscan")),
                  key=lambda r: r["rows"])
    require_equal(f"bucketed_min_core fullscan largest {largest['shape']}",
                  _outputs(largest["kernel"]()), _outputs(largest["plain"]()))
    # traced alone; a trace that misses a span gives no time
    reps = 20
    trace_ms, spans = traced_spans(largest["kernel"],
                                   "bucketed_min_core_kernel", reps)
    entry["fullscan_largest"] = dict(
        shape=largest["shape"], device_ms=trace_ms if spans == reps else None,
        trace_spans=spans, trace_spans_expected=reps,
        event_ms=event_ms(largest["kernel"], reps),
        call_ms=time_ms(largest["kernel"], reps),
        plain_ms=time_ms(largest["plain"], 5), bound_ms=largest["bound"][0],
        bound_by=largest["bound"][1])
    print("baselines fullscan largest refinement launch " + json.dumps(
        entry["fullscan_largest"]), flush=True)
    return dict(launches={n: launches[n] for n in STREAK_KERNELS},
                queries=rows, fullscan_largest=entry["fullscan_largest"])


# ------------------------------------------------------ ingested data ----
def ingest_queries(rt, d) -> dict:
    """One top-k join ranked by an ingested numeric column and the four
    shapes over stops, as tests/test_torch_ingest.py builds them."""
    ns, Var, TP = d.ns, rt.Var, rt.TriplePattern

    def side(sfx=""):
        s, g = Var(f"stop{sfx}"), Var(f"geo{sfx}")
        return s, g, (TP(s, ns["rdf:type"], ns["gtfs:Stop"],
                         g=Var(f"r{sfx}")),
                      TP(s, ns["hasGeometry"], g))
    (s, g, pats), (s2, g2, pats2) = side(), side("2")
    board = Var("board")
    out = {"topk": rt.Query(
        select=(s, s2),
        patterns=pats + pats2 + (TP(s, ns["gtfs:daily_boardings"], board),),
        spatial=rt.SpatialFilter(g, g2, 0.01),
        ranking=rt.Ranking(((board, 1.0),), descending=True), k=7)}
    for name, f in (
            ("range", rt.SpatialFilter(g, None, window=(-122.42, 37.78,
                                                        -122.39, 37.80))),
            ("within", rt.SpatialFilter(g, None, dist=0.02,
                                        center=(-122.4075, 37.7880))),
            ("join", rt.SpatialFilter(g, g2, dist=0.005)),
            ("knn", rt.SpatialFilter(g, g2, knn=3))):
        binary = f.b is not None
        out[name] = rt.Query(select=(s, s2) if binary else (s,),
                             patterns=pats + pats2 if binary else pats,
                             spatial=f, ranking=None)
    return out


def check_ingest(rt, ops, ref, build, spatial_join, cases) -> dict:
    """The port's GTFS sample through `build_stops_store`, then the top-k
    query and the four shapes on the card under both joins, with the
    counts set to 0 before and read after: every launch one recorded call,
    replayed bit for bit ("case" lines with "path": "ingest"); STREAK equal
    to its CPU run and, after the counts are read, to the full scan on the
    card (scores; for the shapes rows in canonical order too), the full
    scan equal to its CPU run."""
    from repro_torch.core.baselines import FullScanEngine
    from repro_torch.data import ingest
    t0 = time.perf_counter()
    d = ingest.build_stops_store(ingest.SAMPLE)
    build_s = time.perf_counter() - t0
    queries = ingest_queries(rt, d)

    def config(join):
        return rt.ExecConfig(policy=rt.BackendPolicy(join=join,
                                                     **SLICE_POLICY))
    tag = {"set": "ingest"}
    runs = {}
    with recording_launches(ops, ref, build, spatial_join, tag,
                            rank_inputs=True) as rec:
        ops.reset_launch_counts()
        retries = ops.pair_capacity_retries
        for join in ("fused", "kernel"):
            eng = rt.StreakEngine(d.store, config(join), device="cuda")
            for name, q in queries.items():
                runs[join, name] = eng.execute(q)
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        retries = ops.pair_capacity_retries - retries
    require_launched("the ingested store", launches,
                     ("bucketed_min_core", "merge_join_ranks",
                      "tree_descend"))
    require_recorded("ingest", launches, rec, retries)
    full = {name: FullScanEngine(d.store).execute(q)
            for name, q in queries.items()}
    rows = []
    for (join, name), got in runs.items():
        cpu = rt.StreakEngine(d.store, config(join), device="cpu")
        if not same_answer(got, cpu.execute(queries[name])):
            raise AssertionError(f"ingest {join} {name}: the card differs "
                                 "from the CPU")
        want = full[name]
        ok = np.array_equal(got[0], want[0]) and (
            name == "topk" or all(np.array_equal(got[1][c], want[1][c])
                                  for c in want[1]))
        if not ok or len(got[0]) == 0:
            raise AssertionError(f"ingest {join} {name}: {len(got[0])} rows,"
                                 " not the full scan's")
        rows.append(dict(join=join, query=name, rows=len(got[0])))
    cpu_full = FullScanEngine(d.store, device="cpu")
    for name, q in queries.items():
        if not same_answer(full[name], cpu_full.execute(q)):
            raise AssertionError(f"ingest full scan {name}: the card differs "
                                 "from the CPU")
    replay_recorded(ops, ref, rec, cases, "ingest",
                    required=("bucketed_min_core", "merge_join_ranks",
                              "tree_descend"))
    out = dict(n_stops=d.n_stops, numeric=d.numeric_columns,
               strings=d.string_columns, build_s=build_s, queries=rows,
               launches={n: launches[n] for n in STREAK_KERNELS})
    print("ingest " + json.dumps(out), flush=True)
    return out


# ------------------------------------------------ the differential fuzzer --
FUZZ_QUERIES, FUZZ_SEED, FUZZ_FAULT_RATE = 50, 2026, 0.05


def fuzz_agrees(kind, got, want) -> bool:
    """Top-k: the same sorted scores, as many rows; a shape: the same
    scores and rows in canonical order."""
    if kind == "topk":
        return (np.array_equal(np.sort(got[0]), np.sort(want[0]))
                and all(len(v) == len(got[0]) for v in got[1].values()))
    return (np.array_equal(got[0], want[0])
            and sorted(got[1].keys()) == sorted(want[1].keys())
            and all(np.array_equal(got[1][c], want[1][c]) for c in want[1]))


def check_fuzz(rt, ops, ref, build, spatial_join, fault, sets,
               cases) -> dict:
    """`FUZZ_QUERIES` random queries (`fuzz_queries.sample`, the
    differential tests' generator) over the fuzzer's stores (`make_lgd(60)`
    at seeds 0 and 1), each under the accelerator policy with the fused or
    the matrix join on the card, with the counts set to 0 before and read
    after: every STREAK kernel launched, every launch one recorded call,
    replayed bit for bit ("case" lines with "path": "fuzz"). After the
    counts are read, every answer equal to the same query on the CPU and
    to the full scan on the card. Then the same queries under
    `FaultPlan(rate=FUZZ_FAULT_RATE, seed=7)`: the same answers, at least
    one fallback, no exhausted chain. The fault layer and the fallback
    counts are reset after."""
    from repro_torch.core.baselines import FullScanEngine
    from repro_torch.data import fuzz_queries
    rng = np.random.default_rng(FUZZ_SEED)
    queries = []
    for i in range(FUZZ_QUERIES):
        seed = int(rng.integers(2))
        kind, params, q = fuzz_queries.sample(sets[seed].ns, rng)
        queries.append(dict(seed=seed, kind=kind, params=params, q=q,
                            join=("fused", "kernel")[i % 2]))

    def run_all(device="cuda") -> list:
        out = []
        for c in queries:
            cfg = rt.ExecConfig(policy=rt.BackendPolicy(
                join=c["join"], **SLICE_POLICY), fused_batch_cols=256)
            out.append(rt.StreakEngine(sets[c["seed"]].store, cfg,
                                       device=device).execute(c["q"]))
        if device == "cuda":
            torch.cuda.synchronize()
        return out

    tag = {"set": "fuzz"}
    t0 = time.perf_counter()
    with recording_launches(ops, ref, build, spatial_join, tag,
                            rank_inputs=True) as rec:
        ops.reset_launch_counts()
        retries = ops.pair_capacity_retries
        clean = run_all()
        launches = dict(ops.LAUNCHES)
        retries = ops.pair_capacity_retries - retries
    clean_s = time.perf_counter() - t0
    require_launched("the fuzzer's queries", launches, STREAK_KERNELS)
    require_recorded("fuzz", launches, rec, retries)
    oracle = [FullScanEngine(sets[c["seed"]].store).execute(c["q"])
              for c in queries]
    for i, (c, got, want, cpu) in enumerate(zip(queries, clean, oracle,
                                                 run_all("cpu"))):
        if not same_answer(got, cpu):
            raise AssertionError(f"fuzz #{i} {c['kind']} {c['params']} "
                                 f"{c['join']}: the card differs from the "
                                 "CPU")
        if not fuzz_agrees(c["kind"], got, want):
            raise AssertionError(f"fuzz #{i} {c['kind']} {c['params']} "
                                 f"{c['join']}: STREAK differs from the "
                                 "full scan")
    replay_recorded(ops, ref, rec, cases, "fuzz")
    del rec
    t0 = time.perf_counter()
    fault.STATE.reset()
    ops.reset_launch_counts()
    plan = fault.FaultPlan(rate=FUZZ_FAULT_RATE, seed=7)
    with fault.fault_plan(plan):
        faulted = run_all()
    st = dataclasses.asdict(fault.STATE.stats)
    fallback_launches = {k: v for k, v in ops.LAUNCHES.items() if ":" in k}
    fault_s = time.perf_counter() - t0
    for i, (c, got, want) in enumerate(zip(queries, faulted, oracle)):
        if not fuzz_agrees(c["kind"], got, want):
            raise AssertionError(f"fuzz #{i} {c['kind']} {c['params']} "
                                 f"{c['join']}: under the fault rate STREAK "
                                 "differs from the full scan")
    if plan.injected < 1 or st["fallbacks"] < 1 or st["exhausted"]:
        raise AssertionError(f"fuzz fault lane: {plan.injected} injected, "
                             f"stats {st}")
    fault.STATE.reset()
    ops.reset_launch_counts()
    out = dict(queries=len(queries),
               kinds=dict(collections.Counter(c["kind"] for c in queries)),
               rows=sum(len(r[0]) for r in clean),
               empty=sum(len(r[0]) == 0 for r in clean),
               launches={n: launches[n] for n in STREAK_KERNELS},
               clean_s=clean_s, fault_rate=FUZZ_FAULT_RATE,
               injected=plan.injected, fault_stats=st,
               fallback_launches=fallback_launches, fault_s=fault_s)
    print("fuzz " + json.dumps(out), flush=True)
    return out


ANALYTICS_STEADY = ("plan_n", "plan_s", "join_rows", "early", "same")


def check_analytics(ops, ref, build, spatial_join, cases) -> dict:
    """One `python -m repro_torch.launch.analytics --n 2000` run in this
    process, with the counts set to 0 before and read after and the full
    scan's launches told apart from STREAK's (`FullScanEngine.execute`
    wrapped): STREAK's scores equal the full scan's on every query,
    STREAK's own refinement, rank, descent and Bloom launches (the default
    policy, whose Phase-3 join is the host's), every launch one recorded
    call, replayed bit for bit ("case" lines per engine). Then the same
    run on the CPU: each query's plans, join rows, early stop and
    agreement equal."""
    from repro_torch.core.baselines import FullScanEngine
    from repro_torch.launch import analytics
    tag = {"set": "analytics streak"}
    full_launches = collections.Counter()
    execute = FullScanEngine.execute

    def full_execute(self, q):
        before = dict(ops.LAUNCHES)
        tag["set"] = "analytics fullscan"
        try:
            return execute(self, q)
        finally:
            tag["set"] = "analytics streak"
            full_launches.update({n: ops.LAUNCHES[n] - before[n]
                                  for n in STREAK_KERNELS})
    with recording_launches(ops, ref, build, spatial_join, tag,
                            rank_inputs=True) as rec:
        FullScanEngine.execute = full_execute
        try:
            ops.reset_launch_counts()
            retries = ops.pair_capacity_retries
            r = analytics.main(["--n", "2000"])
            torch.cuda.synchronize()
            launches = dict(ops.LAUNCHES)
            retries = ops.pair_capacity_retries - retries
        finally:
            FullScanEngine.execute = execute
    require_recorded("analytics", launches, rec, retries)
    streak = {n: launches[n] - full_launches[n] for n in STREAK_KERNELS}
    require_launched("the analytics launcher's STREAK runs", streak,
                     ("bucketed_min_core", "merge_join_ranks", "tree_descend",
                      "bloom_probe"))
    if len(r["queries"]) != 8 or not all(q["same"] for q in r["queries"]):
        raise AssertionError("analytics: STREAK and the full scan disagree")
    cpu = analytics.analytics(2000, "cpu")
    for qi, (got, want) in enumerate(zip(r["queries"], cpu["queries"])):
        got, want = ({k: x[k] for k in ANALYTICS_STEADY} for x in (got, want))
        if got != want:
            raise AssertionError(f"analytics Q{qi + 1}: the card's {got}, "
                                 f"the CPU's {want}")
    replay_recorded(ops, ref, rec, cases, "analytics",
                    required=("bucketed_min_core", "merge_join_ranks",
                              "tree_descend", "bloom_probe"), by_set=True)
    out = dict(n_quads=r["n_quads"], device=r["device"], launches=streak,
               fullscan_launches=dict(full_launches), queries=r["queries"])
    print("analytics " + json.dumps(out), flush=True)
    return out


# ------------------------------------------------- the LM serving stack --
# Full-width gemma-7b (bf16) agreements are held to a relative RMS error,
# ||got - want|| / ||want|| over all elements, of at most LM_REL_TOL; see
# check_lm_prefill for the reason and the two controls that calibrate it,
# and check_lm_serve for the two planted decode faults it must catch.
LM_REL_TOL = 4e-2
SMOKE_TOL = 1e-4        # f32 smoke configs, card against CPU
PREFILL_PLAIN_CHUNK = 2048      # the prefills' plain path: query chunks


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    g, w = got.double(), want.double()
    return float((g - w).norm() / w.norm())


def tree_to(tree: dict, dev, copy: bool = False) -> dict:
    """`tree`'s tensors on `dev`, detached; with `copy`, always new ones."""
    from repro_torch import pytree
    return pytree.tree_map(lambda x: x.detach().to(dev, copy=copy), tree)


def traced(fn) -> dict:
    """One traced call of `fn`: wall ms (ending in a synchronise), device
    busy ms (union of the kernel and copy intervals), idle share, and the
    count and device ms of the kernels by name fragment."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = device_spans(prof)
    busy_us = busy_union_us(spans)
    flash_us = sum(stop - start for start, stop, name in spans
                   if "flash_attention_kernel" in name)
    return dict(wall_ms=wall_ms, device_busy_ms=busy_us / 1e3,
                device_idle_share=1 - busy_us / 1e3 / wall_ms,
                device_ops=len(spans), flash_device_ms=flash_us / 1e3)


def check_lm_prefill(ops, ref, tr, cfg, params, dev,
                     seq: int = 4096) -> dict:
    """gemma-7b prefill at full width and depth, B=1 x S=4096:
    `forward_with_cache` through the flash kernel against the plain path
    (attn_chunk=2048, the reference prefill cell's setting) and against
    `forward` + `logits_fn`.

    Tolerance LM_REL_TOL = 4e-2 relative RMS on the last-token logits and
    on the K/V caches. Both sides compute attention in f32 from the same
    bf16 operands and round its output to bf16; they differ in the order
    of the f32 sums, so an output element may round to the neighbouring
    bf16 value (2^-8 relative), and those flips grow through 28 residual
    layers of bf16 products: the first H100 run measured 1.8e-2 on the
    logits and the caches, and up to 2.1e-2 for decode against the full
    forward. Two controls bracket the tolerance, each run through the same
    prefill in place of the kernel: PyTorch's own bf16 attention
    (`scaled_dot_product_attention`), an independent correct
    implementation, must pass it; attention in a lower precision than the
    config's, q, k and v rounded to fp8 (e4m3, 2^-4 relative; 8.6e-2 in
    that run), must fail it. Layer 0's caches precede any attention and
    must be bit-identical."""
    from repro_torch import pytree
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (1, seq))).to(dev)
    ops.reset_launch_counts()
    logits_f, cache_f = tr.forward_with_cache(params, tok, cfg)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    if launches["flash_attention"] != cfg.n_layers:
        raise AssertionError(f"prefill launched flash_attention "
                             f"{launches['flash_attention']} times, not "
                             f"{cfg.n_layers}")

    def prefill(c):
        def run():
            t0 = time.perf_counter()
            tr.forward_with_cache(params, tok, c)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3
        return run
    plain_cfg = dataclasses.replace(cfg, use_flash=False,
                                    attn_chunk=PREFILL_PLAIN_CHUNK)
    runs: dict = {"flash": [], "plain": []}
    for path in ("flash", "plain", "flash", "plain", "flash"):   # in turns
        runs[path].append(prefill(cfg if path == "flash" else plain_cfg)())
    flash_ms, plain_ms = runs["flash"], runs["plain"]
    trace = traced(prefill(cfg))
    plain_trace = traced(prefill(plain_cfg))
    logits_p, cache_p = tr.forward_with_cache(params, tok, plain_cfg)
    hidden = tr.forward(params, tok, cfg)
    logits_fw = tr.logits_fn(params, hidden[:, -1], cfg)
    del hidden
    errs = dict(
        logits_vs_plain=rel_err(logits_f, logits_p),
        logits_vs_forward=rel_err(logits_f, logits_fw),
        cache_vs_plain=max(rel_err(cache_f[n][i], cache_p[n][i])
                           for n in ("k", "v")
                           for i in range(cfg.n_layers)),
        logits_max_abs_vs_plain=float((logits_f.float() - logits_p.float())
                                      .abs().max()),
        logits_max_abs=float(logits_p.float().abs().max()))
    layer0_equal = all(torch.equal(cache_f[n][0], cache_p[n][0])
                       for n in ("k", "v"))

    def fp8_attention(q, k, v, causal=True):
        r8 = [x.to(torch.float8_e4m3fn).to(x.dtype) for x in (q, k, v)]
        return ref.flash_attention_ref(*r8, causal)

    def library_attention(q, k, v, causal=True):
        import torch.nn.functional as F
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                              enable_gqa=True)
    flash = ops.flash_attention
    for name, attention in (("fp8", fp8_attention),
                            ("sdpa", library_attention)):
        ops.flash_attention = attention
        try:
            logits_c, cache_c = tr.forward_with_cache(params, tok, cfg)
        finally:
            ops.flash_attention = flash
        errs[f"control_{name}_logits"] = rel_err(logits_c, logits_p)
        errs[f"control_{name}_cache"] = max(
            rel_err(cache_c[n][i], cache_p[n][i])
            for n in ("k", "v") for i in range(cfg.n_layers))
        del cache_c
    del cache_f, cache_p
    # least time: the weights read once, and the layers' products (2
    # operations a weight a token; the embedding is gathered and the head
    # meets the last token only) plus causal attention at the bf16 rate
    leaves = pytree.leaves(params)
    n_weights = sum(x.numel() for x in pytree.leaves(params["layers"]))
    n_ops = (2 * tok.numel() * n_weights + cfg.n_layers * 4 * cfg.n_heads
             * seq * seq * cfg.head_dim / 2)
    bnd, by = bound_ms(sum(x.numel() * x.element_size() for x in leaves),
                       n_ops, BF16_OPS_PER_S)
    report = dict(tokens=int(tok.numel()), flash_launches_per_call=launches[
        "flash_attention"], flash_ms=flash_ms, plain_ms=plain_ms,
        bound_ms=bnd, bound_by=by, trace=trace, plain_trace=plain_trace,
        errors=errs,
        layer0_cache_equal=layer0_equal, tolerance_rel=LM_REL_TOL)
    print("lm prefill " + json.dumps(report), flush=True)
    for key in ("logits_vs_plain", "logits_vs_forward", "cache_vs_plain"):
        if not errs[key] <= LM_REL_TOL:
            raise AssertionError(f"lm prefill {key}: {errs[key]} > "
                                 f"{LM_REL_TOL}")
    if not layer0_equal:
        raise AssertionError("lm prefill: layer 0 caches differ")
    if not errs["control_fp8_logits"] > LM_REL_TOL:
        raise AssertionError("lm prefill: the fp8-attention control passes "
                             "the tolerance, which is then too loose")
    if not max(errs["control_sdpa_logits"],
               errs["control_sdpa_cache"]) <= LM_REL_TOL:
        raise AssertionError("lm prefill: PyTorch's bf16 attention fails "
                             "the tolerance, which is then too tight")
    return report


def with_planted_fault(mod, name: str, old: str, new: str):
    """`mod.<name>` compiled again from its own source with `old` (found
    exactly once) replaced by `new`, in a copy of the module's namespace:
    a planted fault that leaves the module itself as it was."""
    import inspect
    src = inspect.getsource(getattr(mod, name))
    if src.count(old) != 1:
        raise AssertionError(f"planted fault: {old!r} is not in {name} once")
    namespace = dict(vars(mod))
    exec(compile(src.replace(old, new), f"<{name}, planted fault>", "exec"),
         namespace)
    return namespace[name]


# the engine steps that advance request 0 (slot 0): its three prompt steps,
# then (after slots 1-3's prompts) the eight pool steps; position i at
# SLOT0_STEPS[i]
SLOT0_STEPS = list(range(3)) + list(range(12, 20))


def planted_decode(tr, ffn, old: str, new: str):
    """A decode step (params, cache, tokens, pos, cfg) through
    `tr.decode` with a planted fault (`with_planted_fault`) and the
    feed-forward half `ffn`."""
    decode = with_planted_fault(tr, "decode", old, new)
    return lambda p, c, t, q, cfg: decode(p, c, t, q, cfg, ffn)


def serve_decode_errors(tr, cfg, params, dev, decode_step=None,
                        compare: bool = True, inputs: list | None = None
                        ) -> dict:
    """`ServeEngine` on the launcher's requests (4 slots, all active),
    through `decode_step` (the model's own unless given). Request 0's
    decode-step logits (its three prompt steps and its eight pool steps)
    against `forward` + `logits_fn` over its own prefix on the card, unless
    `compare` is off (the caller compares). With `inputs`, each step's
    inputs (a copy of the cache it was given, its tokens and positions,
    copied before the step's clock starts) and its logits (all slots) are
    appended to it, on the card."""
    from repro_torch.launch import serve as launch
    from repro_torch.serve.engine import ServeEngine
    eng = ServeEngine(tr, params, cfg, max_batch=launch.SLOTS,
                      max_seq=launch.MAX_SEQ, device=dev)
    reqs = launch.launcher_requests(cfg, launch.SLOTS)
    steps = []
    step = (eng._step if decode_step is None else
            lambda p, c, t, q: decode_step(p, c, t, q, cfg))

    def recorded(p, c, tokens, pos):
        if inputs is not None:
            inputs.append(dict(k=c["k"].clone(), v=c["v"].clone(),
                               tokens=tokens.clone(), pos=pos.clone()))
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, c = step(p, c, tokens, pos)
        torch.cuda.synchronize()
        steps.append(dict(ms=(time.perf_counter() - t0) * 1e3,
                          token0=int(tokens[0]), pos0=int(pos[0]),
                          logits0=logits[0].float().cpu()))
        if inputs is not None:
            inputs[-1]["logits"] = logits.float()
        return logits, c
    eng._step = recorded
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    eng.run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    # 4 prompts x 3 token-by-token prefill steps, then 8 pool steps
    if len(steps) != 4 * 3 + 8 or not all(len(r.out) == 8 for r in reqs):
        raise AssertionError(f"serve: {len(steps)} steps, outputs "
                             f"{[len(r.out) for r in reqs]}")
    seq = reqs[0].prompt + reqs[0].out
    errs = []
    for i in SLOT0_STEPS:
        s = steps[i]
        if s["token0"] != seq[s["pos0"]] or s["pos0"] != SLOT0_STEPS.index(i):
            raise AssertionError(f"serve step {i}: slot 0 fed {s['token0']}"
                                 f" at {s['pos0']}, not {seq[s['pos0']]}")
        if not compare:
            continue
        prefix = torch.tensor([seq[:s["pos0"] + 1]], device=dev)
        want = tr.logits_fn(params, tr.forward(params, prefix, cfg)[:, -1],
                            cfg)[0].float().cpu()
        errs.append(rel_err(s["logits0"], want))
    return dict(engine=eng, requests=reqs, steps=steps, wall_s=wall_s,
                errors=errs)


def check_lm_serve(tr, cfg, params, dev) -> dict:
    """`ServeEngine` on gemma-7b with the launcher's requests: decode
    through the cache against the full forward, within LM_REL_TOL (bf16
    products of other shapes, so other summation orders, through 28
    layers; see check_lm_prefill). Two planted cache faults, run through
    the same engine and check, must fail it: each slot's K/V row written
    one position early (pos - 1) in every layer, and the write lost in one
    layer (the middle one), which leaves that layer's earlier rows at the
    cache's initial zeros."""
    from repro_torch import pytree
    from repro_torch.launch import serve as launch
    run = serve_decode_errors(tr, cfg, params, dev)
    reqs, steps, errs = run["requests"], run["steps"], run["errors"]
    wall_s = run["wall_s"]
    n_tok = sum(len(r.out) for r in reqs)
    pool_ms = [s["ms"] for s in steps[12:]]
    n_bytes = sum(x.numel() * x.element_size()
                  for x in pytree.leaves(params))
    cache = run["engine"].cache
    tokens = torch.zeros(launch.SLOTS, dtype=torch.int32, device=dev)
    pos = torch.full((launch.SLOTS,), 11, dtype=torch.int32, device=dev)
    trace = traced(lambda: tr.decode_step(params, cache, tokens, pos, cfg))
    del run, cache
    planted = {
        "write_at_pos_minus_1": ("rows = pos.long()",
                                 "rows = (pos.long() - 1).clamp(min=0)"),
        "write_lost_in_one_layer": (
            'k_cache, v_cache = cache["k"][i], cache["v"][i]',
            'k_cache, v_cache = (cache["k"][i], cache["v"][i]) '
            'if i != cfg.n_layers // 2 else '
            '(cache["k"][i].clone(), cache["v"][i].clone())')}
    faults = {}
    for fault, (old, new) in planted.items():
        bad = serve_decode_errors(
            tr, cfg, params, dev, planted_decode(tr, tr._ffn, old,
                                                 new))["errors"]
        faults[fault] = dict(decode_vs_forward_rel_err=bad,
                             max_rel_err=max(bad))
    report = dict(requests=len(reqs), tokens=n_tok, wall_s=wall_s,
                  tokens_per_s=n_tok / wall_s, steps=len(steps),
                  step_ms=[s["ms"] for s in steps],
                  pool_step_ms_mean=float(np.mean(pool_ms)),
                  weight_bytes=n_bytes,
                  step_bound_ms=n_bytes / HBM_BYTES_PER_S * 1e3,
                  decode_vs_forward_rel_err=errs, decode_trace=trace,
                  planted_faults=faults, tolerance_rel=LM_REL_TOL)
    print("lm serve " + json.dumps(report), flush=True)
    if not max(errs) <= LM_REL_TOL:
        raise AssertionError(f"serve: decode logits differ from the full "
                             f"forward by {max(errs)} > {LM_REL_TOL}")
    for fault, f in faults.items():
        if not f["max_rel_err"] > LM_REL_TOL:
            raise AssertionError(f"serve: the planted fault {fault} passes "
                                 f"the tolerance ({f['max_rel_err']})")
    return report


def check_lm_cuda_vs_cpu(ops, dev, family: str = "lm") -> list:
    """The SMOKE configs (f32) of a family (the dense "lm" or "moe"): flash
    prefill at B=2 x S=128 where the head dim is one the kernel takes (the
    plain attention elsewhere: qwen3-moe's 16), the launcher's requests
    through `ServeEngine` and `lm_loss` over 2 x 65 tokens, on the card and
    on the CPU, every logit and loss within SMOKE_TOL = 1e-4 (absolute and
    relative): the f32 products sum in other orders on the two devices
    (~1e-6 here), while TF32 (10 bits of mantissa, ~1e-3) would fail it."""
    from repro_torch.configs import registry
    from repro_torch.launch import serve as launch
    from repro_torch.serve.engine import ServeEngine
    out = []
    for arch in [a for a in registry.ARCHS
                 if registry.get(a).family == family]:
        smoke = registry.get(arch).smoke
        flash = smoke.head_dim in ops.FLASH_HEAD_DIMS
        cfg = dataclasses.replace(smoke, use_flash=flash)
        tr = registry.model_module(cfg)
        params = tr.init_params(cfg, seed=0, device="cpu")
        tok = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab, (2, 128)))
        runs = []                       # the card's, then the CPU's
        for d in (dev, torch.device("cpu")):
            p = tree_to(params, d)
            ops.reset_launch_counts()
            logits, cache = tr.forward_with_cache(p, tok.to(d), cfg)
            if d.type == "cuda" and ops.LAUNCHES["flash_attention"] != (
                    cfg.n_layers if flash else 0):
                raise AssertionError(f"{arch} smoke: flash launched "
                                     f"{ops.LAUNCHES['flash_attention']} "
                                     f"times, flash {flash}")
            with torch.no_grad():
                loss = tr.lm_loss(p, tok[:, :65].to(d), dataclasses.replace(
                    cfg, use_flash=False))
            eng = ServeEngine(tr, p, cfg, max_batch=launch.SLOTS,
                              max_seq=launch.MAX_SEQ, device=d)
            log = []
            eng._step = functools.partial(_logged, eng._step, log)
            for r in launch.launcher_requests(cfg, 2):
                eng.submit(r)
            eng.run()
            runs.append([logits.cpu(), cache["k"].cpu(), cache["v"].cpu(),
                         loss.cpu()] + log)
        if len(runs[0]) != len(runs[1]):
            raise AssertionError(f"{arch} smoke: {len(runs[0])} results on "
                                 f"the card, {len(runs[1])} on the CPU")
        err = max(float((g - w).abs().max()) for g, w in zip(*runs))
        for g, w in zip(*runs):
            torch.testing.assert_close(g, w, rtol=SMOKE_TOL, atol=SMOKE_TOL)
        out.append(dict(arch=arch, compared=len(runs[0]),
                        attention="flash kernel" if flash else "plain",
                        max_abs_err=err, tolerance=SMOKE_TOL))
        print(f"{'lm' if family == 'lm' else 'moe'} smoke "
              + json.dumps(out[-1]), flush=True)
    return out


def _logged(step, log, *args):
    logits, cache = step(*args)
    log.append(logits.cpu())
    return logits, cache


# ----------------------------------------------------------- the MoE LM ---
@contextlib.contextmanager
def routing(moe, log: list, replay: bool = False):
    """Record the experts `moe.route` picks, one (T, k) tensor a call in
    call order (a layer a call), into `log`; or, with `replay`, make each
    call pick the experts `log` holds for it instead of its own top-k, each
    weighted by its own router probability renormalised over them (the
    same weights when the choices agree). A replayed pass routes as the
    recorded one did, so what still differs between the two is numerics."""
    route = moe.route
    it = iter(log)

    def wrapped(lp, x, cfg):
        probs, top_p, top_e = route(lp, x, cfg)
        if not replay:
            log.append(top_e)
            return probs, top_p, top_e
        top_e = next(it).to(x.device)
        top_p = probs.gather(-1, top_e)
        return probs, top_p / top_p.sum(-1, keepdim=True), top_e
    moe.route = wrapped
    try:
        yield log
    finally:
        moe.route = route


def dropped_pairs(top_e: torch.Tensor, cfg) -> int:
    """Token-expert pairs past their expert's capacity in one routing."""
    from repro_torch.models import moe
    counts = torch.bincount(top_e.reshape(-1), minlength=cfg.n_experts_padded)
    cap = moe.capacity(top_e.shape[0], cfg)
    return int((counts - cap).clamp(min=0).sum())


def routing_agreement(a: list, b: list) -> list:
    """Per layer, the share of (token, choice) slots whose expert is the
    same in two routings of the same tokens (each token's k sorted)."""
    return [float((x.sort(-1).values == y.sort(-1).values).float().mean())
            for x, y in zip(a, b)]


def moe_prefill_bound(params, cfg, seq: int, kept_pairs: int
                      ) -> tuple[float, str]:
    """The weights read once, and the products this run's routing needs:
    2 operations a weight a token for attention, router and shared experts,
    2 a weight for each kept token-expert pair, causal attention, the head
    for the last token, at the bf16 rate."""
    from repro_torch import pytree
    lay = params["layers"]
    dense = sum(lay[n][0].numel() for n in ("wq", "wk", "wv", "wo", "router",
                                            "ws_gate", "ws_up", "ws_down")
                if n in lay)
    expert = 3 * cfg.d_model * cfg.d_ff_expert
    head = cfg.vocab * cfg.d_model
    n_ops = (2 * seq * dense * cfg.n_layers + 2 * kept_pairs * expert
             + cfg.n_layers * 4 * cfg.n_heads * seq * seq * cfg.head_dim / 2
             + 2 * head)
    n_bytes = sum(x.numel() * x.element_size()
                  for x in pytree.leaves(params))
    return bound_ms(n_bytes, n_ops, BF16_OPS_PER_S)


def check_moe_prefill(ops, ref, moe, cfg, params, dev,
                      seq: int = 4096) -> dict:
    """A MoE arch's prefill at full width, B=1 x S=4096: `forward_with_cache`
    through the flash kernel against the plain path (attn_chunk=2048),
    within LM_REL_TOL on the last-token logits and on every layer's K/V,
    with the SDPA control that must pass that check on both and the fp8
    control that must fail it (check_lm_prefill's reasons). The fp8
    control is held to fail on the caches: on qwen3-moe its last-token
    logits stay under the tolerance (0.038) while its caches
    do not (0.064), so there the logits alone do not tell fp8 attention
    from the kernel, and only the caches do (NVIDIA H100 80GB HBM3,
    700.00 W). The router's top-k is discrete: a logit that moves by the
    attention's rounding can swap an expert, and the swap changes that
    token's FFN output by far more than the rounding did, then every later
    layer's input. So the plain path and the controls
    run with the flash pass's routing replayed (`routing`), which holds the
    kernel's numerics to the tolerance; the plain path with its own routing
    is run too and reported beside it, with the per-layer share of routing
    choices equal between the two and the pairs dropped at capacity. Layer
    0's caches precede any attention and must be bit-identical."""
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (1, seq))).to(dev)
    plain_cfg = dataclasses.replace(cfg, use_flash=False,
                                    attn_chunk=PREFILL_PLAIN_CHUNK)
    ops.reset_launch_counts()
    with routing(moe, []) as flash_route:
        logits_f, cache_f = moe.forward_with_cache(params, tok, cfg)
    torch.cuda.synchronize()
    launches = ops.LAUNCHES["flash_attention"]
    if launches != cfg.n_layers:
        raise AssertionError(f"{cfg.name} prefill launched flash_attention "
                             f"{launches} times, not {cfg.n_layers}")
    with routing(moe, []) as plain_route:
        logits_pf, cache_pf = moe.forward_with_cache(params, tok, plain_cfg)
    with routing(moe, flash_route, replay=True):
        logits_p, cache_p = moe.forward_with_cache(params, tok, plain_cfg)
    with routing(moe, flash_route, replay=True):
        hidden, _ = moe.forward(params, tok, cfg)
    logits_fw = moe.transformer.logits_fn(params, hidden[:, -1], cfg)
    del hidden

    def cache_err(c, want):
        return max(rel_err(c[n][i], want[n][i]) for n in ("k", "v")
                   for i in range(cfg.n_layers))
    errs = dict(
        logits_vs_plain=rel_err(logits_f, logits_p),
        logits_vs_forward=rel_err(logits_f, logits_fw),
        cache_vs_plain=cache_err(cache_f, cache_p),
        free_routing_logits_vs_plain=rel_err(logits_f, logits_pf),
        free_routing_cache_vs_plain=cache_err(cache_f, cache_pf),
        free_routing_cache_by_layer=[max(
            rel_err(cache_f[n][i], cache_pf[n][i]) for n in ("k", "v"))
            for i in range(cfg.n_layers)])
    layer0_equal = all(torch.equal(cache_f[n][0], cache_p[n][0])
                       for n in ("k", "v"))
    del cache_pf

    def fp8_attention(q, k, v, causal=True):
        r8 = [x.to(torch.float8_e4m3fn).to(x.dtype) for x in (q, k, v)]
        return ref.flash_attention_ref(*r8, causal)

    def library_attention(q, k, v, causal=True):
        import torch.nn.functional as F
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                              enable_gqa=True)
    flash = ops.flash_attention
    for name, attention in (("fp8", fp8_attention),
                            ("sdpa", library_attention)):
        ops.flash_attention = attention
        try:
            with routing(moe, flash_route, replay=True):
                logits_c, cache_c = moe.forward_with_cache(params, tok, cfg)
        finally:
            ops.flash_attention = flash
        errs[f"control_{name}_logits"] = rel_err(logits_c, logits_p)
        errs[f"control_{name}_cache"] = cache_err(cache_c, cache_p)
        del cache_c
    del cache_f, cache_p

    def prefill(c):
        def run():
            t0 = time.perf_counter()
            moe.forward_with_cache(params, tok, c)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3
        return run
    runs: dict = {"flash": [], "plain": []}
    for path in ("flash", "plain", "flash", "plain", "flash"):   # in turns
        runs[path].append(prefill(cfg if path == "flash" else plain_cfg)())
    trace = traced(prefill(cfg))
    agreement = routing_agreement(flash_route, plain_route)
    drops = dict(flash=[dropped_pairs(e, cfg) for e in flash_route],
                 plain=[dropped_pairs(e, cfg) for e in plain_route])
    kept = seq * cfg.top_k * cfg.n_layers - sum(drops["flash"])
    bnd, by = moe_prefill_bound(params, cfg, seq, kept)
    report = dict(
        arch=cfg.name, layers=cfg.n_layers, tokens=seq,
        capacity=moe.capacity(seq, cfg), flash_launches_per_call=launches,
        flash_ms=runs["flash"], plain_ms=runs["plain"], bound_ms=bnd,
        bound_by=by, trace=trace, errors=errs,
        layer0_cache_equal=layer0_equal, tolerance_rel=LM_REL_TOL,
        routing_agreement_by_layer=agreement,
        routing_agreement_min=min(agreement), dropped_pairs_by_layer=drops,
        pairs_per_layer=seq * cfg.top_k)
    print("moe prefill " + json.dumps(report), flush=True)
    for key in ("logits_vs_plain", "logits_vs_forward", "cache_vs_plain"):
        if not errs[key] <= LM_REL_TOL:
            raise AssertionError(f"moe prefill {cfg.name} {key}: "
                                 f"{errs[key]} > {LM_REL_TOL}")
    if not layer0_equal:
        raise AssertionError(f"moe prefill {cfg.name}: layer 0 caches differ")
    # the controls: PyTorch's bf16 attention must pass the check on logits
    # and caches; fp8 attention must fail it on the caches, the part of
    # the check that separates it on every MoE arch (see the docstring)
    if not errs["control_fp8_cache"] > LM_REL_TOL:
        raise AssertionError("moe prefill: the fp8-attention control's "
                             "caches pass the tolerance, which is then too "
                             "loose")
    if not max(errs["control_sdpa_logits"],
               errs["control_sdpa_cache"]) <= LM_REL_TOL:
        raise AssertionError("moe prefill: PyTorch's bf16 attention fails "
                             "the tolerance, which is then too tight")
    return report


def moe_depth_that_fits(moe, cfg, headroom: float = 12e9) -> int:
    """All of cfg's layers if their weights and `headroom` bytes of
    activations fit in the card's free memory, else as many as do."""
    from repro_torch import pytree
    shapes = moe.param_shapes(cfg)
    size = torch.tensor([], dtype=cfg.torch_dtype).element_size()
    per_layer = size * sum(math.prod(s[1:]) for s in pytree.leaves(
        shapes["layers"]))
    base = size * sum(math.prod(shapes[k]) for k in ("embed", "lm_head")
                      if k in shapes)
    free, _ = torch.cuda.mem_get_info()
    return int(min(cfg.n_layers, (free - headroom - base) // per_layer))


def init_moe(moe, cfg, full_layers: int, dev, kind: str) -> dict:
    """Random weights from seed 0 on the card, with a line giving their
    count, bytes and time, and the depth built of the published one."""
    from repro_torch import pytree
    t0 = time.perf_counter()
    params = moe.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    leaves = pytree.leaves(params)
    print(f"{cfg.name}: {sum(x.numel() for x in leaves)} parameters "
          f"({cfg.n_experts_padded} experts, {cfg.n_layers} of "
          f"{full_layers} layers built), "
          f"{sum(x.numel() * x.element_size() for x in leaves)} bytes on "
          f"{kind}, made in {time.perf_counter() - t0:.1f} s", flush=True)
    return params


@contextlib.contextmanager
def planted_moe_ffn(moe, fault):
    """`moe.moe_ffn` with a planted fault ((old, new), `with_planted_fault`)
    while the block runs; nothing when `fault` is None. Compiled on entry,
    so it calls the `route` in place then (`routing`'s, inside it)."""
    if fault is None:
        yield
        return
    fn = moe.moe_ffn
    moe.moe_ffn = with_planted_fault(moe, "moe_ffn", *fault)
    try:
        yield
    finally:
        moe.moe_ffn = fn


def plain_moe_decode_ffn(moe, top_es: list):
    """A decode step's feed-forward half (`transformer.decode`'s `ffn`) done
    the plain way, with the routing `top_es` replayed (a (B, k) tensor a
    layer, in layer order): one token-expert pair at a time in (token,
    choice) order, an expert's pairs past its capacity dropped, each kept
    pair's expert output weighted by its router probability renormalised
    over the replayed experts and summed in f32, then the shared experts.
    No sort, no slot table, no scatter: a check of `moe_ffn`'s dispatch
    and combine for every slot of the pool."""
    from repro_torch.models.layers import activation
    it = iter(top_es)

    def ffn(lp, h2, cfg):
        b, s, d = h2.shape
        x = h2.reshape(b * s, d)
        top_e = next(it)
        logits = (x @ lp["router"]).float()
        logits[:, cfg.n_experts:] = -1e30                # padding experts
        probs = torch.softmax(logits, dim=-1)
        top_p = probs.gather(-1, top_e)
        top_p = top_p / top_p.sum(-1, keepdim=True)
        cap = moe.capacity(b * s, cfg)
        seen: collections.Counter = collections.Counter()
        y = torch.zeros(b * s, d, dtype=torch.float32, device=x.device)
        for t, experts in enumerate(top_e.tolist()):
            for j, e in enumerate(experts):
                seen[e] += 1
                if seen[e] > cap:                 # past the expert's capacity
                    continue
                h = activation(x[t] @ lp["we_gate"][e], cfg.act) \
                    * (x[t] @ lp["we_up"][e])
                y[t] += top_p[t, j] * (h @ lp["we_down"][e]).float()
        y = y.to(x.dtype).reshape(b, s, d)
        if cfg.n_shared:
            y = y + (activation(h2 @ lp["ws_gate"], cfg.act)
                     * (h2 @ lp["ws_up"])) @ lp["ws_down"]
        return y
    return ffn


def pool_step_errors(moe, cfg, params, inputs: list, log: list) -> list:
    """Each recorded engine step (`serve_decode_errors`'s `inputs`) run
    again on its copy of the cache through `transformer.decode` with
    `plain_moe_decode_ffn` and the step's routing from `log`: per step, the
    relative error of each slot's logits. Consumes the copies."""
    L = cfg.n_layers
    out = []
    for i, x in enumerate(inputs):
        cache = dict(k=x.pop("k"), v=x.pop("v"))
        logits, _ = moe.transformer.decode(
            params, cache, x["tokens"], x["pos"], cfg,
            plain_moe_decode_ffn(moe, log[i * L:(i + 1) * L]))
        out.append([rel_err(x["logits"][s], logits[s].float())
                    for s in range(logits.shape[0])])
        del cache
    return out


def moe_decode_step_bound(params, cfg, pos: torch.Tensor, top_es: list
                          ) -> tuple[float, str]:
    """The least time of one pool-wide decode step: the bytes it must move
    (attention, router, norm and shared-expert weights of every layer, the
    head, its tokens' embedding rows, the weights of the experts it routes
    to in each layer: at capacity >= 1 every chosen expert keeps a pair;
    each slot's cache read up to its position and its new row written; the
    logits written), or its operations (2 a weight a token, 2 an expert
    weight a kept pair, causal attention over each slot's prefix) at the
    bf16 rate."""
    from repro_torch import pytree
    lay = params["layers"]
    elt = lay["wq"].element_size()
    b = pos.numel()
    dense = sum(x[0].numel() for n in lay if not n.startswith("we_")
                for x in pytree.leaves(lay[n]))
    expert = 3 * cfg.d_model * cfg.d_ff_expert
    head = params.get("lm_head", params["embed"]).numel()
    final = sum(x.numel() for x in pytree.leaves(params["final_norm"]))
    experts = sum(int(torch.unique(e).numel()) for e in top_es)
    kept = sum(e.numel() - dropped_pairs(e, cfg) for e in top_es)
    ctx = int((pos.long() + 1).sum())              # cache rows attended
    row = cfg.n_layers * 2 * cfg.n_kv_heads * cfg.head_dim
    n_bytes = elt * (cfg.n_layers * dense + experts * expert + head + final
                     + b * cfg.d_model + row * (ctx + b) + b * cfg.vocab)
    n_ops = (2 * b * (cfg.n_layers * dense + head) + 2 * kept * expert
             + cfg.n_layers * 4 * cfg.n_heads * cfg.head_dim * ctx)
    return bound_ms(n_bytes, n_ops, BF16_OPS_PER_S)


# a dispatch fault that hands slots 1-3's expert outputs to one another
# (1 -> 2 -> 3 -> 1 at 4 tokens) and leaves slot 0's alone
SLOT_SWAP_FAULT = ("torch.where(keep, st, t)",
                   "torch.where(keep, torch.where(st > 0, 1 + st % (t - 1), "
                   "st), t)")


def check_moe_serve(moe, cfg, params, dev) -> dict:
    """`ServeEngine` on a MoE arch with the launcher's requests (4 slots; the
    published configs give them capacity 1, so slots collide and later
    slots' pairs are dropped). Two checks, each within LM_REL_TOL:

    - Request 0 against prefill. Slot 0 comes first in every expert's
      order, so its pairs are never dropped: each of its decode logits is
      held to `forward_with_cache` over its prefix at a capacity that drops
      nothing, with its own routing replayed (what decode routed for each
      of its tokens, layer by layer; see check_moe_prefill). Reported
      beside them: the prefill over the prefix with its own routing, at
      that capacity and at the published one.
    - Every slot against a plain MoE. Each engine step, all four slots'
      logits, run again on a copy of the cache it was given with its
      routing replayed through `plain_moe_decode_ffn`: slots 1-3's drops
      at capacity 1 are checked at full width.

    Faults planted in the code must fail them: check_lm_serve's two cache
    faults the first, `SLOT_SWAP_FAULT` in `moe_ffn` (which the first
    cannot see) the second. The step's bound (`moe_decode_step_bound`)
    counts the experts each step routes to; reading every expert's
    weights, as the batched products over all experts do, is reported as
    `all_weights_read_ms`."""
    from repro_torch import pytree
    from repro_torch.launch import serve as launch
    dropless = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    L = cfg.n_layers

    def run(decode_step=None, inputs=None, ffn_fault=None):
        with routing(moe, []) as log, planted_moe_ffn(moe, ffn_fault):
            r = serve_decode_errors(moe, cfg, params, dev, decode_step,
                                    compare=False, inputs=inputs)
        return r, log

    def slot0_errors(r, log, free_too: bool):
        steps, seq = r["steps"], r["requests"][0].prompt + \
            r["requests"][0].out
        # slot 0's routing row in each layer, by position
        rows = [[log[i * L + l][0] for l in range(L)] for i in SLOT0_STEPS]
        errs, free = [], []
        for n, i in enumerate(SLOT0_STEPS, start=1):
            prefix = torch.tensor([seq[:n]], device=dev)
            replay = [torch.stack([rows[p][l] for p in range(n)])
                      for l in range(L)]
            with routing(moe, replay, replay=True):
                want = moe.forward_with_cache(params, prefix, dropless)[0]
            errs.append(rel_err(steps[i]["logits0"], want[0].float().cpu()))
            if free_too:                 # the prefill's own routing
                free.append([rel_err(steps[i]["logits0"],
                                     moe.forward_with_cache(
                                         params, prefix, c)[0][0].float()
                                     .cpu()) for c in (dropless, cfg)])
        return errs, free

    inputs: list = []
    r, log = run(inputs=inputs)
    errs, free = slot0_errors(r, log, True)
    reqs, steps, wall_s = r["requests"], r["steps"], r["wall_s"]
    drops = [sum(dropped_pairs(log[i * L + l], cfg) for l in range(L))
             for i in range(len(steps))]
    bounds = [moe_decode_step_bound(params, cfg, x["pos"],
                                    log[i * L:(i + 1) * L])
              for i, x in enumerate(inputs)]
    all_slots = pool_step_errors(moe, cfg, params, inputs, log)
    del inputs
    n_tok = sum(len(q.out) for q in reqs)
    pool_ms = [s["ms"] for s in steps[12:]]
    n_bytes = sum(x.numel() * x.element_size()
                  for x in pytree.leaves(params))
    cache = r["engine"].cache
    tokens = torch.zeros(launch.SLOTS, dtype=torch.int32, device=dev)
    pos = torch.full((launch.SLOTS,), 11, dtype=torch.int32, device=dev)
    trace = traced(lambda: moe.decode_step(params, cache, tokens, pos, cfg))
    del r, cache
    planted = {
        "write_at_pos_minus_1": ("rows = pos.long()",
                                 "rows = (pos.long() - 1).clamp(min=0)"),
        "write_lost_in_one_layer": (
            'k_cache, v_cache = cache["k"][i], cache["v"][i]',
            'k_cache, v_cache = (cache["k"][i], cache["v"][i]) '
            'if i != cfg.n_layers // 2 else '
            '(cache["k"][i].clone(), cache["v"][i].clone())')}
    faults = {}
    for fault, (old, new) in planted.items():
        bad = slot0_errors(*run(planted_decode(moe.transformer,
                                               moe._decode_ffn, old, new)),
                           False)[0]
        faults[fault] = dict(decode_vs_forward_rel_err=bad,
                             max_rel_err=max(bad))
    bad_inputs: list = []
    bad_r, bad_log = run(inputs=bad_inputs, ffn_fault=SLOT_SWAP_FAULT)
    bad_slot0 = slot0_errors(bad_r, bad_log, False)[0]
    bad_all = pool_step_errors(moe, cfg, params, bad_inputs, bad_log)
    del bad_r, bad_inputs
    faults["expert_outputs_swapped_among_slots_1_3"] = dict(
        slot0_max_rel_err=max(bad_slot0),
        all_slots_max_rel_err=max(map(max, bad_all)),
        max_rel_err=max(map(max, bad_all)))
    report = dict(arch=cfg.name, requests=len(reqs), tokens=n_tok,
                  wall_s=wall_s, tokens_per_s=n_tok / wall_s,
                  steps=len(steps), step_ms=[s["ms"] for s in steps],
                  pool_step_ms_mean=float(np.mean(pool_ms)),
                  capacity_at_4_slots=moe.capacity(launch.SLOTS, cfg),
                  dropped_pairs_by_step=drops, weight_bytes=n_bytes,
                  step_bound_ms=[b[0] for b in bounds],
                  step_bound_by=sorted({b[1] for b in bounds}),
                  pool_step_bound_ms_mean=float(np.mean(
                      [b[0] for b in bounds[12:]])),
                  all_weights_read_ms=n_bytes / HBM_BYTES_PER_S * 1e3,
                  decode_vs_forward_rel_err=errs,
                  all_slots_vs_plain_moe_rel_err=all_slots,
                  all_slots_max_rel_err=max(map(max, all_slots)),
                  free_routing_dropless_rel_err=[f[0] for f in free],
                  free_routing_published_capacity_rel_err=[f[1] for f in free],
                  decode_trace=trace, planted_faults=faults,
                  tolerance_rel=LM_REL_TOL)
    print("moe serve " + json.dumps(report), flush=True)
    if not max(errs) <= LM_REL_TOL:
        raise AssertionError(f"moe serve: decode logits differ from the "
                             f"prefix prefill by {max(errs)} > {LM_REL_TOL}")
    if not report["all_slots_max_rel_err"] <= LM_REL_TOL:
        raise AssertionError(f"moe serve: a slot's logits differ from the "
                             f"plain MoE's by "
                             f"{report['all_slots_max_rel_err']} > "
                             f"{LM_REL_TOL}")
    for fault, f in faults.items():
        if not f["max_rel_err"] > LM_REL_TOL:
            raise AssertionError(f"moe serve: the planted fault {fault} "
                                 f"passes the tolerance ({f['max_rel_err']})")
    return report


# ------------------------------------------------------------- training ---
TRAIN_REL_TOL = 1e-4     # losses, card against CPU (f32 configs)


def make_trainer(cfg, params, dev, ckpt_dir, seq: int, batch: int, **tcfg):
    """A `Trainer` on `dev` over a copy of `params` (the caller's stay
    as they are), and its batches from `TokenStream(vocab, seq, batch, 0)`:
    the training launcher's settings (AdamW, 5 warmup steps)."""
    from repro_torch.configs import registry
    from repro_torch.data.tokens import TokenStream
    from repro_torch.train import loop, optim
    model = registry.model_module(cfg)
    stream = TokenStream(cfg.vocab, seq, batch, seed=0)
    tr = loop.Trainer(lambda p, b: model.lm_loss(p, b, cfg),
                      tree_to(params, dev, copy=True),
                      loop.TrainerConfig(ckpt_dir=str(ckpt_dir),
                                         **{"log_every": 10 ** 9,
                                            "ckpt_every": 10 ** 9, **tcfg}),
                      optim.AdamWConfig(warmup_steps=5, total_steps=50))
    return tr, lambda s: (torch.from_numpy(stream.batch(s)).to(dev),)


def train_configs() -> dict:
    """The `tiny` preset (8 x 64 tokens) and the MoE smokes (the training
    launcher's 8 x 64)."""
    from repro_torch.configs import registry
    from repro_torch.launch import train_lm
    tiny = train_lm.PRESETS["tiny"]
    out = {"tiny": (tiny["cfg"], tiny["seq"], tiny["batch"])}
    for arch in ("qwen2-moe-a2.7b", "qwen3-moe-30b-a3b"):
        out[arch + " smoke"] = (registry.get(arch).smoke, 64, 8)
    return out


def check_train_cuda_vs_cpu(dev, tmp) -> list:
    """Six `Trainer` steps on the card and on the CPU from the same weights
    (drawn on the CPU) and `TokenStream` batches: every loss within
    TRAIN_REL_TOL = 1e-4 relative (f32 products summed in other orders,
    carried through six updates)."""
    from repro_torch.configs import registry
    out = []
    for name, (cfg, seq, batch) in train_configs().items():
        params = registry.model_module(cfg).init_params(cfg, 0, "cpu")
        hist = []                       # the card's, then the CPU's
        for i, d in enumerate((dev, torch.device("cpu"))):
            tr, batches = make_trainer(cfg, params, d, tmp / f"{name}-{i}",
                                       seq, batch)
            hist.append(tr.fit(batches, n_steps=6))
        err = max(abs(a - b) / abs(b) for a, b in zip(*hist))
        out.append(dict(config=name, losses_cuda=hist[0],
                        losses_cpu=hist[1], max_rel_err=err,
                        tolerance_rel=TRAIN_REL_TOL))
        print("train cuda vs cpu " + json.dumps(out[-1]), flush=True)
        if not err <= TRAIN_REL_TOL:
            raise AssertionError(f"train {name}: card and CPU losses differ "
                                 f"by {err} > {TRAIN_REL_TOL}")
    return out


@contextlib.contextmanager
def deterministic(warned: list, warn_only: bool = True):
    """torch.use_deterministic_algorithms(True), with warn_only: each op
    that has no deterministic CUDA implementation warns instead of raising,
    and its warning lands in `warned`; without, such an op raises. cuBLAS
    is told its deterministic workspace setting; it is deterministic on one
    stream either way."""
    import os
    import warnings
    had = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = had or ":4096:8"
    torch.use_deterministic_algorithms(True, warn_only=warn_only)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield warned
        warned.extend(sorted({str(w.message).split("\n")[0] for w in caught
                              if "determinis" in str(w.message)}))
    finally:
        torch.use_deterministic_algorithms(False)
        if had is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]


def check_train_full_width(dev, tmp, seq: int = 4096) -> list:
    """gemma-7b (4 of 28 layers) and qwen2-moe-a2.7b (2 of 24) at full
    width, bf16 weights and gradients, f32 moments (12 bytes a parameter:
    all of gemma-7b would take ~102 GB, all of qwen2-moe ~181 GB), B=1 x
    4096 tokens (train_4k's sequence), remat, 16 loss chunks, 4 steps. The
    first step's loss must equal `lm_loss` computed outside the trainer on
    the same weights and batch bit for bit (both under deterministic
    algorithms; within 1e-6 where an op without a deterministic CUDA path
    is named), every loss and gradient norm be finite and every norm
    above 0."""
    from repro_torch import pytree
    from repro_torch.configs import registry
    out = []
    for arch, depth in (("gemma-7b", 4), ("qwen2-moe-a2.7b", 2)):
        cfg = dataclasses.replace(registry.get(arch).config, n_layers=depth)
        model = registry.model_module(cfg)
        t0 = time.perf_counter()
        params = model.init_params(cfg, seed=0, device=dev)
        tr, batches = make_trainer(cfg, params, dev, tmp / arch, seq, 1)
        del params
        torch.cuda.synchronize()
        made_s = time.perf_counter() - t0
        n_params = sum(x.numel() for x in pytree.leaves(tr.params))
        torch.cuda.reset_peak_memory_stats()
        warned: list = []
        batch = batches(0)
        with deterministic(warned):
            with torch.no_grad():
                want = model.lm_loss(tr.params, batch[0], cfg)
            first = tr.train_step(batch)
        losses, norms, step_ms = [float(first)], [
            float(tr.metrics["grad_norm"])], []
        for s in range(1, 4):
            batch = batches(s)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            loss = tr.train_step(batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t1) * 1e3)
            losses.append(float(loss))
            norms.append(float(tr.metrics["grad_norm"]))
        # bit for bit, or within 1e-6 where an op named in `warned` has no
        # deterministic CUDA path
        tol = 0.0 if not warned else 1e-6
        report = dict(
            arch=arch, layers=f"{depth} of {registry.get(arch).config.n_layers}",
            parameters=n_params, tokens_per_step=seq, made_s=made_s,
            first_loss=float(first), lm_loss_outside=float(want),
            first_loss_bit_equal=bool(torch.equal(first, want)),
            first_loss_rel_err=rel_err(first, want), tolerance_rel=tol,
            nondeterministic_ops=warned, losses=losses, grad_norms=norms,
            step_ms=step_ms, tokens_per_s=seq / (np.mean(step_ms) / 1e3),
            max_memory_allocated=torch.cuda.max_memory_allocated())
        out.append(report)
        print("train full width " + json.dumps(report), flush=True)
        del tr, batch
        torch.cuda.empty_cache()
        if not report["first_loss_rel_err"] <= tol:
            raise AssertionError(f"train {arch}: the first step's loss "
                                 f"{float(first)!r} is not lm_loss's "
                                 f"{float(want)!r} (ops without a "
                                 f"deterministic path: {warned})")
        if not (np.isfinite(losses).all() and np.isfinite(norms).all()
                and min(norms) > 0):
            raise AssertionError(f"train {arch}: losses {losses}, grad "
                                 f"norms {norms}")
    return out


def check_train_resume(dev, tmp) -> dict:
    """The `tiny` preset on the card under deterministic algorithms: six
    steps uninterrupted; three steps, saved, restored into a new `Trainer`
    and continued to six; and six steps with a `FailureInjector` failure at
    step 4, recovered from the step-3 checkpoint (step 3 runs twice). The
    losses must be the uninterrupted run's bit for bit, or, where an op
    has no deterministic CUDA path (named in the report), within 1e-6
    relative."""
    from repro_torch.models import transformer
    from repro_torch.train import fault
    cfg, seq, batch = train_configs()["tiny"]
    params = transformer.init_params(cfg, seed=0, device="cpu")
    warned: list = []
    with deterministic(warned):
        full, batches = make_trainer(cfg, params, dev, tmp / "full", seq,
                                     batch)
        want = full.fit(batches, n_steps=6)
        part, batches = make_trainer(cfg, params, dev, tmp / "part", seq,
                                     batch)
        part.fit(batches, n_steps=3)
        resumed, batches = make_trainer(cfg, params, dev, tmp / "part", seq,
                                        batch)
        if not resumed.maybe_restore():
            raise AssertionError("train resume: no checkpoint to restore")
        restored_at = resumed.step
        got = resumed.fit(batches, n_steps=6)
        inj, batches = make_trainer(cfg, params, dev, tmp / "inj", seq,
                                    batch, ckpt_every=3)
        injected = inj.fit(batches, n_steps=6, injector=fault.FailureInjector(
            fail_at_steps=(4,)))
    recovered = want[:4] + want[3:]         # step 3 again after the restore
    tol = 0.0 if not warned else 1e-6
    errs = [abs(a - b) / abs(b) for a, b in
            zip(got + injected, want[3:] + recovered)]
    report = dict(preset="tiny", deterministic=not warned,
                  nondeterministic_ops=warned, uninterrupted=want,
                  restored_at=restored_at, resumed=got, injected=injected,
                  injected_step=inj.step, tolerance_rel=tol,
                  max_rel_err=max(errs))
    print("train resume " + json.dumps(report), flush=True)
    if restored_at != 3 or len(got) != 3 or len(injected) != 7 \
            or inj.step != 6:
        raise AssertionError(f"train resume: restored at {restored_at}, "
                             f"{len(got)} resumed losses, {len(injected)} "
                             f"with the failure, ended at {inj.step}")
    if not max(errs) <= tol:
        raise AssertionError(f"train resume: losses differ from the "
                             f"uninterrupted run by {max(errs)} > {tol}")
    return report


# --------------------------------------------- recsys retrieval and training --
# Scores are f32 dot products of 50 terms. A top-k held against another
# computed with other products (another GEMM shape or device) may round a
# score otherwise by a few ulps; so scores agree within TOPK_RTOL, and ids
# agree at every rank but where the two ids' scores are themselves within
# TOPK_RTOL (a near-tie that rounding may order either way). How many
# ranks differ, and whether all agree bit for bit, is printed.
TOPK_RTOL, TOPK_ATOL = 1e-5, 1e-6
BULK_BLOCK = 4096          # serve_bulk's block: (262,144 x 4,196) f32 scores
BULK_SAMPLED_ROWS = 256
CATALOG_CPU_ITEMS = 50_000
RECSYS_CPU_BATCH = 64      # card against CPU: InteractionStream batches
RECSYS_TRAIN_STEPS = 4


def wall_ms(fn, reps: int = 3) -> list:
    """Host wall ms of `reps` calls of `fn`, each ending in a synchronise,
    after one untimed call."""
    fn()
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def topk_agreement(label: str, got_s, got_i, want_s, want_i, dense) -> dict:
    """(got_s, got_i) against (want_s, want_i), (B, k) each, with `dense`
    the rows' full scores (B, N): see TOPK_RTOL. Raises on a disagreement;
    returns whether they agree bit for bit and how many ranks differ."""
    got_s, want_s = got_s.float(), want_s.float()
    err = (got_s - want_s).abs()
    if not bool((err <= TOPK_RTOL * want_s.abs() + TOPK_ATOL).all()):
        raise AssertionError(f"{label}: scores differ by up to "
                             f"{float(err.max())}")
    differ = got_i.long() != want_i.long()
    if bool(differ.any()):
        a = dense.gather(1, got_i.long())[differ]
        b = dense.gather(1, want_i.long())[differ]
        if not bool(((a - b).abs() <= TOPK_RTOL * b.abs() + TOPK_ATOL).all()):
            raise AssertionError(f"{label}: {int(differ.sum())} ranks name "
                                 "other items, not all of them near-ties")
    return dict(exact=bool(torch.equal(got_s, want_s)
                           and not bool(differ.any())),
                ranks_differ=int(differ.sum()),
                max_abs_score_err=float(err.max()))


def retrieval_bound(b: int, d: int, k: int, scored: int) -> tuple:
    """Bytes: the scored item rows, the states and the (B, k) scores and
    ids once; operations: 2 B D a scored item (f32)."""
    return bound_ms(4 * (scored * d + b * d + 2 * b * k), 2 * b * d * scored)


def check_retrieval(dev) -> dict:
    """STREAK retrieval over the full sasrec catalog (10^6 x 50, f32) on
    the launcher's popularity-skewed weights: `streak_topk` and
    `blocked_topk` at retrieval_cand (B=1, k=100), serve_p99 (B=512,
    k=100) and the launcher's 8 users (k=10) against a dense `torch.topk`
    of the full score matrix and against each other; serve_bulk (B=262,144,
    k=100) through `blocked_topk` in blocks of BULK_BLOCK, 256 sampled rows
    against the dense top-k; the CPU and the card on a 50,000-item catalog
    (ids and blocks read equal); then `launch.serve`'s recsys branch and
    `launch.serve_topk` on the card."""
    from repro_torch.configs import registry
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import serve_topk
    from repro_torch.models import sasrec
    from repro_torch.serve import retrieval
    if torch.backends.cuda.matmul.allow_tf32 \
            or torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("retrieval: f32 products must not run in TF32")
    cfg = registry.get("sasrec").config
    shapes = registry.RECSYS_SHAPES
    d, n = cfg.embed_dim, cfg.n_items
    block = max(64, n // 16)                     # the launcher's block
    rng = np.random.default_rng(1)
    out: dict = dict(items=n, dim=d, block=block, rows=[])
    with torch.no_grad():
        t0 = time.perf_counter()
        params, seq8 = launch_serve.popularity_catalog(cfg, dev)
        items = params["item_embed"]
        items_s, order = retrieval.sort_items_by_norm(items, block)
        bounds = retrieval.block_bounds(items_s, block)
        nb = int(bounds.shape[0])

        def states(b: int) -> torch.Tensor:
            seq = torch.from_numpy(rng.integers(1, n, (b, cfg.seq_len))
                                   .astype(np.int32)).to(dev)
            return torch.cat([sasrec.user_state(params, s, cfg)
                              for s in seq.split(32768)])
        cases = [("retrieval_cand", 100, states(
                     shapes["retrieval_cand"]["batch"])),
                 ("serve_p99", 100, states(shapes["serve_p99"]["batch"])),
                 ("launcher", 10, sasrec.user_state(params, seq8, cfg))]
        bulk_states = states(shapes["serve_bulk"]["batch"])
        torch.cuda.synchronize()
        out["made_s"] = time.perf_counter() - t0
        print(f"retrieval catalog: {n} x {d} f32 "
              f"({items.numel() * 4} bytes), {nb} blocks of {block}, made "
              f"in {out['made_s']:.1f} s", flush=True)
        for name, k, st in cases:
            b = st.shape[0]
            dense = st @ items.T
            want = torch.topk(dense, k)
            bs, bi = retrieval.blocked_topk(st, items, k, block)
            ss, si, read = retrieval.streak_topk(st, items_s, order, bounds,
                                                 k, block)
            row = dict(case=name, users=b, k=k, blocks_read=read,
                       n_blocks=nb,
                       blocked_vs_dense=topk_agreement(
                           f"{name} blocked", bs, bi, want.values,
                           want.indices, dense),
                       streak_vs_blocked=topk_agreement(
                           f"{name} streak", ss, si, bs, bi, dense))
            del dense
            if not 0 < read < nb:
                raise AssertionError(f"retrieval {name}: read {read} of {nb}"
                                     " blocks: no early termination")
            row["streak_ms"] = wall_ms(lambda: retrieval.streak_topk(
                st, items_s, order, bounds, k, block), 5)
            row["blocked_ms"] = wall_ms(lambda: retrieval.blocked_topk(
                st, items, k, block), 3)
            row["dense_topk_ms"] = wall_ms(lambda: torch.topk(st @ items.T,
                                                              k), 3)
            row["streak_bound_ms"], row["bound_by"] = retrieval_bound(
                b, d, k, min(read * block, n))
            row["blocked_bound_ms"], _ = retrieval_bound(b, d, k, n)
            out["rows"].append(row)
            print("retrieval " + json.dumps(row), flush=True)
        # serve_bulk: the full scan in BULK_BLOCK blocks, rows sampled
        b, k = bulk_states.shape[0], 100
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        bs, bi = retrieval.blocked_topk(bulk_states, items, k, BULK_BLOCK)
        torch.cuda.synchronize()
        bulk_ms = (time.perf_counter() - t1) * 1e3
        rows = torch.from_numpy(np.sort(rng.choice(
            b, BULK_SAMPLED_ROWS, replace=False))).to(dev)
        dense = bulk_states[rows] @ items.T
        want = torch.topk(dense, k)
        bulk = dict(case="serve_bulk", users=b, k=k, block=BULK_BLOCK,
                    blocked_ms=bulk_ms, sampled_rows=BULK_SAMPLED_ROWS,
                    blocked_vs_dense=topk_agreement(
                        "serve_bulk", bs[rows], bi[rows], want.values,
                        want.indices, dense),
                    max_memory_allocated=torch.cuda.max_memory_allocated(),
                    items_per_s=b * n / (bulk_ms / 1e3))
        bulk["bound_ms"], bulk["bound_by"] = retrieval_bound(b, d, k, n)
        del dense, bulk_states, bs, bi
        out["bulk"] = bulk
        print("retrieval " + json.dumps(bulk), flush=True)
        out["cuda_vs_cpu"] = catalog_cuda_vs_cpu(dev)
    del params, items, items_s, order
    torch.cuda.empty_cache()
    # the launchers' recsys paths on the card
    r = launch_serve.serve_retrieval(cfg, dev)
    with torch.no_grad():
        dense = sasrec.score_all(launch_serve.popularity_catalog(cfg, dev)[0],
                                 r["state"])
    want = torch.topk(dense, r["k"])
    out["launcher"] = dict(
        blocks_read=r["blocks_read"], n_blocks=r["n_blocks"],
        block=r["block"], seconds=r["seconds"], device=r["device"],
        vs_dense=topk_agreement("launch.serve", r["scores"], r["ids"],
                                want.values, want.indices, dense))
    del dense, r
    print("retrieval launch.serve " + json.dumps(out["launcher"]), flush=True)
    if not 0 < out["launcher"]["blocks_read"] < out["launcher"]["n_blocks"]:
        raise AssertionError("launch.serve: no early termination")
    t1 = time.perf_counter()
    r = serve_topk.main(["--device", str(dev)])
    out["serve_topk"] = dict(blocks_read=r["blocks_read"],
                             n_blocks=r["n_blocks"], steps=len(r["losses"]),
                             first_last_loss=r["losses"][::len(r["losses"])
                                                         - 1],
                             seconds=time.perf_counter() - t1)
    print("retrieval launch.serve_topk " + json.dumps(out["serve_topk"]),
          flush=True)
    if not 0 < r["blocks_read"] < r["n_blocks"]:
        raise AssertionError("launch.serve_topk: no early termination")
    torch.cuda.empty_cache()
    return out


def catalog_cuda_vs_cpu(dev) -> list:
    """The launcher's pipeline on a 50,000-item catalog (weights and states
    drawn on the CPU), each device sorting, bounding and scanning: ids and
    blocks read equal (ids up to near-ties, TOPK_RTOL), at k 10 and 100."""
    from repro_torch.configs import registry
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import sasrec
    from repro_torch.serve import retrieval
    cfg = dataclasses.replace(registry.get("sasrec").config,
                              n_items=CATALOG_CPU_ITEMS)
    block = max(64, cfg.n_items // 16)
    params, seq = launch_serve.popularity_catalog(cfg, "cpu")
    state = sasrec.user_state(params, seq, cfg)
    dense = sasrec.score_all(params, state)
    out = []
    for k in (10, 100):
        runs = []
        for d in (torch.device("cpu"), dev):
            items_s, order = retrieval.sort_items_by_norm(
                params["item_embed"].to(d), block)
            bounds = retrieval.block_bounds(items_s, block)
            s, i, read = retrieval.streak_topk(state.to(d), items_s, order,
                                               bounds, k, block)
            runs.append((s.cpu(), i.cpu(), read, order.cpu()))
        (cs, ci, cr, co), (gs, gi, gr, go) = runs
        row = dict(items=cfg.n_items, users=state.shape[0], k=k,
                   block=block, blocks_read_cpu=cr, blocks_read_cuda=gr,
                   order_equal=bool(torch.equal(co, go)),
                   agreement=topk_agreement(f"catalog k={k} card vs cpu",
                                            gs, gi, cs, ci, dense))
        out.append(row)
        print("retrieval cuda vs cpu " + json.dumps(row), flush=True)
        if cr != gr or not cr < -(-cfg.n_items // block):
            raise AssertionError(f"catalog k={k}: blocks read {gr} on the "
                                 f"card, {cr} on the CPU")
    return out


def recsys_trainer(cfg, params, dev, ckpt_dir, batches_list):
    """A `Trainer` on `dev` over a copy of `params`, BPR loss, the training
    launcher's AdamW (5 warmup steps), fed `batches_list[step]` (numpy
    (seq, pos, neg) triples) moved to `dev`."""
    from repro_torch.models import sasrec
    from repro_torch.train import loop, optim
    tr = loop.Trainer(lambda p, *b: sasrec.bpr_loss(p, *b, cfg),
                      tree_to(params, dev, copy=True),
                      loop.TrainerConfig(ckpt_dir=str(ckpt_dir),
                                         log_every=10 ** 9,
                                         ckpt_every=10 ** 9),
                      optim.AdamWConfig(warmup_steps=5, total_steps=50))
    return tr, lambda s: tuple(torch.from_numpy(x).to(dev)
                               for x in batches_list[s])


def check_recsys_train(dev, tmp) -> dict:
    """SASRec at full width (10^6 items x 50, f32) through the `Trainer`:
    three steps on the card and on the CPU from the same weights and
    `InteractionStream` batches (B=64) within TRAIN_REL_TOL; train_batch
    (65,536 sequences of 50) steps timed on seeded uniform item ids (the
    stream's host-side user x catalog affinity matrix would be 262 GB at
    that batch); and, under torch.use_deterministic_algorithms(True)
    without warn_only, six steps uninterrupted against three, saved,
    restored into a new `Trainer` and continued: bit-identical."""
    from repro_torch import pytree
    from repro_torch.configs import registry
    from repro_torch.data.recsys import InteractionStream
    from repro_torch.models import sasrec
    cfg = registry.get("sasrec").config
    out: dict = {}
    t0 = time.perf_counter()
    params = sasrec.init_params(cfg, seed=0, device="cpu")
    stream = InteractionStream(cfg.n_items, cfg.seq_len, RECSYS_CPU_BATCH,
                               seed=0)
    batches = [stream.batch(s) for s in range(6)]
    out["made_s"] = time.perf_counter() - t0
    hist = []
    for i, d in enumerate((dev, torch.device("cpu"))):
        tr, b = recsys_trainer(cfg, params, d, tmp / f"rs-{i}", batches)
        hist.append(tr.fit(b, n_steps=3))
        del tr
    err = max(abs(a - b) / abs(b) for a, b in zip(*hist))
    out["cuda_vs_cpu"] = dict(batch=RECSYS_CPU_BATCH, losses_cuda=hist[0],
                              losses_cpu=hist[1], max_rel_err=err,
                              tolerance_rel=TRAIN_REL_TOL)
    print("recsys train cuda vs cpu " + json.dumps(out["cuda_vs_cpu"]),
          flush=True)
    if not err <= TRAIN_REL_TOL:
        raise AssertionError(f"recsys train: card and CPU losses differ by "
                             f"{err} > {TRAIN_REL_TOL}")
    # resume, strictly deterministic
    warned: list = []
    with deterministic(warned, warn_only=False):
        full, b = recsys_trainer(cfg, params, dev, tmp / "rs-full", batches)
        want = full.fit(b, n_steps=6)
        part, b = recsys_trainer(cfg, params, dev, tmp / "rs-part", batches)
        part.fit(b, n_steps=3)
        resumed, b = recsys_trainer(cfg, params, dev, tmp / "rs-part",
                                    batches)
        if not resumed.maybe_restore() or resumed.step != 3:
            raise AssertionError("recsys train: no step-3 checkpoint")
        got = resumed.fit(b, n_steps=6)
        same_params = all(torch.equal(x, y) for x, y in zip(
            pytree.leaves(full.params), pytree.leaves(resumed.params)))
    out["resume"] = dict(uninterrupted=want, resumed=got,
                         bit_identical=got == want[3:] and same_params)
    print("recsys train resume " + json.dumps(out["resume"]), flush=True)
    del full, part, resumed
    if not out["resume"]["bit_identical"]:
        raise AssertionError("recsys train: the resumed run is not the "
                             "uninterrupted one bit for bit")
    # full width at train_batch
    batch = registry.RECSYS_SHAPES["train_batch"]["batch"]
    rng = np.random.default_rng(2)
    big = [tuple(rng.integers(1, cfg.n_items, (batch, cfg.seq_len))
                 .astype(np.int32) for _ in range(3))
           for _ in range(RECSYS_TRAIN_STEPS)]
    tr, b = recsys_trainer(cfg, sasrec.init_params(cfg, 0, dev), dev,
                           tmp / "rs-big", big)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for s in range(RECSYS_TRAIN_STEPS):
        x = b(s)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        losses.append(float(tr.train_step(x)))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
    tokens = batch * cfg.seq_len
    # forward and backward: ~3x the forward's products (q/k/v/o, FFN,
    # attention, the pos/neg scores), f32
    per_token = cfg.n_blocks * (2 * (4 * cfg.embed_dim ** 2 + 2 *
                                     cfg.embed_dim * cfg.d_ff)
                                + 4 * cfg.seq_len * cfg.embed_dim) \
        + 4 * cfg.embed_dim
    n_par = cfg.n_params()
    bound = bound_ms(4 * n_par * 6 + 12 * tokens, 3 * per_token * tokens)
    norm = float(tr.metrics["grad_norm"])
    out["full_width"] = dict(
        batch=batch, seq_len=cfg.seq_len, parameters=n_par, losses=losses,
        grad_norm=norm,
        step_ms=step_ms, sequences_per_s=batch / (np.median(step_ms) / 1e3),
        tokens_per_s=tokens / (np.median(step_ms) / 1e3),
        bound_ms=bound[0], bound_by=bound[1],
        max_memory_allocated=torch.cuda.max_memory_allocated())
    print("recsys train full width " + json.dumps(out["full_width"]),
          flush=True)
    del tr, x
    torch.cuda.empty_cache()
    if not (np.isfinite(losses).all() and np.isfinite(norm) and norm > 0):
        raise AssertionError(f"recsys train: losses {losses}, grad norm "
                             f"{norm}")
    return out


# ------------------------------------------------------------------ GNNs ---
GNN_FWD_RMS = 1e-5     # f32 logits, card against CPU (segment sums in
#   another order: atomics on the card)
REDDIT_AVG_DEGREE = 24
GNN_STEPS = 3


# a training step's bound: 3x the forward's operations (the backward
# takes two products a forward product), and the forward's bytes plus the
# optimizer's a parameter (f32 AdamW: the weight, its gradient and two
# moments read, the weight and moments written: 28 bytes)
STEP_OPS, STEP_PARAM_BYTES = 3, 28


def gnn_bounds(cfg, n_nodes: int, n_edges: int, d_in: int) -> dict:
    """A forward's bound (features and weights read, logits written;
    operations: the products, GCN one a layer, SAGE two, and the edge sums)
    and a training step's."""
    dims = cfg.dims()
    mult = 2 if cfg.arch == "sage" else 1
    ops = sum(2 * mult * n_nodes * a * b + n_edges * a
              for a, b in zip(dims[:-1], dims[1:]))
    n_bytes = 4 * (n_nodes * d_in + cfg.n_params() + n_nodes * cfg.d_out) \
        + 8 * n_edges
    fwd, by = bound_ms(n_bytes, ops)
    step, step_by = bound_ms(n_bytes + STEP_PARAM_BYTES * cfg.n_params(),
                             STEP_OPS * ops)
    return dict(forward_bound_ms=fwd, bound_by=by, step_bound_ms=step,
                step_bound_by=step_by)


def gnn_cuda_vs_cpu(label, cfg, dev, graph_cpu, batches_list, loss_fn,
                    tmp) -> dict:
    """One forward and GNN_STEPS Trainer steps of `cfg` on the card and on
    the CPU from the CPU's seed-0 weights: logits within GNN_FWD_RMS,
    losses within TRAIN_REL_TOL; the card's forward and step timed."""
    from repro_torch.models import gnn
    from repro_torch.train import loop, optim
    params = gnn.init_params(cfg, seed=0, device="cpu")
    logits, hist, times = [], [], {}
    for i, d in enumerate((dev, torch.device("cpu"))):
        graph = tuple(t.to(d) for t in graph_cpu)
        p = tree_to(params, d, copy=True)
        with torch.no_grad():
            logits.append(gnn.forward(p, graph[0], graph[1], cfg).cpu())
            if i == 0:
                times["forward_ms"] = time_ms(
                    lambda: gnn.forward(p, graph[0], graph[1], cfg), 5)
        tr = loop.Trainer(loss_fn, p, loop.TrainerConfig(
            ckpt_dir=str(tmp / f"{label}-{i}"), log_every=10 ** 9,
            ckpt_every=10 ** 9), optim.AdamWConfig(warmup_steps=5,
                                                   total_steps=50))
        losses, step_ms = [], []
        for s in range(GNN_STEPS):
            x = tuple(t.to(d) for t in batches_list[s])
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            losses.append(float(tr.train_step(x)))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t1) * 1e3)
        hist.append(losses)
        if i == 0:
            times["step_ms"] = step_ms
        del tr, p, graph
    fwd = rel_err(logits[0], logits[1])
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(*hist))
    report = dict(config=label, logits_rel_rms=fwd,
                  tolerance_rel_rms=GNN_FWD_RMS, losses_cuda=hist[0],
                  losses_cpu=hist[1], max_loss_rel_err=loss_err,
                  tolerance_rel=TRAIN_REL_TOL, **times)
    if not (fwd <= GNN_FWD_RMS and loss_err <= TRAIN_REL_TOL
            and np.isfinite(hist[0]).all()):
        raise AssertionError(f"gnn {label}: card against CPU: logits "
                             f"{fwd}, losses {loss_err}")
    return report


def check_gnn(dev, tmp) -> dict:
    """gcn-cora at full width on a Cora-sized synthetic graph (2,708 nodes,
    10,556 edges: `random_power_law_graph(2708, 1, seed=0)`'s edges thinned
    by default_rng(1); 1,433 features, 7 classes) through the training
    launcher's `gnn_graph` and the launcher's loss and optimizer;
    graphsage-reddit at full width (602 features,
    128 hidden, 41 classes) on 232,965 nodes with `NeighborSampler` blocks
    of 1,024 seeds at the config's sample sizes (25, 10). Each: a forward
    and GNN_STEPS Trainer steps, card against CPU."""
    from repro_torch.configs import registry
    from repro_torch.data import graphs
    from repro_torch.launch import train as launch_train
    from repro_torch.models import gnn
    out: dict = {}
    # gcn-cora, the full graph
    cfg = registry.get("gcn-cora").config
    shape = registry.GNN_SHAPES["full_graph_sm"]
    n = shape["n_nodes"]
    full = graphs.random_power_law_graph(n, 1, seed=0)
    keep = np.sort(np.random.default_rng(1).choice(
        full.shape[1], shape["n_edges"], replace=False))
    edges = full[:, keep]
    graph = launch_train.gnn_graph(cfg, "cpu", n, edges)

    def gcn_loss(p, x, e, labels, mask):
        return gnn.nll_loss(p, x, e, labels, mask, cfg)
    rep = gnn_cuda_vs_cpu("gcn-cora", cfg, dev, graph,
                          [graph] * GNN_STEPS, gcn_loss, tmp)
    rep.update(nodes=n, edges=int(edges.shape[1]), features=cfg.d_in,
               nodes_per_s=n / (np.median(rep["step_ms"]) / 1e3),
               **gnn_bounds(cfg, n, edges.shape[1], cfg.d_in))
    out["gcn-cora"] = rep
    print("gnn " + json.dumps(rep), flush=True)
    # graphsage-reddit, sampled blocks
    cfg = registry.get("graphsage-reddit").config
    shape = registry.GNN_SHAPES["minibatch_lg"]
    n, seeds = shape["n_nodes"], shape["batch_nodes"]
    t0 = time.perf_counter()
    edges = graphs.random_power_law_graph(n, REDDIT_AVG_DEGREE, seed=0)
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((n, cfg.d_in), dtype=np.float32)
    labels = rng.integers(0, cfg.d_out, n).astype(np.int32)
    sampler = graphs.NeighborSampler(edges, n, feats, labels,
                                     cfg.sample_sizes, seed=0)
    build_s = time.perf_counter() - t0
    n_edges = int(edges.shape[1])
    del edges
    t0 = time.perf_counter()
    blocks = [sampler.sample(np.sort(rng.choice(n, seeds, replace=False)))
              for _ in range(GNN_STEPS)]
    sample_s = (time.perf_counter() - t0) / GNN_STEPS
    del sampler, feats
    as_tensors = [tuple(torch.from_numpy(a) for a in
                        (blk.feats, blk.edges, blk.labels, blk.mask))
                  for blk in blocks]

    def sage_loss(p, x, e, labels_, mask):
        return gnn.nll_loss(p, x, e, labels_, mask, cfg)
    rep = gnn_cuda_vs_cpu("graphsage-reddit", cfg, dev, as_tensors[0],
                          as_tensors, sage_loss, tmp)
    blk = blocks[0]
    n_pad, e_pad = blk.feats.shape[0], blk.edges.shape[1]
    rep.update(nodes=n, edges=n_edges, reddit_edges=shape["n_edges"],
               graph_build_s=build_s, sample_s=sample_s, seeds=seeds,
               fanouts=list(cfg.sample_sizes), block_nodes=int(n_pad),
               block_real_nodes=int((blk.nodes >= 0).sum()),
               block_edges=int(e_pad),
               seeds_per_s=seeds / (np.median(rep["step_ms"]) / 1e3),
               **gnn_bounds(cfg, n_pad, e_pad, cfg.d_in))
    out["graphsage-reddit"] = rep
    print("gnn " + json.dumps(rep), flush=True)
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------- GraphCast --
GRAPHCAST_REL_TOL = 5e-2   # bf16 forward against f32, relative RMS
GRID_DEG = 0.25            # the 0.25-degree 721 x 1,440 grid
MESH_NODES = 40_962        # a refinement-6 icosahedral mesh's node count
MESH_RADIUS, G2M_RADIUS = 1.5, 1.0   # degrees of lon/lat


def graphcast_graph(grid_deg: float = GRID_DEG,
                    n_mesh: int = MESH_NODES) -> dict:
    """Grid and mesh nodes as (lon, lat) degrees: the grid every
    `grid_deg`, the mesh a Fibonacci lattice of `n_mesh` points on the
    sphere (near-uniform, as an icosahedral mesh is); mesh edges by
    `graphs.spatial_graph` within MESH_RADIUS, grid->mesh by
    `graphs.grid_mesh_edges` within G2M_RADIUS, mesh->grid the same pairs
    reversed: the STREAK radius join builds all three."""
    from repro_torch.data import graphs
    i = np.arange(n_mesh) + 0.5
    mesh = np.stack([(i * 137.50776405003785) % 360.0,
                     np.degrees(np.arcsin(1 - 2 * i / n_mesh))], 1)
    lat = np.linspace(-90.0, 90.0, int(round(180 / grid_deg)) + 1)
    lon = np.arange(int(round(360 / grid_deg))) * grid_deg
    grid = np.stack(np.meshgrid(lon, lat), -1).reshape(-1, 2)
    g2m = graphs.grid_mesh_edges(grid, mesh, G2M_RADIUS)
    return dict(n_grid=len(grid), n_mesh=n_mesh, grid_shape=(len(lat),
                                                             len(lon)),
                g2m=g2m, mesh_edges=graphs.spatial_graph(mesh, MESH_RADIUS),
                m2g=np.ascontiguousarray(g2m[::-1]))


def graphcast_flops(cfg, g: dict) -> float:
    """The forward's product operations from the shapes (2 per MAC)."""
    h, v = cfg.d_hidden, cfg.n_vars
    mlp2, mlp3 = 2 * (2 * h * h + h * h), 2 * (3 * h * h + h * h)
    e1, em, e2 = (g["g2m"].shape[1], g["mesh_edges"].shape[1],
                  g["m2g"].shape[1])
    return (2 * g["n_grid"] * v * h * 2 + e1 * mlp2 + g["n_mesh"] * mlp2
            + cfg.n_layers * (em * mlp3 + g["n_mesh"] * mlp2)
            + e2 * mlp2 + g["n_grid"] * mlp2)


def dropped_residual_process(graphcast):
    """A processor block with its node residual dropped (m = MLP(...)
    instead of m + MLP(...)): the planted fault the bf16 check must catch."""
    F = torch.nn.functional

    def process(m, e, src, dst, n_mesh, ew1, ew2, nw1, nw2):
        e = e + F.silu(torch.cat([e, m[src], m[dst]], -1) @ ew1) @ ew2
        agg = graphcast.segment_sum(e, dst, n_mesh)
        return F.silu(torch.cat([m, agg], -1) @ nw1) @ nw2, e
    return process


def check_graphcast(dev, tmp) -> dict:
    """The full graphcast config (16 layers, d_hidden 512, 227 variables,
    bf16, remat) on the 0.25-degree grid (1,038,240 nodes) and a
    40,962-node mesh: the bf16 forward against an f32 forward of the same
    weights within GRAPHCAST_REL_TOL relative RMS, a dropped processor
    residual failing that check, and one training step (AdamW) with the
    processor blocks recomputed in the backward pass (each block run twice
    a step)."""
    from repro_torch import pytree
    from repro_torch.configs import registry
    from repro_torch.models import graphcast
    from repro_torch.train import loop, optim
    cfg = registry.get("graphcast").config
    t0 = time.perf_counter()
    g = graphcast_graph()
    build_s = time.perf_counter() - t0
    edges = {k: torch.from_numpy(g[k]).to(dev)
             for k in ("g2m", "mesh_edges", "m2g")}
    rng = np.random.default_rng(0)
    grid_x = torch.from_numpy(rng.standard_normal(
        (g["n_grid"], cfg.n_vars), dtype=np.float32)).to(dev)
    params = graphcast.init_params(cfg, seed=0, device=dev)
    args = (edges["g2m"], edges["mesh_edges"], edges["m2g"], g["n_mesh"])
    with torch.no_grad():
        want = graphcast.forward(
            pytree.tree_map(lambda x: x.float(), params), grid_x, *args,
            dataclasses.replace(cfg, dtype="float32"))
        got = graphcast.forward(params, grid_x, *args, cfg)
        err = rel_err(got, want)
        del got
        torch.cuda.synchronize()
        fwd_ms = wall_ms(lambda: graphcast.forward(params, grid_x, *args,
                                                   cfg), 3)
        clean = graphcast._process
        graphcast._process = dropped_residual_process(graphcast)
        try:
            planted = rel_err(graphcast.forward(params, grid_x, *args, cfg),
                              want)
        finally:
            graphcast._process = clean
    del want
    torch.cuda.empty_cache()
    n_ops = graphcast_flops(cfg, g)
    n_bytes = 4 * grid_x.numel() * 2 + 2 * cfg.n_params()
    bound = bound_ms(n_bytes, n_ops, BF16_OPS_PER_S)
    # the step: also the target read, and AdamW on bf16 weights with f32
    # moments (weight and gradient 2 bytes, moments 4, read and written)
    step_bound = bound_ms(n_bytes + 4 * grid_x.numel() + 22 * cfg.n_params(),
                          STEP_OPS * n_ops, BF16_OPS_PER_S)
    # one training step, the processor recomputed in the backward pass
    calls = [0]

    def counted(*a):
        calls[0] += 1
        return clean(*a)
    target = torch.from_numpy(rng.standard_normal(
        (g["n_grid"], cfg.n_vars), dtype=np.float32)).to(dev)
    tr = loop.Trainer(
        lambda p, x, y: graphcast.mse_loss(p, x, y, *args, cfg), params,
        loop.TrainerConfig(ckpt_dir=str(tmp / "graphcast"), log_every=10 ** 9,
                           ckpt_every=10 ** 9),
        optim.AdamWConfig(warmup_steps=5, total_steps=50))
    torch.cuda.reset_peak_memory_stats()
    graphcast._process = counted
    try:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss = float(tr.train_step((grid_x, target)))
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t1) * 1e3
    finally:
        graphcast._process = clean
    report = dict(
        layers=cfg.n_layers, d_hidden=cfg.d_hidden, n_vars=cfg.n_vars,
        dtype=cfg.dtype, grid=list(g["grid_shape"]), grid_nodes=g["n_grid"],
        mesh_nodes=g["n_mesh"], g2m_edges=int(g["g2m"].shape[1]),
        mesh_edges=int(g["mesh_edges"].shape[1]),
        m2g_edges=int(g["m2g"].shape[1]),
        edge_dtype=str(edges["g2m"].dtype).removeprefix("torch."),
        graph_build_s=build_s,
        parameters=cfg.n_params(), bf16_vs_f32_rel_rms=err,
        planted_dropped_residual_rel_rms=planted,
        tolerance_rel_rms=GRAPHCAST_REL_TOL, forward_ms=fwd_ms,
        forward_bound_ms=bound[0], bound_by=bound[1], forward_tflop=n_ops
        / 1e12, train_step_ms=step_ms, step_bound_ms=step_bound[0],
        step_bound_by=step_bound[1], train_loss=loss,
        grad_norm=float(tr.metrics["grad_norm"]),
        processor_calls_in_the_step=calls[0],
        max_memory_allocated=torch.cuda.max_memory_allocated())
    print("graphcast " + json.dumps(report), flush=True)
    del tr, params, grid_x, target, edges
    torch.cuda.empty_cache()
    if not err <= GRAPHCAST_REL_TOL:
        raise AssertionError(f"graphcast: bf16 forward {err} from f32")
    if not planted > GRAPHCAST_REL_TOL:
        raise AssertionError(f"graphcast: the dropped residual passes "
                             f"({planted} <= {GRAPHCAST_REL_TOL})")
    if calls[0] != 2 * cfg.n_layers or not (
            np.isfinite(loss) and np.isfinite(report["grad_norm"])
            and report["grad_norm"] > 0):
        raise AssertionError(f"graphcast: training step: {calls[0]} block "
                             f"calls, loss {loss}, grad norm "
                             f"{report['grad_norm']}")
    return report


# ------------------------------------------------------------------ NequIP --
NEQUIP_RTOL = 1e-4        # invariances, the reference's rtol
NEQUIP_CPU_RMS = 1e-5     # energies, card against CPU (f32 sums reordered)
MOLECULE_BOX = 17.0       # Angstrom: ~64 directed edges at cutoff 5


def molecule_batch(cfg, shape: dict, seed: int = 0) -> dict:
    """`shape`'s batch of molecules (128 x 30 atoms): positions uniform in
    a MOLECULE_BOX cube, species from default_rng(seed), cutoff graphs from
    `graphs.spatial_graph` (the STREAK radius join, refined in 3-d), as
    one block-diagonal batch."""
    from repro_torch.data import graphs
    rng = np.random.default_rng(seed)
    n, b = shape["n_nodes"], shape["batch"]
    pos = rng.uniform(0, MOLECULE_BOX, (b, n, 3))
    species = rng.integers(0, cfg.n_species, (b, n)).astype(np.int32)
    edges = np.concatenate([graphs.spatial_graph(pos[i], cfg.cutoff) + i * n
                            for i in range(b)], axis=1)
    return dict(species=species.reshape(-1),
                positions=pos.reshape(-1, 3).astype(np.float32),
                edges=edges.astype(np.int32),
                graph_ids=np.repeat(np.arange(b), n).astype(np.int32),
                n_graphs=b)


def check_nequip(dev) -> dict:
    """The full nequip config on the molecule shape through
    `forward_batched`: the batch's energies invariant under a random
    rotation and translation and under an atom permutation (NEQUIP_RTOL,
    relative over the batch's energy vector), and the card equal to the
    CPU within NEQUIP_CPU_RMS relative RMS."""
    from repro_torch.configs import registry
    from repro_torch.models import equivariant
    cfg = registry.get("nequip").config
    mb = molecule_batch(cfg, registry.GNN_SHAPES["molecule"])
    params = equivariant.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(1)

    def energies(d, species, positions, edges, graph_ids):
        with torch.no_grad():
            return equivariant.forward_batched(
                tree_to(params, d), torch.from_numpy(species).to(d),
                torch.from_numpy(positions).to(d),
                torch.from_numpy(edges).to(d),
                torch.from_numpy(graph_ids).to(d), mb["n_graphs"], cfg)
    base = (mb["species"], mb["positions"], mb["edges"], mb["graph_ids"])
    e = energies(dev, *base)
    e_cpu = energies(torch.device("cpu"), *base)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    q = q if np.linalg.det(q) > 0 else -q
    moved = (mb["positions"] @ q.T + rng.normal(size=(1, 3))).astype(
        np.float32)
    e_rot = energies(dev, mb["species"], moved, mb["edges"], mb["graph_ids"])
    perm = rng.permutation(len(mb["species"]))
    inv = np.argsort(perm)
    e_perm = energies(dev, mb["species"][perm], mb["positions"][perm],
                      inv[mb["edges"]].astype(np.int32),
                      mb["graph_ids"][perm])
    p_dev = tree_to(params, dev)
    inputs = [torch.from_numpy(a).to(dev) for a in base]
    with torch.no_grad():
        fwd_ms = time_ms(lambda: equivariant.forward_batched(
            p_dev, *inputs, mb["n_graphs"], cfg), 5)
    n_edges, n_atoms, c = mb["edges"].shape[1], len(mb["species"]), \
        cfg.n_channels
    paths = equivariant.allowed_paths(cfg.l_max)
    # a layer: the radial MLP per edge, each path's coupling per edge and
    # channel, the mix per atom (2 ops per MAC)
    per_layer = n_edges * 2 * (cfg.n_rbf * cfg.radial_hidden
                               + cfg.radial_hidden * len(paths) * c) \
        + sum(n_edges * c * 2 * (2 * l1 + 1) * (2 * l2 + 1) * (2 * l3 + 1)
              for l1, l2, l3 in paths) \
        + n_atoms * 2 * c * c * sum(2 * l + 1 for l in range(cfg.l_max + 1))
    bound = bound_ms(4 * (n_atoms * 4 + n_edges * 2 + cfg.n_params()),
                     cfg.n_layers * per_layer)
    # over the batch: |E' - E| / |E| as vectors (a molecule whose energy
    # sums to near 0 has a per-molecule ratio far above its rounding)
    rot_err, perm_err = rel_err(e_rot, e), rel_err(e_perm, e)
    report = dict(layers=cfg.n_layers, channels=c, l_max=cfg.l_max,
                  n_rbf=cfg.n_rbf, cutoff=cfg.cutoff,
                  molecules=mb["n_graphs"], atoms=n_atoms, edges=n_edges,
                  edges_per_molecule=n_edges / mb["n_graphs"],
                  energies_finite=bool(torch.isfinite(e).all()),
                  energy_abs_min=float(e.abs().min()),
                  energy_abs_mean=float(e.abs().mean()),
                  rotation_rel_err=rot_err, permutation_rel_err=perm_err,
                  rotation_max_rel_err_a_molecule=float(
                      ((e_rot - e).abs() / e.abs()).max()),
                  permutation_max_rel_err_a_molecule=float(
                      ((e_perm - e).abs() / e.abs()).max()),
                  tolerance_rel=NEQUIP_RTOL,
                  cuda_vs_cpu_rel_rms=rel_err(e.cpu(), e_cpu),
                  tolerance_rel_rms=NEQUIP_CPU_RMS, forward_ms=fwd_ms,
                  forward_bound_ms=bound[0], bound_by=bound[1])
    print("nequip " + json.dumps(report), flush=True)
    if not (report["energies_finite"] and rot_err <= NEQUIP_RTOL
            and perm_err <= NEQUIP_RTOL
            and report["cuda_vs_cpu_rel_rms"] <= NEQUIP_CPU_RMS):
        raise AssertionError(f"nequip: {report}")
    return report




# ------------------------------------------------- the multi-device layer --
MESH_RETRIEVAL_CASES = (("retrieval_cand", 100), ("serve_p99", 100))
MESH_SHARDS = 8                 # lgd's store, dealt over the shard mesh
MESH_POSITIONS = 4              # the explicit mesh's positions on one card


def dealt(items_s, order, bounds, block: int, n_shards: int, layout: str):
    """The norm-sorted catalog as each shard's P("model") slice holds it:
    "contiguous" (the reference's shard_map: blocks [i·nb/S, (i+1)·nb/S)),
    or "round-robin" (block b to shard b mod S, each shard's blocks still
    in falling bound order: the data prep the reference's
    `streak_topk_sharded` docstring asks for)."""
    nb = bounds.shape[0]
    if layout == "contiguous":
        return items_s, order, bounds
    perm = torch.tensor([b for s in range(n_shards)
                         for b in range(s, nb, n_shards)],
                        device=bounds.device)
    d = items_s.shape[1]
    return (items_s.view(nb, block, d)[perm].reshape(-1, d),
            order.view(nb, block)[perm].reshape(-1), bounds[perm])


def mesh_retrieval(dev) -> list:
    """Both sharded retrievals over sasrec's catalog (10^6 x 50 f32, 16
    blocks of 62,500, the "retrieval" phase's states at retrieval_cand and
    serve_p99, k = 100), laid out P("model") once over a 4-entry mesh on
    the card and, with two or more cards, over `make_host_mesh(1, n)`: ids
    and scores equal to the unsharded `streak_topk`/`blocked_topk`'s bit
    for bit; blocks read (the largest of any shard, and each shard's) and
    wall ms. The streak scan runs on the reference's contiguous slices and
    on blocks dealt round-robin (`dealt`)."""
    from repro_torch.configs import registry
    from repro_torch.launch import mesh as pmesh
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import sasrec
    from repro_torch.serve import retrieval
    cfg = registry.get("sasrec").config
    n = cfg.n_items
    block = max(64, n // 16)
    rng = np.random.default_rng(1)           # the retrieval phase's states
    meshes = {"4 entries on one card": pmesh.make_host_mesh(
        1, 4, devices=[dev] * 4)}
    n_cards = torch.cuda.device_count()
    if n_cards >= 2 and (n // block) % n_cards == 0 and n % n_cards == 0:
        meshes[f"make_host_mesh(1, {n_cards})"] = pmesh.make_host_mesh(
            1, n_cards)
    rows = []
    with torch.no_grad():
        params, _ = launch_serve.popularity_catalog(cfg, dev)
        items = params["item_embed"]
        items_s, order = retrieval.sort_items_by_norm(items, block)
        bounds = retrieval.block_bounds(items_s, block)
        states = {}
        for name, _ in MESH_RETRIEVAL_CASES:
            b = registry.RECSYS_SHAPES[name]["batch"]
            seq = torch.from_numpy(rng.integers(1, n, (b, cfg.seq_len))
                                   .astype(np.int32)).to(dev)
            states[name] = sasrec.user_state(params, seq, cfg)
        for label, mesh in meshes.items():
            spec = pmesh.NamedSharding(mesh, pmesh.PartitionSpec("model"))
            n_shards = mesh.shape["model"]
            put_items = pmesh.device_put(items, spec)
            for layout in ("contiguous", "round-robin"):
                put = [pmesh.device_put(x, spec) for x in dealt(
                    items_s, order, bounds, block, n_shards, layout)]
                for name, k in MESH_RETRIEVAL_CASES:
                    rows.append(mesh_retrieval_row(
                        retrieval, label, layout, mesh, put, put_items,
                        (items, items_s, order, bounds), states[name], name,
                        k, block))
    del params, items, items_s, order, bounds, states
    torch.cuda.empty_cache()
    return rows


def mesh_retrieval_row(retrieval, label, layout, mesh, put, put_items,
                       catalog, st, name, k, block) -> dict:
    """One (mesh, layout, batch) of `mesh_retrieval`: the sharded scans
    against the unsharded ones, bit for bit, with blocks read and ms."""
    items, items_s, order, bounds = catalog
    ws, wi, read1 = retrieval.streak_topk(st, items_s, order, bounds, k,
                                          block)

    def streak():
        return retrieval.streak_topk_sharded(st, *put, mesh, k=k,
                                             block=block)

    def blocked():
        return retrieval.blocked_topk_sharded(st, put_items, mesh, k=k,
                                              block=block)
    ss, si, read = streak()
    by_shard = [retrieval.streak_topk(st, *parts, k, block)[2]
                for parts in zip(*(x.along("model") for x in put))]
    row = dict(
        mesh=label, layout=layout, positions=mesh.shape["model"], case=name,
        users=int(st.shape[0]), k=k, blocks_read_sharded=read,
        blocks_read_by_shard=by_shard, blocks_read_unsharded=read1,
        blocks_per_shard=int(bounds.shape[0]) // mesh.shape["model"],
        streak_equal=bool(torch.equal(ss, ws) and torch.equal(si, wi)),
        streak_sharded_ms=wall_ms(streak, 5),
        streak_unsharded_ms=wall_ms(lambda: retrieval.streak_topk(
            st, items_s, order, bounds, k, block), 5))
    if layout == "contiguous":
        bs, bi = retrieval.blocked_topk(st, items, k, block)
        gs, gi = blocked()
        row.update(blocked_equal=bool(torch.equal(gs, bs)
                                      and torch.equal(gi, bi)),
                   blocked_sharded_ms=wall_ms(blocked, 3),
                   blocked_unsharded_ms=wall_ms(
                       lambda: retrieval.blocked_topk(st, items, k, block),
                       3))
    print("mesh retrieval " + json.dumps(row), flush=True)
    if not (row["streak_equal"] and row.get("blocked_equal", True)
            and max(by_shard) == read and 0 < read <= row["blocks_per_shard"]):
        raise AssertionError(f"mesh retrieval {label} {layout} {name}: the "
                             "sharded answer differs")
    return row


def mesh_descent(rt, ops, ref, lgd, unsharded, dev, entry) -> dict:
    """lgd's store in MESH_SHARDS shards, its fused descent laid over
    `make_shard_mesh(8)` (every card: one position on one card) and over an
    explicit MESH_POSITIONS-position mesh on the card, Q1-Q8 under both
    joins with the counts set to 0 before and read after: one
    `tree_descend` launch a mesh position a sharded descent; answers equal
    to the unsharded card run's; every recorded descent's masks equal to
    the plain version's and, over more than one position, to the one
    launch over all shards; events ms of the median descent laid out over
    the mesh and as one launch. `entry` (tree_descend's) gains "mesh"."""
    import types
    from repro_torch.core import shard as shard_mod
    from repro_torch.launch import mesh as pmesh
    base = shard_mod.shard_store(lgd.store, MESH_SHARDS)
    stores = {
        f"make_shard_mesh({MESH_SHARDS})": base.on_mesh(
            pmesh.make_shard_mesh(MESH_SHARDS)),
        f"{MESH_POSITIONS} positions on one card": base.on_mesh(
            pmesh.make_shard_mesh(MESH_SHARDS,
                                  devices=[dev] * MESH_POSITIONS))}
    out = {}
    for label, store in stores.items():
        positions = store.tree_shards.mesh.shape["shard"]
        recorded = []
        over_mesh = shard_mod.descend_over_mesh

        def recording(placed, cs, box_keys):
            res = over_mesh(placed, cs, box_keys)
            recorded.append((placed, cs.clone(), box_keys.clone()))
            return res
        sds = types.SimpleNamespace(store=store, queries=lgd.queries)
        shard_mod.descend_over_mesh = recording
        try:
            ops.reset_launch_counts()
            runs = {join: run_queries(rt, {"lgd": (sds, 8)}, join, "cuda")
                    for join in ("fused", "kernel")}
            launches = dict(ops.LAUNCHES)
        finally:
            shard_mod.descend_over_mesh = over_mesh
        if not recorded or launches["tree_descend"] != len(recorded) \
                * positions:
            raise AssertionError(
                f"mesh descent {label}: {launches['tree_descend']} launches "
                f"for {len(recorded)} descents over {positions} positions: "
                "not one launch a position")
        for join, got in runs.items():
            for key, (res, _) in got.items():
                require_same_rows_by_name(
                    f"mesh descent {label} {join} Q{key[1] + 1} vs unsharded",
                    res[0], res[1], unsharded[join][key][0])
        whole = shard_mod.stacked_node_planes(store.tree_shards, dev)
        for placed, cs, boxes in recorded:
            got = over_mesh(placed, cs, boxes)
            require_equal(f"mesh descent {label} vs plain", [got],
                          [ref.tree_descend_sharded_ref(whole, cs, boxes)])
            if positions > 1:
                require_equal(f"mesh descent {label} vs one launch", [got],
                              [ops.tree_descend_sharded(whole, cs, boxes)])
        sizes = sorted(recorded, key=lambda r: r[2].shape[1])
        placed, cs, boxes = sizes[len(sizes) // 2]
        bound = sharded_bound(whole, cs, boxes)
        row = dict(
            mesh=label, positions=positions, shards=MESH_SHARDS,
            shards_per_position=MESH_SHARDS // positions,
            descents=len(recorded), launches=launches["tree_descend"],
            launches_per_position_per_descent=launches["tree_descend"]
            / (len(recorded) * positions),
            median_shape=f"S={MESH_SHARDS} B={boxes.shape[0]} "
            f"M={boxes.shape[1]} N_max={whole.shape[2]}",
            event_ms=event_ms(lambda: over_mesh(placed, cs, boxes)),
            one_launch_event_ms=event_ms(lambda: ops.tree_descend_sharded(
                whole, cs, boxes)),
            bound_ms=bound[0], bound_by=bound[1],
            resident_plane_sets=len(store.tree_shards.planes))
        out[label] = row
        print("mesh descent " + json.dumps(row), flush=True)
    entry["mesh"] = out
    return out


def mesh_reshard(dev) -> dict:
    """`device_put` of a (12, 4) f32 tensor P("data", None) over a data-4
    mesh on the card, `shrink_mesh` by one device (data 3), `reshard_tree`
    onto it: three (4, 4) blocks, reassembled bit-equal."""
    from repro_torch.dist import elastic
    from repro_torch.launch import mesh as pmesh
    mesh = pmesh.make_host_mesh(4, 1, devices=[dev] * 4)
    x = torch.arange(48, dtype=torch.float32, device=dev).reshape(12, 4)
    a = pmesh.device_put(x, pmesh.NamedSharding(
        mesh, pmesh.PartitionSpec("data", None)))
    new = elastic.shrink_mesh(mesh, 1)
    y = elastic.reshard_tree({"x": a}, {"x": a.sharding}, new)["x"]
    row = dict(mesh=dict(new.shape), blocks=[list(b.shape)
                                             for b in y.blocks.flat],
               equal=bool(torch.equal(y.gather(dev), x)))
    print("mesh reshard " + json.dumps(row), flush=True)
    if not (row["equal"] and row["blocks"] == [[4, 4]] * 3):
        raise AssertionError(f"mesh reshard: {row}")
    return row


# ---------------------------------------- gcn-cora at ogb_products' size --
OGB_TRAIN_SHARE = 0.08          # ogbn-products trains on ~8% of its nodes
# logits (Frobenius) and first-step loss (relative) against the sparse
# product: two f32 summation orders over ~25 in-edges a node
OGB_REL_TOL = 1e-4


def gcn_sparse_logits(params, x, edges, cfg) -> torch.Tensor:
    """GCN's forward computed apart from `models/gnn.py`: degrees by
    `bincount`, the normalised adjacency (edge j -> i weighs
    1/sqrt(d_i d_j), d the in-degree + 1) one coalesced sparse matrix, each
    layer's aggregation a `torch.sparse.mm`, plus the self loop h / d."""
    src, dst = edges[0], edges[1]
    n = x.shape[0]
    deg = torch.bincount(dst, minlength=n).to(x.dtype) + 1.0
    r = deg.rsqrt()
    adj = torch.sparse_coo_tensor(torch.stack([dst, src]), r[dst] * r[src],
                                  (n, n), check_invariants=False).coalesce()
    h = x
    for i, lp in enumerate(params["layers"]):
        h = (torch.sparse.mm(adj, h) + h / deg[:, None]) @ lp["w"]
        if i < len(params["layers"]) - 1:
            h = torch.relu(h)
    return h


def masked_nll(logits, labels, mask) -> float:
    """`gnn.nll_loss`'s mean NLL over the masked nodes, by `cross_entropy`."""
    return float(torch.nn.functional.cross_entropy(
        logits[mask].double(), labels[mask]))


def ogb_graph(dev, shape: dict) -> tuple:
    """ogb_products' counts drawn on the card from a seeded generator:
    (features (N, 100) f32, edges (2, E) int64, labels (N,) in 47
    classes, training mask (N,))."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    n, e = shape["n_nodes"], shape["n_edges"]
    x = torch.randn((n, shape["d_feat"]), generator=gen, device=dev)
    edges = torch.randint(0, n, (2, e), generator=gen, device=dev)
    labels = torch.randint(0, shape["n_classes"], (n,), generator=gen,
                           device=dev)
    mask = torch.rand((n,), generator=gen, device=dev) < OGB_TRAIN_SHARE
    return x, edges, labels, mask


def check_ogb_gcn(dev, tmp) -> dict:
    """gcn-cora's architecture (2 layers, 16 hidden, sym-norm sums) at
    ogb_products' counts (2,449,029 nodes x 100 features, 61,859,140
    edges, 47 classes; the first phase to drive that shape; no edge cut):
    one forward and three `Trainer` steps (AdamW) on the card; wall ms and
    peak memory. Layer 1 gathers E x 100 f32 (~24.7 GB, past 2^31
    elements) and scales it (as much again) before its sums. The forward's
    logits and the first step's loss are held within OGB_REL_TOL to
    `gcn_sparse_logits` on the same inputs, and the forward over half the
    edges (a planted dropped chunk) must fail that check."""
    from repro_torch.configs import registry
    from repro_torch.models import gnn
    from repro_torch.train import loop, optim
    shape = registry.GNN_SHAPES["ogb_products"]
    cfg = dataclasses.replace(registry.get("gcn-cora").config,
                              d_in=shape["d_feat"], d_out=shape["n_classes"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    graph = ogb_graph(dev, shape)
    torch.cuda.synchronize()
    made_s = time.perf_counter() - t0
    params = gnn.init_params(cfg, seed=0, device=dev)
    with torch.no_grad():
        logits = gnn.forward(params, graph[0], graph[1], cfg)
        finite = bool(torch.isfinite(logits).all())
        fwd_peak = torch.cuda.max_memory_allocated()
        want = gcn_sparse_logits(params, graph[0], graph[1], cfg)
        logits_err = rel_err(logits, want)
        del logits
        dropped = gnn.forward(params, graph[0],
                              graph[1][:, :shape["n_edges"] // 2], cfg)
        dropped_err = rel_err(dropped, want)
        del dropped
        want_loss = masked_nll(want, graph[2], graph[3])
        del want
        fwd_ms = wall_ms(lambda: gnn.forward(params, graph[0], graph[1],
                                             cfg), 3)
    tr = loop.Trainer(
        lambda p, x, e, y, m: gnn.nll_loss(p, x, e, y, m, cfg), params,
        loop.TrainerConfig(ckpt_dir=str(tmp / "ogb"), log_every=10 ** 9,
                           ckpt_every=10 ** 9),
        optim.AdamWConfig(warmup_steps=5, total_steps=50))
    losses, step_ms = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        losses.append(float(tr.train_step(graph)))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
    report = dict(
        arch="gcn-cora", shape="ogb_products", nodes=shape["n_nodes"],
        edges=shape["n_edges"], features=shape["d_feat"],
        classes=shape["n_classes"], edges_cut=None,
        train_nodes=int(graph[3].sum()), graph_made_s=made_s,
        forward_ms=fwd_ms, forward_max_memory_allocated=fwd_peak,
        logits_rel_err=logits_err, half_edges_rel_err=dropped_err,
        first_loss_rel_err=abs(losses[0] - want_loss) / abs(want_loss),
        rel_tol=OGB_REL_TOL, losses=losses, step_ms=step_ms,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        **gnn_bounds(cfg, shape["n_nodes"], shape["n_edges"], cfg.d_in))
    print("ogb gcn " + json.dumps(report), flush=True)
    del tr, params, graph
    torch.cuda.empty_cache()
    if not (finite and np.isfinite(losses).all()
            and logits_err <= OGB_REL_TOL
            and report["first_loss_rel_err"] <= OGB_REL_TOL
            and dropped_err > OGB_REL_TOL):
        raise AssertionError(
            f"ogb gcn: forward finite {finite}, losses {losses}; against "
            f"the sparse product: logits {logits_err:.3g}, first loss "
            f"{report['first_loss_rel_err']:.3g} (tolerance "
            f"{OGB_REL_TOL:g}), half the edges {dropped_err:.3g} (must "
            "exceed it)")
    return report


# --------------------------------------------------- the counted roofline --
def roofline_records(runs: dict, out_dir) -> list:
    """The five workloads' counts (`roofline/op_count.record` on fake
    tensors: no memory, every shape's data-independent) and `analyze`'s
    three terms on the H100 model. What is counted is the plain path's
    traffic, every eager op's operands and results (the prefills with
    `use_flash=False` and query chunks of PREFILL_PLAIN_CHUNK, as their
    phases time it), not a floor on what any implementation must move.
    Each is paired with the wall ms of that same path measured earlier in
    this run (`runs`: label -> ms), and `counted_share` is the counted
    time over it; the prefills' flash ms stand beside (`runs["flash"]`)
    with no share."""
    import tempfile
    from repro_torch.configs import registry
    from repro_torch.models import gnn, graphcast, moe
    from repro_torch.models import transformer as tr
    from repro_torch.roofline import analysis, op_count
    from repro_torch.train import loop, optim
    seq = 4096
    prefill = dict(kind="prefill", seq_len=seq, global_batch=1)
    gemma = dataclasses.replace(registry.get("gemma-7b").config,
                                use_flash=False,
                                attn_chunk=PREFILL_PLAIN_CHUNK)
    qwen = dataclasses.replace(registry.get("qwen2-moe-a2.7b").config,
                               use_flash=False,
                               attn_chunk=PREFILL_PLAIN_CHUNK,
                               n_layers=runs["moe_layers"])
    gemma4 = dataclasses.replace(registry.get("gemma-7b").config, n_layers=4)
    gc = registry.get("graphcast").config
    ogb = registry.GNN_SHAPES["ogb_products"]
    gcn = dataclasses.replace(registry.get("gcn-cora").config,
                              d_in=ogb["d_feat"], d_out=ogb["n_classes"])
    g = runs["graphcast_graph"]
    recs = []
    tmp = tempfile.mkdtemp()

    def trainer(loss, params):
        return loop.Trainer(loss, params, loop.TrainerConfig(
            ckpt_dir=tmp, log_every=10 ** 9, ckpt_every=10 ** 9),
            optim.AdamWConfig(warmup_steps=5, total_steps=50))

    def step_of(t):
        return lambda state, *batch: t.train_step(batch)
    with op_count.fake_mode():
        tok = torch.zeros((1, seq), dtype=torch.long)
        p = tr.init_params(gemma, device="cpu")
        recs.append(("lm prefill", op_count.record(
            "gemma-7b", "prefill_4k", tr.forward_with_cache, p, tok, gemma,
            model_flops_per_device=analysis.model_flops(
                "gemma-7b", prefill, 1))))
        del p
        p = moe.init_params(qwen, device="cpu")
        recs.append(("moe prefill", op_count.record(
            "qwen2-moe-a2.7b", "prefill_4k", moe.forward_with_cache, p, tok,
            qwen, model_flops_per_device=2.0 * qwen.n_active_params() * seq)))
        del p
        t = trainer(lambda p_, b: tr.lm_loss(p_, b, gemma4),
                    tr.init_params(gemma4, device="cpu"))
        recs.append(("train full width", op_count.record(
            "gemma-7b", "train_4k_4layers", step_of(t), t.state_tree(),
            torch.zeros((1, seq + 1), dtype=torch.long), dtype="bfloat16",
            model_flops_per_device=6.0 * gemma4.n_params() * seq)))
        del t
        p = graphcast.init_params(gc, device="cpu")
        grid_x = torch.empty((g["grid_nodes"], gc.n_vars))
        edges = [torch.empty((2, g[k]), dtype=getattr(torch,
                                                      g["edge_dtype"]))
                 for k in ("g2m_edges", "mesh_edges", "m2g_edges")]
        recs.append(("graphcast", op_count.record(
            "graphcast", "forward_0.25deg", graphcast.forward, p, grid_x,
            *edges, g["mesh_nodes"], gc, dtype=gc.dtype,
            model_flops_per_device=g["forward_tflop"] * 1e12)))
        del p, grid_x, edges
        x = torch.empty((ogb["n_nodes"], ogb["d_feat"]))
        e = torch.empty((2, ogb["n_edges"]), dtype=torch.long)
        p = gnn.init_params(gcn, device="cpu")
        full = analysis.model_flops("gcn-cora", "ogb_products", 1)
        recs.append(("ogb gcn forward", op_count.record(
            "gcn-cora", "ogb_products_forward", gnn.forward, p, x, e, gcn,
            model_flops_per_device=full / 3)))
        y = torch.empty((ogb["n_nodes"],), dtype=torch.long)
        m = torch.empty((ogb["n_nodes"],), dtype=torch.bool)
        t = trainer(lambda p_, *b: gnn.nll_loss(p_, *b, gcn), p)
        recs.append(("ogb gcn step", op_count.record(
            "gcn-cora", "ogb_products_step", step_of(t), t.state_tree(),
            x, e, y, m, model_flops_per_device=full)))
    rows = []
    for label, rec in recs:
        rec = dict(rec, device=torch.cuda.get_device_name(0))
        path = pathlib.Path(out_dir)
        path.mkdir(parents=True, exist_ok=True)
        (path / f"{rec['arch']}_{rec['shape']}.json").write_text(
            json.dumps(rec, indent=1))
        a = analysis.analyze(rec)
        ms = runs[label]
        counted_ms = max(a["t_compute_s"], a["t_memory_s"],
                         a["t_collective_s"]) * 1e3
        rows.append(dict(
            workload=label, arch=rec["arch"], shape=rec["shape"],
            dtype=rec["dtype"], dot_flops=rec["dot_flops_per_device"],
            hbm_bytes=rec["hbm_bytes_per_device"],
            collective_bytes=sum(v["bytes"] for v in
                                 rec["collectives"].values()),
            model_flops=a["model_flops_per_device"],
            t_compute_ms=a["t_compute_s"] * 1e3,
            t_memory_ms=a["t_memory_s"] * 1e3,
            t_collective_ms=a["t_collective_s"] * 1e3,
            dominant=a["dominant"], useful_ratio=a["useful_ratio"],
            roofline_fraction=a["roofline_fraction"],
            measured_path="plain" + (f", attn_chunk {PREFILL_PLAIN_CHUNK}"
                                     if "prefill" in label else ""),
            measured_ms=ms, counted_ms=counted_ms,
            counted_share=counted_ms / ms,
            flash_ms=runs["flash"].get(label)))
    return rows


# ------------------------------------------------------------- the cells --
CELL_MEM_SHARE = 0.85    # a cell runs where its predicted peak fits this
CELL_PEAK_SLACK = 1.25   # measured peak over predicted, at most
CELL_WORKERS = 6         # processes counting the one-device records
# the smallest cell of each family, held to its CPU run
CELLS_VS_CPU = (("gcn-cora", "full_graph_sm"),
                ("graphsage-reddit", "full_graph_sm"),
                ("graphcast", "full_graph_sm"), ("nequip", "molecule"),
                ("sasrec", "serve_p99"))


def one_device_record(arch: str, shape: str) -> dict:
    """The cell's dry-run record on a one-position mesh (`launch/dryrun`:
    plain fake tensors, no card): what one device holds and allocates."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh, placeholder_devices
    mesh = make_host_mesh(1, 1, devices=placeholder_devices(1))
    return dryrun.run_cell(arch, shape, False, verbose=False, mesh=mesh,
                           art=None)


def peak_bytes(rec: dict) -> int:
    """A record's predicted peak: arguments, temporaries and the results
    that are not arguments written in place."""
    return rec["arg_bytes"] + rec["temp_bytes"] + rec["out_bytes"] \
        - rec["alias_bytes"]


def pytree_leaves(tree) -> list:
    from repro_torch import pytree
    return pytree.leaves(list(tree) if isinstance(tree, tuple) else tree)


def _floats(tree) -> list:
    return [x for x in pytree_leaves(tree)
            if torch.is_tensor(x) and x.is_floating_point()]


def cell_vs_cpu(arch, shape, cell, cpu_args, got) -> dict:
    """The card's first step against the same step on the CPU from the
    same inputs: a training step's loss within TRAIN_REL_TOL relative and
    its first moments within GNN_FWD_RMS x 10 relative RMS (f32 sums in
    other orders; NequIP's energies as NEQUIP_CPU_RMS), serve_p99's top-k
    as the retrieval phase holds it (`topk_agreement`); GraphCast's bf16
    step within GRAPHCAST_REL_TOL (its bf16 phase's limit) for both."""
    from repro_torch import pytree
    from repro_torch.configs import registry
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import sasrec
    with make_host_mesh(1, 1, devices=["cpu"]):
        want = cell.fn(*cpu_args)
    if shape == "serve_p99":
        cfg = registry.get(arch).config
        params, seq = cpu_args
        dense = sasrec.score_all(params, sasrec.user_state(params, seq, cfg))
        return topk_agreement(f"cell {arch} {shape} card vs cpu",
                              got[0].cpu(), got[1].cpu(), want[0], want[1],
                              dense)
    loss = abs(float(got[2]) - float(want[2])) / abs(float(want[2]))
    m = rel_err(torch.cat([x.flatten().cpu() for x in
                           pytree.leaves(got[1]["m"])]),
                torch.cat([x.flatten() for x in pytree.leaves(want[1]["m"])]))
    tol_loss, tol_m = (GRAPHCAST_REL_TOL, GRAPHCAST_REL_TOL) \
        if arch == "graphcast" else (TRAIN_REL_TOL, 10 * GNN_FWD_RMS)
    row = dict(loss_rel_err=loss, moments_rel_rms=m, tolerance_loss=tol_loss,
               tolerance_moments=tol_m)
    if not (loss <= tol_loss and m <= tol_m):
        raise AssertionError(f"cell {arch} {shape}: card against CPU {row}")
    return row


def run_cell_on_card(arch: str, shape: str, dev) -> dict:
    """One warm step and one measured step of the cell at its full size on
    real seeded tensors on the card: step ms by CUDA events, peak memory,
    every output finite; the smallest cells also against their CPU run."""
    from repro_torch.launch import cells
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(1, 1, devices=[dev])
    cell = cells.build_cell(arch, shape, mesh)
    torch.cuda.empty_cache()
    vs_cpu = (arch, shape) in CELLS_VS_CPU
    if vs_cpu:
        cpu_args = cells.materialize(cell, device="cpu", seed=0)
        args = [tree_to(a, dev, copy=True) if isinstance(a, dict)
                else a.to(dev) for a in cpu_args]
    else:
        args = cells.materialize(cell, device=dev, seed=0)
    with mesh:
        out = cell.fn(*args)
        torch.cuda.synchronize()
        row = dict(cell_vs_cpu(arch, shape, cell, cpu_args, out)) \
            if vs_cpu else {}
        del out
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # what the process holds beside the cell's arguments (the cuBLAS
        # workspaces, 64 MiB on the H100): not the cell's, and taken off
        held = torch.cuda.memory_allocated()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = cell.fn(*args)
        stop.record()
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    finite = all(bool(torch.isfinite(x).all()) for x in _floats(out))
    arg_bytes = sum({id(st): st.nbytes() for st in (
        x.untyped_storage() for x in pytree_leaves(args)
        if torch.is_tensor(x))}.values())
    del out, args
    torch.cuda.empty_cache()
    return dict(row, step_ms=start.elapsed_time(stop),
                max_memory_allocated=peak, held_beside_args=held - arg_bytes,
                measured_bytes=peak - (held - arg_bytes), finite=finite)


def check_cells(dev, smi: str) -> list:
    """Every one of the 40 base cells: its one-device record counted on the
    host (CELL_WORKERS processes), and where the predicted args + temps +
    outputs fit CELL_MEM_SHARE of the card, one warm and one measured step
    at the full reference size on the card. A "cell" line each: predicted
    peak GiB (`peak_bytes`), and for a cell that ran,
    `torch.cuda.max_memory_allocated` GiB, the cell's own peak (that, less
    what the process held beside the cell's arguments before the step),
    their ratio to the prediction and the step ms. Fails on a cell's own
    peak above CELL_PEAK_SLACK x predicted, an output that is not finite, or a
    smallest cell (CELLS_VS_CPU) that disagrees with its CPU run."""
    import concurrent.futures
    import multiprocessing
    from repro_torch.configs import registry
    total = torch.cuda.get_device_properties(dev).total_memory
    order = sorted(registry.all_cells(), key=lambda c: registry.get(
        c[0]).family in ("lm", "moe"))
    rows = []
    with concurrent.futures.ProcessPoolExecutor(
            CELL_WORKERS, mp_context=multiprocessing.get_context(
                "spawn")) as pool:
        futures = {pool.submit(one_device_record, *c): c for c in order}
        for fut in concurrent.futures.as_completed(futures):
            arch, shape = futures[fut]
            rec = fut.result()
            predicted = peak_bytes(rec)
            row = dict(arch=arch, shape=shape, card=smi,
                       predicted_gib=predicted / 2 ** 30,
                       arg_gib=rec["arg_bytes"] / 2 ** 30,
                       temp_gib=rec["temp_bytes"] / 2 ** 30,
                       out_gib=rec["out_bytes"] / 2 ** 30,
                       count_s=rec["compile_s"],
                       fits=predicted <= CELL_MEM_SHARE * total)
            if row["fits"]:
                ran = run_cell_on_card(arch, shape, dev)
                row.update(ran, measured_gib=ran["measured_bytes"] / 2 ** 30,
                           max_memory_allocated_gib=ran[
                               "max_memory_allocated"] / 2 ** 30,
                           ratio=ran["measured_bytes"] / predicted)
                if not (ran["finite"]
                        and ran["measured_bytes"]
                        <= CELL_PEAK_SLACK * predicted):
                    raise AssertionError(f"cell {arch} {shape}: {row}")
            rows.append(row)
            print("cell " + json.dumps(row), flush=True)
    ran = [r for r in rows if r["fits"]]
    missing = set(CELLS_VS_CPU) - {(r["arch"], r["shape"]) for r in ran}
    if len(rows) != 40 or missing:
        raise AssertionError(f"cells: {len(rows)} records, smallest cells "
                             f"not run: {missing}")
    return rows


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="write the full report (JSON) here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False      # f32 means f32
    import repro_torch as rt
    from repro_torch import pytree
    from repro_torch.core import fault, spatial_join
    from repro_torch.data import synth_rdf
    from repro_torch.kernels import _build, ops, ref

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    dev = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}")
    phase_s: dict = {}

    def phase_done(name: str, t0: float) -> None:
        phase_s[name] = time.perf_counter() - t0
        print(f"phase {name}: {phase_s[name]:.1f} s", flush=True)
        if name != "failover":
            require_clean_fault_layer(fault, ops, f"phase {name}")

    # Bloom bank uploads over the whole run, by bank and device type
    bank_uploads: collections.Counter = collections.Counter()
    device_bloom_bank = ops.device_bloom_bank

    def counting_upload(bits, device):
        bank_uploads[id(bits), torch.device(device).type] += 1
        return device_bloom_bank(bits, device)
    ops.device_bloom_bank = counting_upload

    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{len(_build.KERNELS)} kernels", flush=True)
    for name, log in _build.build_logs.items():
        used = [ln.strip() for ln in log.splitlines() if "Used" in ln]
        print(f"  {name}: {'; '.join(used)}")
    flash_build = flash_build_report(_build)
    for row in flash_build:
        print("flash build " + json.dumps(row))
    phase_done("build", t0)

    t0 = time.perf_counter()
    datasets = {
        "lgd": (synth_rdf.make_lgd(n_per_class=6000, seed=0, block=1024), 8),
        "scale1m": (synth_rdf.make_scale(1_000_000, seed=0), 2),
    }
    lgd = datasets["lgd"][0]
    yago = synth_rdf.make_yago(n_places=600, seed=1, block=128)
    baseline_sets = {"lgd": lgd, "yago": yago}
    for name, (ds, _) in datasets.items():
        print(f"data {name}: {ds.store.n_quads} quads, "
              f"{ds.store.tree.n_objects} spatial, "
              f"{ds.store.tree.n_nodes} nodes")
    phase_done("data build", t0)

    # ---- untraced host times, before any profiler session ----------------
    t0 = time.perf_counter()
    rank_call_ms = rank_call_times(ops, dev)
    for (n, m), row in rank_call_ms.items():
        print(f"rank call N={n} M={m} " + json.dumps(row))
    call_ms = path_call_times(rt, ops, datasets, dev)
    for label, row in call_ms.items():
        print(f"{label} " + json.dumps(row))
    ab = untraced_turns(rt, datasets)
    for label, passes in ab.items():
        print(f"turns {label} " + json.dumps(passes))
    phase_done("untraced turns", t0)
    t0 = time.perf_counter()
    serve_times = serve_turns(rt, lgd)
    for row in serve_times:
        print("serve " + json.dumps(row), flush=True)
    phase_done("serve turns", t0)
    t0 = time.perf_counter()
    base_turns = baseline_turns(rt, baseline_sets)
    for name, row in base_turns.items():
        print(f"baseline turns {name} " + json.dumps(row), flush=True)
    phase_done("baseline turns", t0)

    # ---- per-kernel phase: kernel vs plain version, bit for bit ----------
    t0 = time.perf_counter()
    entries = {name: dict(name=name, route="cuda",
                          source=f"src/repro_torch/csrc/{name}.cu",
                          replaces=REPLACES[name], library_ms=None)
               for name in _build.KERNELS}
    cases: list = []
    check_distance_join(ops, ref, dev, entries["distance_join"], cases)
    check_fused(ops, ref, dev, entries["fused_topk_join"])
    check_bucketed(ops, ref, dev, entries["bucketed_min_core"], cases)
    check_tree_descend(ops, ref, dev, entries["tree_descend"],
                       {n: ds.store.tree for n, (ds, _) in datasets.items()},
                       cases)
    check_bloom_probe(rt, ops, ref, dev, entries["bloom_probe"], lgd, cases)
    check_merge_join_ranks(ops, ref, dev, entries["merge_join_ranks"], cases,
                           rank_call_ms)
    check_block_scan(ops, ref, dev, entries["block_scan"], cases)
    check_morton(ops, ref, dev, entries["morton_encode"])
    entries["flash_attention"]["ptxas"] = flash_build
    check_flash(ops, ref, dev, entries["flash_attention"], cases)
    for e in entries.values():
        lib = ("" if e["library_ms"] is None
               else f", library {e['library_ms']:.4f} ms")
        print(f"kernel {e['name']} [{e['shape']}] on {kind}: "
              f"{e.get('agreement', 'bit-identical')}; "
              f"{e['ms']:.4f} ms a call, {e['device_ms']} ms on the device "
              f"(trace), {e['event_ms']:.5f} (events), "
              f"plain {e['plain_ms']:.4f} ms{lib}, bound "
              f"{e['bound_ms']:.5f} ms ({e['bound_by']})")
    for c in cases:
        print("case " + json.dumps(c))
    sys.stdout.flush()
    phase_done("kernels", t0)

    # ---- end-to-end phase: the main path on the card ---------------------
    t0 = time.perf_counter()
    tag: dict = {}              # the query set running
    # the main path over lgd and scale1m, and the YAGO queries, whose
    # object-position joins (Q5, Q6, Q8) reach the spatial variable through
    # an object
    main_sets = dict(datasets, yago=(yago, 8))
    checked = {"fused": main_sets, "kernel": main_sets}
    with recording_launches(ops, ref, _build, spatial_join, tag) as rec:
        ops.reset_launch_counts()
        uploads = ops.rank_table_uploads
        retries = ops.pair_capacity_retries
        cuda_runs = {join: run_queries(rt, sets, join, "cuda", tag)
                     for join, sets in checked.items()}
        launches = dict(ops.LAUNCHES)
        uploads = ops.rank_table_uploads - uploads
        retries = ops.pair_capacity_retries - retries
    rank_shapes, descend_in, fused_in = (rec["rank_shapes"],
                                         rec["descend_in"], rec["fused_in"])
    refine_in, refine_calls = rec["refine_in"], rec["refine_calls"]
    pairs_in, any_in = rec["pairs_in"], rec["any_in"]
    require_launched("the main path", launches, STREAK_KERNELS)
    if launches["distance_join"] != len(pairs_in) + retries \
            or launches["bloom_probe"] != len(any_in):
        raise AssertionError(
            f"main path: {launches['distance_join']} distance_join launches "
            f"for {len(pairs_in)} pair calls and {retries} retries, "
            f"{launches['bloom_probe']} bloom_probe launches for "
            f"{len(any_in)} probes: the path runs the pair call and the "
            "per-filter probe only")
    routes = collections.Counter(f"{r['set']} {r['route']}" for r in pairs_in)
    print(f"pair calls on the main path: {len(pairs_in)} {dict(routes)}; "
          f"pairs tested {sum(r['tested'] for r in pairs_in)}, candidates "
          f"{sum(r['pairs'] for r in pairs_in)}; capacity retries "
          f"{retries}; per-filter Bloom probes: {len(any_in)}", flush=True)
    print("bloom bank uploads " + json.dumps(
        store_bank_uploads(main_sets, bank_uploads, dev)), flush=True)
    if launches["bucketed_min_core"] != refine_calls[0]:
        raise AssertionError(
            f"{launches['bucketed_min_core']} refinement launches for "
            f"{refine_calls[0]} refinement calls: not one a call")
    print(f"refinement calls on the main path: {refine_calls[0]}, one "
          f"launch each; fused launches: {len(fused_in)}, (M, N, k) "
          f"{[r['shape'] for r in fused_in]}", flush=True)
    n_m = np.array(rank_shapes, dtype=np.int64).reshape(-1, 3)
    resident = n_m[:, 2].astype(bool)
    print(f"rank calls on the main path: {len(n_m)}; table N median "
          f"{int(np.median(n_m[:, 0]))} max {int(n_m[:, 0].max())}; probes "
          f"M median {int(np.median(n_m[:, 1]))} max {int(n_m[:, 1].max())}"
          f"; {int(resident.sum())} against resident tables ({uploads} "
          f"uploads), {int((~resident).sum())} against tables built per "
          f"call ({int(n_m[~resident, 0].sum())} words)")
    descend_shapes = [(b.shape[0], b.shape[1], nk.shape[1], int(cs.sum()))
                      for nk, cs, b in descend_in]
    print(f"descend calls on the main path: {len(descend_shapes)}; (B, M, "
          f"N, live nodes) {sorted(collections.Counter(descend_shapes).items())}")
    queries = []
    for join, runs in cuda_runs.items():
        cpu_runs = run_queries(rt, checked[join], join, "cpu")
        check_answers(join, runs, cpu_runs)
        for key, (res, ms) in runs.items():
            scores, rows, stats = res
            if len(scores) > main_sets[key[0]][0].queries[key[1]].k:
                raise AssertionError(f"{join} {key}: more rows than k")
            queries.append(dict(join=join, dataset=key[0], q=key[1] + 1,
                                rows=len(scores), cuda_ms=ms,
                                cpu_ms=cpu_runs[key][1],
                                driver_blocks=stats.driver_blocks,
                                plan_log="".join(stats.plan_log),
                                overflow_rows=stats.join.overflow_rows))
            print(f"query {join} {key[0]} Q{key[1] + 1}: {len(scores)} rows "
                  f"= cpu; cuda {ms:.1f} ms, cpu {cpu_runs[key][1]:.1f} ms "
                  f"({kind})")
    if not any(qr["rows"] == main_sets[qr["dataset"]][0].queries[0].k
               for qr in queries):
        raise AssertionError("no query filled its top-k")
    phase_done("main path", t0)

    # ---- the redesigned kernels at the main path's own inputs -------------
    t0 = time.perf_counter()
    check_descend_path(ops, ref, descend_in, entries["tree_descend"], cases,
                       lgd.store.tree.n_nodes)
    check_path_replays("fused_topk_join", "fused_topk_join_kernel", fused_in,
                       entries["fused_topk_join"], cases)
    check_path_replays("bucketed_min_core", "bucketed_min_core_kernel",
                       refine_in, entries["bucketed_min_core"], cases)
    check_path_replays("distance_join", "distance_join_kernel", pairs_in,
                       entries["distance_join"], cases)
    check_path_replays("bloom_probe", "bloom_probe_any_kernel", any_in,
                       entries["bloom_probe"], cases)
    del descend_in, fused_in, refine_in, pairs_in, any_in
    phase_done("path shapes", t0)

    # ---- second entry point: the Geographica shapes -----------------------
    t0 = time.perf_counter()
    shape_qs = shape_queries(rt, lgd)
    ops.reset_launch_counts()
    # range and within never reach the Phase-3 join, so the join backend
    # cannot change their work: they run under one join only
    shape_sets = {"kernel": shape_qs,
                  "fused": {n: shape_qs[n] for n in ("join", "knn")}}
    shape_cuda = {join: run_shapes(rt, lgd, qs, join, "cuda")
                  for join, qs in shape_sets.items()}
    shape_launches = dict(ops.LAUNCHES)
    require_launched("the shapes path", shape_launches, STREAK_KERNELS)
    print("shape launches " + json.dumps(shape_launches))
    shapes = []
    for join, runs in shape_cuda.items():
        cpu_runs = run_shapes(rt, lgd, shape_sets[join], join, "cpu")
        check_answers(f"shape {join}", runs, cpu_runs)
        for name, (res, ms) in runs.items():
            n_rows = len(res[0])
            if name != "join" and n_rows == 0:
                raise AssertionError(f"shape {name}: no rows")
            shapes.append(dict(join=join, shape=name, rows=n_rows,
                               cuda_ms=ms, cpu_ms=cpu_runs[name][1],
                               driver_blocks=res[2].driver_blocks))
            print(f"shape {join} {name}: {n_rows} rows = cpu; cuda "
                  f"{ms:.1f} ms, cpu {cpu_runs[name][1]:.1f} ms ({kind})")
    phase_done("shapes", t0)

    # ---- third entry point: the multi-tenant serving loop -----------------
    t0 = time.perf_counter()
    serve = check_serve(rt, ops, ref, _build, spatial_join, lgd, cases)
    phase_done("spatial serve", t0)

    # ---- the main path over Morton-prefix sharded stores -----------------
    t0 = time.perf_counter()
    sharded = check_sharded(rt, ops, ref, datasets, cuda_runs, bank_uploads,
                            dev, entries["tree_descend"], cases)
    phase_done("sharded", t0)

    # ---- the multi-device layer: mesh, sharded retrieval and descent ----
    t0 = time.perf_counter()
    mesh_run = dict(retrieval=mesh_retrieval(dev),
                    descent=mesh_descent(rt, ops, ref, lgd, cuda_runs, dev,
                                         entries["tree_descend"]),
                    reshard=mesh_reshard(dev))
    for row in mesh_run["retrieval"]:
        blocked = ("" if "blocked_sharded_ms" not in row else
                   f"; blocked {np.median(row['blocked_sharded_ms']):.3f} "
                   f"ms (unsharded "
                   f"{np.median(row['blocked_unsharded_ms']):.3f})")
        print(f"mesh {row['case']} over {row['mesh']}, {row['layout']}, on "
              f"{smi}: ids and scores = unsharded; streak read "
              f"{row['blocks_read_by_shard']} of {row['blocks_per_shard']} "
              f"blocks a shard (unsharded {row['blocks_read_unsharded']} of "
              f"16), {np.median(row['streak_sharded_ms']):.3f} ms "
              f"(unsharded {np.median(row['streak_unsharded_ms']):.3f})"
              + blocked, flush=True)
    for label, row in mesh_run["descent"].items():
        print(f"mesh descent over {label} on {smi}: "
              f"{row['launches_per_position_per_descent']:.0f} launch a "
              f"position a descent ({row['launches']} for "
              f"{row['descents']} descents over {row['positions']} "
              "positions), masks = plain"
              + (" = one launch" if row["positions"] > 1 else "")
              + ", answers = unsharded; "
              f"{row['event_ms']:.5f} ms (events; one launch "
              f"{row['one_launch_event_ms']:.5f}, bound "
              f"{row['bound_ms']:.5f} {row['bound_by']})", flush=True)
    phase_done("mesh", t0)

    # ---- the failover layer around every chained op -----------------------
    t0 = time.perf_counter()
    clean = {("fused", 1): cuda_runs["fused"]["lgd", 0][0],
             ("kernel", 1): cuda_runs["kernel"]["lgd", 0][0],
             ("fused", 4): sharded.pop("clean_q1")}
    failover = check_failover(rt, ops, fault, lgd, clean, dev)
    phase_done("failover", t0)
    require_clean_fault_layer(fault, ops, "after the failover phase")

    # ---- the paper's baseline engines, ingested data, the fuzzer ----------
    t0 = time.perf_counter()
    baselines = check_baselines(rt, ops, ref, _build, spatial_join,
                                baseline_sets, cases,
                                entries["bucketed_min_core"])
    phase_done("baselines", t0)
    t0 = time.perf_counter()
    ingested = check_ingest(rt, ops, ref, _build, spatial_join, cases)
    phase_done("ingest", t0)
    t0 = time.perf_counter()
    fuzz = check_fuzz(rt, ops, ref, _build, spatial_join, fault, {
        seed: synth_rdf.make_lgd(n_per_class=60, seed=seed, block=64)
        for seed in (0, 1)}, cases)
    phase_done("fuzz", t0)
    t0 = time.perf_counter()
    analytics_run = check_analytics(ops, ref, _build, spatial_join, cases)
    phase_done("analytics", t0)

    # ---- the reference's kernel entry points (ops.block_scan, morton) ----
    t0 = time.perf_counter()
    scores = torch.from_numpy(np.random.default_rng(9).normal(
        0.5, 0.5, (64, 1024)).astype(np.float32)).to(dev)
    cx, cy = morton_inputs(dev)
    ops.reset_launch_counts()
    bmax, cnt, mask = ops.block_scan(scores, 0.5)
    codes = ops.morton_encode(cx, cy)
    torch.cuda.synchronize()
    ops_launches = dict(ops.LAUNCHES)
    require_launched("the ops entry points", ops_launches, OPS_KERNELS)
    if not (torch.equal(cnt, mask.sum(1, dtype=torch.int32))
            and torch.equal(bmax, scores.max(1).values)
            and codes.shape == cx.shape):
        raise AssertionError("ops entry points: malformed outputs")
    print("ops launches " + json.dumps(ops_launches))
    phase_done("ops entry points", t0)

    # ---- the LM serving stack: gemma-7b at full width and depth ----------
    from repro_torch.configs import registry
    from repro_torch.models import transformer as tr
    t0 = time.perf_counter()
    cfg = dataclasses.replace(registry.get("gemma-7b").config,
                              use_flash=True)
    params = tr.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    leaves = pytree.leaves(params)
    print(f"gemma-7b: {sum(x.numel() for x in leaves)} parameters, "
          f"{sum(x.numel() * x.element_size() for x in leaves)} bytes on "
          f"{kind}, made in {time.perf_counter() - t0:.1f} s", flush=True)
    del leaves
    prefill = check_lm_prefill(ops, ref, tr, cfg, params, dev)
    phase_done("lm prefill", t0)
    t0 = time.perf_counter()
    lm_serve = check_lm_serve(tr, cfg, params, dev)
    del params
    torch.cuda.empty_cache()
    phase_done("lm serve", t0)
    t0 = time.perf_counter()
    smoke_lms = check_lm_cuda_vs_cpu(ops, dev)
    phase_done("lm cuda vs cpu", t0)

    # ---- the MoE family at full width: prefill, serve, smokes ------------
    from repro_torch.models import moe
    t0 = time.perf_counter()
    moe_prefills = []
    for arch in ("qwen2-moe-a2.7b", "qwen3-moe-30b-a3b"):
        full = dataclasses.replace(registry.get(arch).config, use_flash=True)
        depth = moe_depth_that_fits(moe, full)
        if depth < full.n_layers:
            print(f"{arch}: depth cut to {depth} of {full.n_layers} layers "
                  "to fit the card's free memory", flush=True)
        cfg = dataclasses.replace(full, n_layers=depth)
        params = init_moe(moe, cfg, full.n_layers, dev, kind)
        moe_prefills.append(check_moe_prefill(ops, ref, moe, cfg, params,
                                              dev))
        del params
        torch.cuda.empty_cache()
    phase_done("moe prefill", t0)
    t0 = time.perf_counter()
    cfg = registry.get("qwen2-moe-a2.7b").config
    params = init_moe(moe, cfg, cfg.n_layers, dev, kind)
    moe_serve = check_moe_serve(moe, cfg, params, dev)
    del params
    torch.cuda.empty_cache()
    phase_done("moe serve", t0)
    t0 = time.perf_counter()
    moe_smokes = check_lm_cuda_vs_cpu(ops, dev, "moe")
    phase_done("moe cuda vs cpu", t0)

    # ---- LM training: card against CPU, full width, resume ---------------
    import tempfile
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        training = dict(cuda_vs_cpu=check_train_cuda_vs_cpu(dev, tmp),
                        full_width=check_train_full_width(dev, tmp),
                        resume=check_train_resume(dev, tmp))
    phase_done("train", t0)

    # ---- recsys: STREAK retrieval and SASRec training at full width -------
    t0 = time.perf_counter()
    retrieval_run = check_retrieval(dev)
    phase_done("retrieval", t0)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        recsys_train = check_recsys_train(dev, pathlib.Path(tmp))
    phase_done("recsys train", t0)

    # ---- the GNN family: GCN, GraphSAGE, GraphCast, NequIP ----------------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        gnn_run = check_gnn(dev, pathlib.Path(tmp))
    phase_done("gnn", t0)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        graphcast_run = check_graphcast(dev, pathlib.Path(tmp))
    phase_done("graphcast", t0)
    t0 = time.perf_counter()
    nequip_run = check_nequip(dev)
    phase_done("nequip", t0)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ogb_run = check_ogb_gcn(dev, pathlib.Path(tmp))
    phase_done("ogb gcn", t0)

    # ---- the counted roofline, beside this run's measurements -------------
    t0 = time.perf_counter()
    roofline = roofline_records(dict(
        moe_layers=moe_prefills[0]["layers"],
        graphcast_graph=graphcast_run,
        flash={"lm prefill": np.median(prefill["flash_ms"]),
               "moe prefill": np.median(moe_prefills[0]["flash_ms"])},
        **{"lm prefill": np.median(prefill["plain_ms"]),
           "moe prefill": np.median(moe_prefills[0]["plain_ms"]),
           "train full width": np.median(
               training["full_width"][0]["step_ms"]),
           "graphcast": np.median(graphcast_run["forward_ms"]),
           "ogb gcn forward": np.median(ogb_run["forward_ms"]),
           "ogb gcn step": np.median(ogb_run["step_ms"])}),
        ROOT / "artifacts" / "roofline_torch")
    for row in roofline:
        print(f"roofline {row['workload']} on {smi}: " + json.dumps(row),
              flush=True)
    phase_done("roofline", t0)

    # ---- the 40 cells: one-device records, the ones that fit run ---------
    t0 = time.perf_counter()
    cells_run = check_cells(dev, smi)
    phase_done("cells", t0)

    # ---- where the time goes ---------------------------------------------
    t0 = time.perf_counter()
    traces = [trace_queries(rt, name, ds, n_q, join)
              for join in ("fused", "kernel")
              for name, (ds, n_q) in datasets.items()]
    traces.append(trace_queries(rt, "lgd", lgd, datasets["lgd"][1], "fused",
                                HOST_PROBE_RANK))
    for t in traces:
        print("trace " + json.dumps(t))
    # the rank pass alone on numpy and on its kernel, in turns, traced:
    # wall ms, memcpy device ms and host ms by layer of each pass
    rank_turns = [trace_queries(rt, name, ds, n_q, "fused",
                                dict(SLICE_POLICY, rank=rank))
                  for name, (ds, n_q) in datasets.items()
                  for rank in ("numpy", "kernel", "kernel", "numpy")]
    for t in rank_turns:
        print("rank turn " + json.dumps(t))
    phase_done("traces", t0)

    bank_uploads_run = store_bank_uploads(main_sets, bank_uploads, dev)
    print("bloom bank uploads over the run " + json.dumps(bank_uploads_run))
    print("memcpy device ms " + json.dumps(
        {f"{t['dataset']} {t['join']} probe={t['probe']}":
         t["device_ms_by_kind"].get("memcpy", 0.0) for t in traces}))
    path_launches = {**{n: launches[n] for n in STREAK_KERNELS},
                     **{n: ops_launches[n] for n in OPS_KERNELS},
                     "flash_attention": prefill["flash_launches_per_call"]}
    moe_flash = sum(r["flash_launches_per_call"] for r in moe_prefills)
    kernels = [dict(entries[n], launches=path_launches[n], match=True,
                    moe_prefill_launches=moe_flash
                    if n == "flash_attention" else 0,
                    serve_launches=serve["launches"].get(n, 0),
                    sharded_launches=sharded["launches"].get(n, 0),
                    baselines_launches=baselines["launches"].get(n, 0),
                    ingest_launches=ingested["launches"].get(n, 0),
                    fuzz_launches=fuzz["launches"].get(n, 0),
                    analytics_launches=analytics_run["launches"].get(n, 0))
               for n in _build.KERNELS]
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(dict(
            card=smi, kind=kind, torch=torch.__version__, kernels=kernels,
            cases=cases, queries=queries, shapes=shapes,
            shape_launches=shape_launches, untraced_turns=ab,
            rank_call_shapes=n_m.tolist(), path_call_ms=call_ms,
            bloom_bank_uploads=bank_uploads_run,
            descend_call_shapes=descend_shapes, traces=traces,
            rank_turns=rank_turns,
            ops_launches=ops_launches, spatial_serve=serve,
            sharded=sharded, failover=failover, baseline_turns=base_turns,
            baselines=baselines, ingest=ingested, fuzz=fuzz,
            analytics=analytics_run,
            serve_turns=serve_times, lm_prefill=prefill, lm_serve=lm_serve,
            lm_smoke_cuda_vs_cpu=smoke_lms, moe_prefill=moe_prefills,
            moe_serve=moe_serve, moe_smoke_cuda_vs_cpu=moe_smokes,
            training=training, retrieval=retrieval_run,
            recsys_train=recsys_train, gnn=gnn_run, graphcast=graphcast_run,
            nequip=nequip_run, mesh=mesh_run, ogb_gcn=ogb_run,
            roofline=roofline, cells=cells_run, phase_seconds=phase_s),
            indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
