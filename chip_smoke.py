#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA GPU.

    python3 chip_smoke.py [--out report.json]

Needs one CUDA device, the CUDA toolkit (nvcc) and this checkout's `src/`.
In order it:

1. prints the card's name and power limit (nvidia-smi);
2. builds the six CUDA kernels of `src/repro_torch/csrc/` and prints the
   build time and each kernel's ptxas register and shared-memory use;
3. holds each kernel against its plain torch version on the card, at the
   shapes the main path gives it, and requires bit-identical output; times
   both per call with CUDA events (`ms`, `plain_ms`: the wrapper's host
   overhead included), the kernel alone from a torch.profiler trace
   (`device_ms`), one PyTorch call computing the same function where
   there is one (`library_ms`), and computes the kernel's bound (bytes
   over the memory rate or operations over the scalar rate, the larger);
4. drives the main path — `StreakEngine.execute` on `device="cuda"`, top-k
   spatial distance joins over `make_lgd(n_per_class=6000)` (Q1-Q8) and
   `make_scale(1_000_000)` (Q1-Q2) with the fused Phase-3 join, then both
   with the matrix join, under the accelerator policy (every stage on its
   kernel) — with the launch counts set to 0 just before and read just
   after, requires every kernel to have launched, and requires every
   answer, plan log and statistic to equal a `device="cpu"` run;
5. drives the second entry point the same way: the Geographica shapes
   over the LGD data, spatial join and kNN under both joins, range and
   within (which never reach the Phase-3 join) under one, each equal to its
   `device="cpu"` run, every kernel launched;
6. times LGD Q1-Q8 with the Bloom probes and the rank pass on numpy and on
   their kernels, in turns, and traces one more pass of each query set on
   the card: host ms per executor layer, device busy ms and the device's
   idle share;
7. prints the kernels line (JSON), then the ok line (JSON) last.

Any failed phase raises, so the script exits non-zero without the ok line.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
# H100 SXM peaks (NVIDIA data sheet): HBM rate and the scalar rate outside
# the tensor cores (f32; the integer kernels are held to the same rate)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
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
}


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
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


def device_ms(fn, symbol: str, reps: int = 20) -> float | None:
    """Mean device time of the kernels named `symbol` per call of `fn`, from
    a torch.profiler trace; None when the trace holds no such kernel."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(getattr(e, "device_time_total", 0.0)
                   for e in prof.key_averages() if symbol in e.key)
    return total_us / reps / 1e3 if total_us else None


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


def check_distance_join(ops, ref, dev, entry):
    rng = np.random.default_rng(1)
    m, n = 1024, 4096
    a = torch.from_numpy(_boxes(rng, m)).to(dev)
    b = torch.from_numpy(_boxes(rng, n)).to(dev)
    err = require_equal("distance_join", [ops.distance_join(a, b)],
                        [ref.distance_join_ref(a, b)])
    entry.update(
        shape=f"M={m} N={n}", max_abs_err=err,
        ms=time_ms(lambda: ops.distance_join(a, b), 50),
        device_ms=device_ms(lambda: ops.distance_join(a, b),
                            "distance_join_kernel"),
        plain_ms=time_ms(lambda: ref.distance_join_ref(a, b), 10))
    entry["bound_ms"], entry["bound_by"] = bound_ms(
        (m + n) * 16 + m * n * 4, m * n * 12)


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
    entry.update(
        shape=f"M={m} N={n} k=100 theta=-inf", max_abs_err=0.0,
        ms=time_ms(lambda: ops.fused_topk_join(*args, k=100), 20),
        device_ms=device_ms(lambda: ops.fused_topk_join(*args, k=100),
                            "fused_topk_join_kernel"),
        plain_ms=time_ms(lambda: ref.fused_topk_join_ref(
            *args, zq_r, zq_c, 100), 5))
    # per pair: 12 ops of distance, 1 add, 3 compares; inputs once, the
    # (M, k) partials and counts written once
    entry["bound_ms"], entry["bound_by"] = bound_ms(
        m * 32 + n * 24 + m * 100 * 8 + m * 4, m * n * 16)


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
                require_equal(f"bucketed_min_core {dims}d {m_pad}x{n_pad}",
                              [ops.bucketed_min_core(a, b)],
                              [ref.bucketed_min_core_ref(a, b)])
                ms = time_ms(lambda: ops.bucketed_min_core(a, b), 20)
                dms = device_ms(lambda: ops.bucketed_min_core(a, b),
                                "bucketed_min_core_kernel")
                plain = time_ms(lambda: ref.bucketed_min_core_ref(a, b), 3)
                bnd, by = bound_ms(dims * nb * (m_pad + n_pad) * 4 + nb * 4,
                                   nb * m_pad * n_pad * 3 * dims)
                cases.append(dict(kernel="bucketed_min_core", dims=dims,
                                  B=nb, m_pad=m_pad, n_pad=n_pad, ms=ms,
                                  device_ms=dms, plain_ms=plain,
                                  bound_ms=bnd, bound_by=by))
                if (dims, m_pad, n_pad) == (2, 8, 8):
                    entry.update(shape=f"dims=2 B={nb} m_pad=8 n_pad=8",
                                 max_abs_err=0.0, ms=ms, device_ms=dms,
                                 plain_ms=plain, bound_ms=bnd, bound_by=by)


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
        # box tests this data needs: up to each live (b, n)'s first hit
        tests = 0
        for bi in range(nb):
            bx = box_keys[bi]
            hit = ((node_keys[0][None] <= bx[:, 2:3])
                   & (bx[:, 0:1] <= node_keys[2][None])
                   & (node_keys[1][None] <= bx[:, 3:4])
                   & (bx[:, 1:2] <= node_keys[3][None]))
            first = torch.where(hit.any(0), hit.int().argmax(0) + 1, m)
            tests += int(first[cs].sum())
        ms = time_ms(lambda: ops.tree_descend(node_keys, cs,
                                                     box_keys), 50)
        dms = device_ms(lambda: ops.tree_descend(node_keys, cs, box_keys),
                        "tree_descend_kernel")
        plain = time_ms(lambda: ref.tree_descend_ref(
            node_keys, cs, box_keys), 10)
        bnd, by = bound_ms(4 * n * 8 + n + nb * m * 32 + nb * n, tests * 4)
        cases.append(dict(kernel="tree_descend", tree=name, B=nb, M=m, N=n,
                          ms=ms, device_ms=dms, plain_ms=plain, bound_ms=bnd,
                          bound_by=by))
        if name == "lgd":
            entry.update(shape=f"B={nb} M={m} N={n}", max_abs_err=0.0,
                         ms=ms, device_ms=dms, plain_ms=plain, bound_ms=bnd,
                         bound_by=by)


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
        device_ms=device_ms(lambda: ops.bloom_probe(rows, keys, bank.k),
                            "bloom_probe_kernel"),
        plain_ms=time_ms(lambda: ref.bloom_probe_ref(rows, keys, bank.k),
                         10),
        library_note="no PyTorch call computes a double-hashed Bloom test")
    entry["bound_ms"], entry["bound_by"] = bound_ms(
        b * (8 + 1) + n_words * 4, b * 40 + n_words * 7)


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


def check_merge_join_ranks(ops, ref, dev, entry, cases):
    """A sorted table of ~1M int64 keys with runs of duplicates; probes of
    M = 4096 and M ~ N below, inside (exact hits included) and above the
    table; every side."""
    rng = np.random.default_rng(6)
    n = 1_000_003
    base = np.sort(rng.integers(-(1 << 40), 1 << 40, n))
    table_np = np.repeat(base, rng.integers(1, 5, n))[:n]
    table = torch.from_numpy(table_np).to(dev)
    lo_v, hi_v = int(table_np[0]), int(table_np[-1])
    for m in (4096, n):
        probes_np = np.concatenate([
            rng.integers(lo_v - (1 << 41), lo_v, m // 8),          # below
            rng.integers(hi_v + 1, hi_v + (1 << 41), m // 8),      # above
            rng.choice(table_np, m // 4),                          # hits
            rng.integers(lo_v, hi_v, m - m // 8 * 2 - m // 4)])    # inside
        probes = torch.from_numpy(rng.permutation(probes_np)).to(dev)
        for side in ("both", "left", "right"):
            got = ops.insertion_ranks(table, probes, side)
            want = ref.merge_join_ranks_ref(table, probes, side)
            require_equal(f"merge_join_ranks M={m} side={side}",
                          got if side == "both" else [got],
                          want if side == "both" else [want])
        words, sectors = rank_words_touched(table, probes)
        ms = time_ms(lambda: ops.insertion_ranks(table, probes), 20)
        dms = device_ms(lambda: ops.insertion_ranks(table, probes),
                        "merge_join_ranks_kernel")
        plain = time_ms(lambda: ref.merge_join_ranks_ref(table, probes), 5)
        lib = time_ms(lambda: (torch.searchsorted(table, probes, side="left"),
                               torch.searchsorted(table, probes,
                                                  side="right")), 20)
        # probes read and both ranks written once, each distinct table word
        # that this run's searches reach read once; ~4 integer operations
        # per search step, two searches per probe
        bnd, by = bound_ms(m * 8 * 3 + words * 8,
                           2 * m * int(n).bit_length() * 4)
        cases.append(dict(kernel="merge_join_ranks", N=n, M=m, side="both",
                          table_words=words, table_sectors=sectors,
                          ms=ms, device_ms=dms, plain_ms=plain,
                          library_ms=lib, bound_ms=bnd, bound_by=by))
        if m == 4096:
            entry.update(shape=f"N={n} M={m} side=both", max_abs_err=0.0,
                         ms=ms, device_ms=dms, plain_ms=plain,
                         library_ms=lib, bound_ms=bnd, bound_by=by)


# ------------------------------------------------------- end-to-end phase --
def run_queries(rt, datasets, join, device):
    """{(dataset, qi): ((scores, rows, stats), wall ms)} for one backend."""
    out = {}
    for name, (ds, n_q) in datasets.items():
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


def compare_probe_rank(rt, ds, n_q) -> list:
    """LGD Q1-Q8 (fused join) with the Bloom probes and the rank pass on
    the host and on their kernels, in turns (host, kernel, kernel, host):
    one fresh engine per pass, wall ms per pass on the card."""
    passes = []
    for label, pol in (("numpy", HOST_PROBE_RANK), ("kernel", SLICE_POLICY),
                       ("kernel", SLICE_POLICY), ("numpy", HOST_PROBE_RANK)):
        cfg = rt.ExecConfig(policy=rt.BackendPolicy(join="fused", **pol))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng = rt.StreakEngine(ds.store, cfg, device="cuda")
        for qi in range(n_q):
            eng.execute(ds.queries[qi])
        torch.cuda.synchronize()
        passes.append(dict(probe_rank=label,
                           wall_ms=(time.perf_counter() - t0) * 1e3))
    return passes


@contextlib.contextmanager
def timed_layers():
    """Wall-clock timers on the executor's layer entry points, for the
    duration of the block; yields {layer: seconds}. Phase 3 is reported
    without the refinement it calls."""
    from repro_torch.core import aps, executor, shard
    totals = collections.defaultdict(float)
    targets = [(executor, "plan_query", "plan"),
               (executor.QueryCursor, "_materialize", "driver blocks"),
               (shard, "sip_select", "phase 1-2 (SIP)"),
               (aps, "choose", "APS"),
               (executor.StreakEngine, "_driven_nplan", "driven retrieval"),
               (executor.StreakEngine, "_driven_splan", "driven retrieval"),
               (executor.QueryCursor, "_phase3", "phase 3"),
               (executor.StreakEngine, "_emit_pairs", "refine + top-k")]

    def timed(fn, layer):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            totals[layer] += time.perf_counter() - t0
            return out
        return wrapper

    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in targets]
    for owner, attr, layer in targets:
        setattr(owner, attr, timed(getattr(owner, attr), layer))
    yield totals
    for owner, attr, fn in saved:
        setattr(owner, attr, fn)
    totals["phase 3"] -= totals["refine + top-k"]


def trace_queries(rt, name, ds, n_q, join, policy=SLICE_POLICY) -> dict:
    """One traced pass of a query set on the card: host ms per executor
    layer, device busy ms (the union of the kernel and copy intervals of a
    torch.profiler trace) and the device's idle share of the wall time."""
    from torch.profiler import ProfilerActivity, profile
    cfg = rt.ExecConfig(policy=rt.BackendPolicy(join=join, **policy))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof, \
            timed_layers() as layers:
        t0 = time.perf_counter()
        eng = rt.StreakEngine(ds.store, cfg, device="cuda")
        for qi in range(n_q):
            eng.execute(ds.queries[qi])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    by_kind: dict = collections.defaultdict(float)
    for start, stop, ev_name in spans:
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
        kind = next((k for k in REPLACES if f"{k}_kernel" in ev_name),
                    "memcpy" if "memcpy" in ev_name.lower() else "other")
        by_kind[kind] += (stop - start) / 1e3
    host = {k: v * 1e3 for k, v in layers.items()}
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


def require_launched(path: str, launches: dict) -> None:
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"{name} never launched on {path}")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="write the full report (JSON) here")
    args = parser.parse_args()
    if not (ROOT / "src" / "repro_torch").is_dir():
        sys.exit("chip_smoke: src/repro_torch not found beside this script")
    sys.path.insert(0, str(ROOT / "src"))
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    import repro_torch as rt
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

    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{len(_build.KERNELS)} kernels", flush=True)
    for name, log in _build.build_logs.items():
        used = [ln.strip() for ln in log.splitlines() if "Used" in ln]
        print(f"  {name}: {'; '.join(used)}")
    phase_done("build", t0)

    t0 = time.perf_counter()
    datasets = {
        "lgd": (synth_rdf.make_lgd(n_per_class=6000, seed=0, block=1024), 8),
        "scale1m": (synth_rdf.make_scale(1_000_000, seed=0), 2),
    }
    lgd = datasets["lgd"][0]
    for name, (ds, _) in datasets.items():
        print(f"data {name}: {ds.store.n_quads} quads, "
              f"{ds.store.tree.n_objects} spatial, "
              f"{ds.store.tree.n_nodes} nodes")
    phase_done("data build", t0)

    # ---- per-kernel phase: kernel vs plain version, bit for bit ----------
    t0 = time.perf_counter()
    entries = {name: dict(name=name, route="cuda",
                          source=f"src/repro_torch/csrc/{name}.cu",
                          replaces=REPLACES[name], library_ms=None)
               for name in _build.KERNELS}
    cases: list = []
    check_distance_join(ops, ref, dev, entries["distance_join"])
    check_fused(ops, ref, dev, entries["fused_topk_join"])
    check_bucketed(ops, ref, dev, entries["bucketed_min_core"], cases)
    check_tree_descend(ops, ref, dev, entries["tree_descend"],
                       {n: ds.store.tree for n, (ds, _) in datasets.items()},
                       cases)
    check_bloom_probe(rt, ops, ref, dev, entries["bloom_probe"], lgd, cases)
    check_merge_join_ranks(ops, ref, dev, entries["merge_join_ranks"], cases)
    for e in entries.values():
        lib = ("" if e["library_ms"] is None
               else f", library {e['library_ms']:.4f} ms")
        print(f"kernel {e['name']} [{e['shape']}] on {kind}: bit-identical; "
              f"{e['ms']:.4f} ms a call, {e['device_ms']} ms on the device, "
              f"plain {e['plain_ms']:.4f} ms{lib}, bound "
              f"{e['bound_ms']:.5f} ms ({e['bound_by']})")
    for c in cases:
        print("case " + json.dumps(c))
    sys.stdout.flush()
    phase_done("kernels", t0)

    # ---- end-to-end phase: the main path on the card ---------------------
    t0 = time.perf_counter()
    rank_shapes: list = []      # (N, M) of every rank call of the main path
    insertion_ranks = ops.insertion_ranks

    def recording_ranks(table, probes, side="both"):
        rank_shapes.append((table.shape[0], probes.shape[0]))
        return insertion_ranks(table, probes, side)

    checked = {"fused": datasets, "kernel": datasets}
    ops.insertion_ranks = recording_ranks
    ops.reset_launch_counts()
    cuda_runs = {join: run_queries(rt, sets, join, "cuda")
                 for join, sets in checked.items()}
    launches = dict(ops.LAUNCHES)
    ops.insertion_ranks = insertion_ranks
    require_launched("the main path", launches)
    n_m = np.array(rank_shapes, dtype=np.int64).reshape(-1, 2)
    print(f"rank calls on the main path: {len(n_m)}; table N median "
          f"{int(np.median(n_m[:, 0]))} max {int(n_m[:, 0].max())}; probes "
          f"M median {int(np.median(n_m[:, 1]))} max {int(n_m[:, 1].max())}")
    queries = []
    for join, runs in cuda_runs.items():
        cpu_runs = run_queries(rt, checked[join], join, "cpu")
        check_answers(join, runs, cpu_runs)
        for key, (res, ms) in runs.items():
            scores, rows, stats = res
            if len(scores) > datasets[key[0]][0].queries[key[1]].k:
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
    if not any(qr["rows"] == datasets[qr["dataset"]][0].queries[0].k
               for qr in queries):
        raise AssertionError("no query filled its top-k")
    phase_done("main path", t0)

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
    require_launched("the shapes path", shape_launches)
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

    # ---- where the time goes ---------------------------------------------
    t0 = time.perf_counter()
    ab = compare_probe_rank(rt, lgd, datasets["lgd"][1])
    for a in ab:
        print("probe/rank " + json.dumps(a))
    traces = [trace_queries(rt, name, ds, n_q, join)
              for join in ("fused", "kernel")
              for name, (ds, n_q) in datasets.items()]
    traces.append(trace_queries(rt, "lgd", lgd, datasets["lgd"][1], "fused",
                                HOST_PROBE_RANK))
    for t in traces:
        print("trace " + json.dumps(t))
    phase_done("traces", t0)

    kernels = [dict(entries[n], launches=launches[n], match=True)
               for n in _build.KERNELS]
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(dict(
            card=smi, kind=kind, torch=torch.__version__, kernels=kernels,
            cases=cases, queries=queries, shapes=shapes,
            shape_launches=shape_launches, probe_rank_passes=ab,
            rank_call_shapes=n_m.tolist(), traces=traces,
            phase_seconds=phase_s), indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
