#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA GPU.

    python3 chip_smoke.py [--out report.json]

Needs one CUDA device, the CUDA toolkit (nvcc) and this checkout's `src/`.
In order it:

1. prints the card's name and power limit (nvidia-smi);
2. builds the four CUDA kernels of `src/repro_torch/csrc/` and prints the
   build time and each kernel's ptxas register and shared-memory use;
3. holds each kernel against its plain torch version on the card, at the
   shapes the main path gives it, and requires bit-identical output; times
   both per call with CUDA events (`ms`, `plain_ms`: the wrapper's host
   overhead included), the kernel alone from a torch.profiler trace
   (`device_ms`), and computes the kernel's bound (bytes over the memory
   rate or operations over the f32 rate, the larger);
4. drives the main path — `StreakEngine.execute` on `device="cuda"`, top-k
   spatial distance joins over `make_lgd(n_per_class=6000)` (Q1-Q8) and
   `make_scale(1_000_000)` (Q1-Q2), first with the fused Phase-3 join, then
   with the matrix join — with the launch counts set to 0 just before and
   read just after, requires every kernel to have launched, and requires
   every answer, plan log and statistic to equal a `device="cpu"` run;
5. traces one more pass of each query set on the card: host ms per
   executor layer, device busy ms and the device's idle share;
6. prints the kernels line (JSON), then the ok line (JSON) last.

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
# H100 SXM peaks (NVIDIA data sheet): HBM rate and f32 outside tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
SLICE_POLICY = dict(probe="numpy", rank="numpy", impl="merge", kcap="fixed",
                    descend="kernel")
REPLACES = {
    "fused_topk_join": "src/repro/kernels/fused_topk_join.py:110",
    "distance_join": "src/repro/kernels/distance_join.py:36",
    "bucketed_min_core": "src/repro/kernels/geom_refine.py:72",
    "tree_descend": "src/repro/kernels/tree_descend.py:75",
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


def trace_queries(rt, name, ds, n_q, join) -> dict:
    """One traced pass of a query set on the card: host ms per executor
    layer, device busy ms (the union of the kernel and copy intervals of a
    torch.profiler trace) and the device's idle share of the wall time."""
    from torch.profiler import ProfilerActivity, profile
    cfg = rt.ExecConfig(policy=rt.BackendPolicy(join=join, **SLICE_POLICY))
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
    return dict(dataset=name, join=join, queries=n_q, wall_ms=wall_ms,
                device_busy_ms=busy_us / 1e3 if spans else None,
                device_idle_share=1 - busy_us / 1e3 / wall_ms
                if spans else None,
                device_ms_by_kind=dict(by_kind), host_ms_by_layer=host)


def same_answer(got, want) -> bool:
    (gs, gr, gst), (ws, wr, wst) = got, want
    return (np.array_equal(gs, ws) and list(gr) == list(wr)
            and all(np.array_equal(gr[c], wr[c]) for c in wr)
            and dataclasses.asdict(gst) == dataclasses.asdict(wst))


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

    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{len(_build.KERNELS)} kernels", flush=True)
    for name, log in _build.build_logs.items():
        used = [ln.strip() for ln in log.splitlines() if "Used" in ln]
        print(f"  {name}: {'; '.join(used)}")

    t0 = time.perf_counter()
    datasets = {
        "lgd": (synth_rdf.make_lgd(n_per_class=6000, seed=0, block=1024), 8),
        "scale1m": (synth_rdf.make_scale(1_000_000, seed=0), 2),
    }
    for name, (ds, _) in datasets.items():
        print(f"data {name}: {ds.store.n_quads} quads, "
              f"{ds.store.tree.n_objects} spatial, "
              f"{ds.store.tree.n_nodes} nodes")
    print(f"data build: {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- per-kernel phase: kernel vs plain version, bit for bit ----------
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
    for e in entries.values():
        print(f"kernel {e['name']} [{e['shape']}] on {kind}: bit-identical; "
              f"{e['ms']:.4f} ms a call, {e['device_ms']} ms on the device, "
              f"plain {e['plain_ms']:.4f} ms, bound {e['bound_ms']:.5f} ms "
              f"({e['bound_by']})")
    for c in cases:
        print("case " + json.dumps(c))
    sys.stdout.flush()

    # ---- end-to-end phase: the main path on the card ---------------------
    ops.reset_launch_counts()
    cuda_runs = {join: run_queries(rt, datasets, join, "cuda")
                 for join in ("fused", "kernel")}
    launches = dict(ops.LAUNCHES)
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"{name} never launched on the main path")
    queries = []
    for join, runs in cuda_runs.items():
        cpu_runs = run_queries(rt, datasets, join, "cpu")
        for key, (res, ms) in runs.items():
            scores, rows, stats = res
            q = datasets[key[0]][0].queries[key[1]]
            if not (len(scores) <= q.k and np.isfinite(scores).all()
                    and all(len(v) == len(scores) for v in rows.values())):
                raise AssertionError(f"{join} {key}: malformed answer")
            if not same_answer(res, cpu_runs[key][0]):
                raise AssertionError(f"{join} {key}: CUDA answer differs "
                                     "from the CPU run")
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

    # ---- where the time goes: one traced pass per query set --------------
    traces = [trace_queries(rt, name, ds, n_q, join)
              for join in ("fused", "kernel")
              for name, (ds, n_q) in datasets.items()]
    for t in traces:
        print("trace " + json.dumps(t))

    kernels = [dict(entries[n], launches=launches[n], match=True)
               for n in _build.KERNELS]
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(dict(
            card=smi, kind=kind, torch=torch.__version__, kernels=kernels,
            cases=cases, queries=queries, traces=traces), indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
