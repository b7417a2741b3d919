"""Port vs reference: the multi-tenant STREAK serving loop.

The twin of `tests/test_serve_spatial.py` for the port: the same queries
and configs over the same `make_lgd` data go through the reference's
`SpatialServeEngine` and the port's on ``device="cpu"`` (kernel backends
there run their plain torch versions), and every request's scores, rows,
`ExecStats` and the loop's `ServeStats` must be equal. Each reference test
keeps its own property too (serve equal to serial, slots reused, work
shared), checked on the port. The cross-query primitives (pooled
`candidate_nodes`, stacked `select_batch`, `fused_stream_join_multi`, the
kcap tuner, the per-row (dist, θ, qid) kernel form) are held against the
reference's on the same inputs.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.core import node_select as ref_ns
from repro.core import spatial_join as ref_sj
from repro.core.planner import plan_query as ref_plan
from repro.data import synth_rdf as ref_synth
from repro.serve import spatial as ref_serve
from repro_torch.core import node_select as port_ns
from repro_torch.core import spatial_join as port_sj
from repro_torch.core.planner import plan_query as port_plan
from repro_torch.data import synth_rdf as port_synth
from repro_torch.kernels import ops
from repro_torch.serve import spatial as port_serve


@pytest.fixture(scope="module")
def lgd():
    """(reference dataset, port dataset), built alike."""
    build = dict(n_per_class=150, seed=0, block=128)
    return ref_synth.make_lgd(**build), port_synth.make_lgd(**build)


KS = (5, 20, 60, 120)


def mixed(d):
    """8 tenants with mixed k (and thus mixed θ-termination profiles)."""
    return [dataclasses.replace(q, k=KS[i % len(KS)])
            for i, q in enumerate(d.queries)]


# the reference test's configs, plus the matrix join with the descent and
# the Bloom probes on their kernels (plain versions here)
CONFIGS = {
    "numpy": dict(policy={}),
    "fused": dict(policy=dict(join="fused"), fused_batch_cols=256),
    "fused-kcap": dict(policy=dict(join="fused", kcap="auto"),
                       fused_batch_cols=256),
    "kernel": dict(policy=dict(join="kernel", descend="kernel",
                               probe="kernel")),
}


def config(pkg, name):
    kw = dict(CONFIGS[name])
    kw["policy"] = pkg.BackendPolicy(**kw["policy"])
    return pkg.ExecConfig(**kw)


def serve_both(lgd, name, queries_of, max_slots, **kw):
    """(reference engine, requests), (port engine, requests) of one serve."""
    out = []
    for pkg, mod, d, extra in ((repro, ref_serve, lgd[0], {}),
                               (repro_torch, port_serve, lgd[1],
                                dict(device="cpu"))):
        srv = mod.SpatialServeEngine(d.store, config(pkg, name),
                                     max_slots=max_slots, **kw, **extra)
        out.append((srv, srv.serve(queries_of(d))))
    return out


def assert_same_request(got, want):
    assert got.rid == want.rid and got.done == want.done
    assert got.steps == want.steps and got.waited == want.waited
    assert got.retries == want.retries
    assert (got.error is None) == (want.error is None)
    assert got.scores.dtype == want.scores.dtype
    np.testing.assert_array_equal(got.scores, want.scores)
    assert list(got.rows) == list(want.rows)
    for c in want.rows:
        np.testing.assert_array_equal(got.rows[c], want.rows[c])
    assert dataclasses.asdict(got.stats) == dataclasses.asdict(want.stats)


def assert_same_serve(ref_run, port_run):
    (rsrv, rreqs), (psrv, preqs) = ref_run, port_run
    assert len(preqs) == len(rreqs)
    for p, r in zip(preqs, rreqs):
        assert_same_request(p, r)
    assert dataclasses.asdict(psrv.stats) == dataclasses.asdict(rsrv.stats)


def serial(d, cfg, queries, device="cpu"):
    return [repro_torch.StreakEngine(d.store, cfg, device=device).execute(q)
            for q in queries]


def assert_serial_equal(reqs, serial_runs):
    for req, (scores, rows, _) in zip(reqs, serial_runs):
        assert req.done
        np.testing.assert_array_equal(req.scores, scores)
        assert req.rows.n == rows.n
        for v in req.query.select:
            if rows.n:      # an empty TopK relation carries no columns
                np.testing.assert_array_equal(req.rows[v.name],
                                              rows[v.name])


def _boxes(rng, n, size=0.03):
    lo = rng.random((n, 2))
    return np.concatenate([lo, lo + size * rng.random((n, 2))], axis=1)


# ------------------------------------------------- admission-loop stress ---
@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_serve_bit_identical_to_serial(lgd, cfg):
    ref_run, port_run = serve_both(lgd, cfg, mixed, max_slots=3)
    assert_same_serve(ref_run, port_run)
    srv, reqs = port_run
    assert [r.rid for r in reqs] == list(range(8))
    assert_serial_equal(reqs, serial(lgd[1], config(repro_torch, cfg),
                                     mixed(lgd[1])))
    # the slot loop really batched: pooled SIP calls covered several blocks
    assert srv.stats.sip_batches > 0
    assert srv.stats.sip_blocks > srv.stats.sip_batches
    assert (srv.stats.join_launches > 0) == cfg.startswith("fused")


def test_slot_reuse_and_no_starvation(lgd):
    ref_run, port_run = serve_both(lgd, "numpy", mixed, max_slots=2)
    assert_same_serve(ref_run, port_run)
    srv, reqs = port_run
    st = srv.stats
    assert all(r.done for r in reqs)
    assert st.admissions == len(reqs)
    # 2 slots, 8 tenants: every admission past the first pair reuses a slot
    assert st.slot_reuse == len(reqs) - 2
    assert st.max_queue >= 1
    for r in reqs:
        assert 1 <= r.steps <= st.steps
        assert r.waited < st.steps


def test_no_starvation_under_adversarial_long_short_mix(lgd):
    """Two scan-heavy tenants (huge k never θ-terminates) submitted FIRST,
    six tiny-k tenants queued behind them on 2 slots: FIFO admission keeps
    every wait under the global step count, in submission order."""
    def adversarial(d):
        return ([dataclasses.replace(d.queries[0], k=10 ** 6),
                 dataclasses.replace(d.queries[1], k=10 ** 6)]
                + [dataclasses.replace(q, k=3) for q in d.queries[2:]])
    ref_run, port_run = serve_both(lgd, "numpy", adversarial, max_slots=2)
    assert_same_serve(ref_run, port_run)
    srv, reqs = port_run
    st = srv.stats
    assert all(r.done and r.error is None for r in reqs)
    for r in reqs:
        assert 1 <= r.steps <= st.steps
        assert r.waited < st.steps
    waits = [r.waited for r in reqs]
    assert waits == sorted(waits)
    assert_serial_equal(reqs, serial(lgd[1], config(repro_torch, "numpy"),
                                     adversarial(lgd[1])))


def test_share_cache_fifo_eviction_counts_and_stays_bounded(lgd):
    ref_run, port_run = serve_both(lgd, "numpy", mixed, max_slots=3,
                                   share_cache_max=8)
    assert_same_serve(ref_run, port_run)
    srv, reqs = port_run
    assert srv.stats.share_evictions > 0
    assert len(srv.engine.share_cache) <= 8
    assert_serial_equal(reqs, serial(lgd[1], config(repro_torch, "numpy"),
                                     mixed(lgd[1])))


def test_theta_termination_releases_slots_midflight(lgd):
    ref_run, port_run = serve_both(lgd, "numpy", mixed, max_slots=3)
    assert_same_serve(ref_run, port_run)
    srv, reqs = port_run
    assert srv.stats.released_early >= 1
    early = [r for r in reqs if r.stats.early_terminated]
    assert early
    assert max(r.steps for r in early) < max(r.steps for r in reqs)


def test_serve_single_slot_degenerates_to_serial(lgd):
    ref_run, port_run = serve_both(lgd, "numpy", lambda d: mixed(d)[:3],
                                   max_slots=1)
    assert_same_serve(ref_run, port_run)
    srv, reqs = port_run
    assert_serial_equal(reqs, serial(lgd[1], config(repro_torch, "numpy"),
                                     mixed(lgd[1])[:3]))
    assert srv.stats.slot_reuse == 2


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_hot_shape_tenants_share_work_bit_identical(lgd, cfg):
    """Tenants running the SAME query shape with per-tenant k hit the
    cross-tenant share cache and stay equal to serial, scan-volume stats
    included (the join counters follow the shared launches' column split,
    so those are held to the reference's serve run)."""
    def hot(d):
        return [dataclasses.replace(d.queries[0], k=k)
                for k in (5, 20, 60, 120)]
    ref_run, port_run = serve_both(lgd, cfg, hot, max_slots=4)
    assert_same_serve(ref_run, port_run)
    srv, reqs = port_run
    for req, (scores, rows, st) in zip(
            reqs, serial(lgd[1], config(repro_torch, cfg), hot(lgd[1]))):
        np.testing.assert_array_equal(req.scores, scores)
        assert req.rows.n == rows.n
        assert req.stats.driven_rows_scanned == st.driven_rows_scanned
        assert req.stats.driven_rows_after_sip == st.driven_rows_after_sip
    assert srv.engine.share_cache
    # the share cache holds the reference's keys, so it fills alike
    assert len(srv.engine.share_cache) == len(ref_run[0].engine.share_cache)
    assert srv.stats.sip_blocks > srv.stats.sip_batches


# ------------------------------------------- cross-query join primitive ---
def _canon(chunks):
    if not chunks:
        return np.empty((2, 0), np.int64)
    a = np.concatenate(chunks, axis=1)
    return a[:, np.lexsort((a[1], a[0]))]


def _multi(sj, inputs, theta_fns, batch_cols, **kw):
    """Emitted pairs (in emit order) and stats of one multi-query run."""
    entries, got = [], []
    for (drv, dvn, dk, vk, dist, k), th in zip(inputs, theta_fns):
        acc = []
        got.append(acc)
        entries.append(sj.StreamEntry(
            drv, dvn, dk, vk, dist, k, theta_fn=th,
            emit=lambda pi, pj, a=acc: a.append(np.stack([pi, pj])),
            stats=sj.JoinStats()))
    launches = sj.fused_stream_join_multi(entries, batch_cols=batch_cols,
                                          **kw)
    return launches, got, [dataclasses.asdict(e.stats) for e in entries]


def test_multi_query_stream_join_matches_serial():
    rng = np.random.default_rng(1)
    inputs = []
    for qi in range(3):
        m, n = 40 + 8 * qi, 150 + 30 * qi
        inputs.append((_boxes(rng, m), _boxes(rng, n), rng.random(m),
                       rng.random(n), 0.15 + 0.05 * qi, 16))
    open_theta = [lambda: -np.inf] * 3
    ref = _multi(ref_sj, inputs, open_theta, 128)
    port = _multi(port_sj, inputs, open_theta, 128, device="cpu")
    assert port[0] == ref[0] >= 1
    assert port[2] == ref[2]
    for (drv, dvn, dk, vk, dist, k), got, want in zip(inputs, port[1],
                                                      ref[1]):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        alone = [np.stack([pi, pj]) for pi, pj in port_sj.fused_stream_join(
            drv, dvn, dk, vk, dist, k=k, device="cpu")]
        np.testing.assert_array_equal(_canon(got), _canon(alone))


def test_multi_query_stream_join_respects_per_query_theta():
    """A query whose θ already exceeds every pair bound emits nothing while
    its batch-mates still emit everything."""
    rng = np.random.default_rng(2)
    drv, dvn = _boxes(rng, 30), _boxes(rng, 100)
    dk, vk = rng.random(30), rng.random(100)
    inputs = [(drv, dvn, dk, vk, 0.4, 8)] * 2
    thetas = [lambda: -np.inf, lambda: np.inf]
    ref = _multi(ref_sj, inputs, thetas, 64)
    port = _multi(port_sj, inputs, thetas, 64, device="cpu")
    assert port[0] == ref[0]
    assert port[2] == ref[2]
    for got, want in zip(port[1], ref[1]):
        np.testing.assert_array_equal(_canon(got), _canon(want))
    assert port[1][0] and not port[1][1]


def test_multi_query_stream_join_overflow_and_kcap_auto():
    """Rows whose survivors overflow the partial width, recovered through
    the distance join against the entry's own column span, with the shared
    kcap tuner fed once per launch in the reference's order."""
    rng = np.random.default_rng(11)
    inputs = [(_boxes(rng, 20 + 10 * i, 0.2), _boxes(rng, 300, 0.2),
               rng.random(20 + 10 * i), rng.random(300), 0.3, 2 + i)
              for i in range(3)]
    thetas = [lambda: -np.inf, lambda: 0.9, lambda: 1.2]
    tuners = [ref_sj.KcapTuner(floor=1, ceiling=4),
              port_sj.KcapTuner(floor=1, ceiling=4)]
    ref = _multi(ref_sj, inputs, thetas, 96, tuner=tuners[0])
    port = _multi(port_sj, inputs, thetas, 96, tuner=tuners[1],
                  device="cpu")
    assert port[0] == ref[0]
    assert port[2] == ref[2]
    assert sum(s["overflow_rows"] for s in port[2]) > 0
    assert tuners[1].ewma == tuners[0].ewma
    for got, want in zip(port[1], ref[1]):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


# ------------------------------------------- pooled Phases 1-2 primitives ---
@pytest.mark.parametrize("descend", ["numpy", "kernel"])
def test_multi_cs_candidate_nodes_matches_per_block(lgd, descend):
    masks = []
    for d, plan_query, kw in ((lgd[0], ref_plan, {}),
                              (lgd[1], port_plan, dict(device="cpu"))):
        store = d.store
        plans = [plan_query(store, q) for q in d.queries[:3]]
        rng = np.random.default_rng(3)
        n_b = 6
        boxes = [_boxes(rng, 4, size=0.01)[: 2 + i % 3] for i in range(n_b)]
        cs_sets = [plans[i % 3].driven_cs for i in range(n_b)]
        dists = np.array([plans[i % 3].dist_norm for i in range(n_b)])
        in_v = store.tree.candidate_nodes(boxes, dists, cs_sets,
                                          descend_backend=descend, **kw)
        assert in_v.shape == (n_b, store.tree.n_nodes)
        for i in range(n_b):
            one = store.tree.candidate_nodes(boxes[i], float(dists[i]),
                                             cs_sets[i],
                                             descend_backend=descend, **kw)
            np.testing.assert_array_equal(in_v[i], one)
        masks.append(in_v)
    np.testing.assert_array_equal(masks[1], masks[0])


def test_multi_cs_candidate_nodes_one_descent_per_cs_group(lgd, monkeypatch):
    """On the kernel route the pooled call makes one descent a CS group,
    over the group's rows, with the group's precomputed root-path mask."""
    d = lgd[1]
    tree = d.store.tree
    plans = [port_plan(d.store, q) for q in (d.queries[0], d.queries[3])]
    assert not np.array_equal(plans[0].driven_cs, plans[1].driven_cs)
    paths = [tree.cs_path_mask(p.driven_cs, device="cpu") for p in plans]
    rng = np.random.default_rng(5)
    boxes = [_boxes(rng, 3, size=0.01) for _ in range(5)]
    calls = []
    descend = ops.tree_descend

    def counting(node_keys, cs, box_keys):
        calls.append((box_keys.shape[0], cs.clone()))
        return descend(node_keys, cs, box_keys)
    monkeypatch.setattr(ops, "tree_descend", counting)
    rows = [0, 1, 0, 0, 1]
    tree.candidate_nodes(boxes, np.array([plans[r].dist_norm for r in rows]),
                         [plans[r].driven_cs for r in rows],
                         descend_backend="kernel",
                         cs_path=[paths[r] for r in rows], device="cpu")
    assert [c[0] for c in calls] == [3, 2]
    for (_, cs), r in zip(calls, (0, 1)):
        np.testing.assert_array_equal(cs.numpy(), paths[r])


def test_select_batch_per_row_costs_match_per_block(lgd):
    out = []
    for d, plan_query, ns, kw in ((lgd[0], ref_plan, ref_ns, {}),
                                  (lgd[1], port_plan, port_ns,
                                   dict(device="cpu"))):
        tree = d.store.tree
        plans = [plan_query(d.store, q) for q in d.queries[:2]]
        rng = np.random.default_rng(4)
        n_b = 4
        boxes = [_boxes(rng, 3, size=0.02) for _ in range(n_b)]
        cs_sets = [plans[i % 2].driven_cs for i in range(n_b)]
        dists = np.array([plans[i % 2].dist_norm for i in range(n_b)])
        in_v = tree.candidate_nodes(boxes, dists, cs_sets, **kw)
        card = np.stack([tree.cs_stats.cardinality_all(c) for c in cs_sets])
        sel = ns.select_batch(tree, in_v, cs_sets, card_all=card)
        assert len(sel) == n_b
        for i in range(n_b):
            np.testing.assert_array_equal(
                sel[i], ns.select(tree, in_v[i], cs_sets[i]))
        # the list-of-CS form without a card stack gives the same rows
        for a, b in zip(ns.select_batch(tree, in_v, cs_sets), sel):
            np.testing.assert_array_equal(a, b)
        out.append(sel)
    for p, r in zip(out[1], out[0]):
        np.testing.assert_array_equal(p, r)


# ------------------------------------------------------- kcap autotuner ---
def test_kcap_tuner_ewma_math():
    for sj in (port_sj, ref_sj):
        t = sj.KcapTuner(alpha=0.25, headroom=1.5, floor=8, ceiling=1024)
        assert t.ewma is None
        t.update(np.array([3, 10, 7]))      # folds the per-launch MAX
        assert t.ewma == 10.0
        t.update(np.array([20]))
        assert t.ewma == 0.25 * 20 + 0.75 * 10.0
        t.update(np.array([], dtype=np.int64))   # empty launch: no change
        assert t.ewma == 12.5


def test_kcap_tuner_suggest_clamps():
    got = []
    for sj in (port_sj, ref_sj):
        t = sj.KcapTuner()
        row = [t.suggest(4, 4096), t.suggest(100, 4096)]
        assert row == [64, 128]             # cold start: max(k, 64), pow2
        for ewma, k, cols in ((21.0, 4, 4096), (22.0, 4, 4096),
                              (1.0, 1, 4096), (1.0, 100, 4096),
                              (5000.0, 1, 4096), (5000.0, 1, 16)):
            t.ewma = ewma
            row.append(t.suggest(k, cols))
        assert row[2:] == [32, 64, 8, 128, 1024, 16]
        got.append(row)
    assert got[0] == got[1]


def _stream(sj, drv, dvn, dk, vk, dist, k, batch_cols, tuner=None, **kw):
    stats = sj.JoinStats()
    chunks = [np.stack([pi, pj]) for pi, pj in sj.fused_stream_join(
        drv, dvn, dk, vk, dist, k=k, batch_cols=batch_cols, stats=stats,
        tuner=tuner, **kw)]
    return _canon(chunks), dataclasses.asdict(stats)


def test_kcap_undershoot_recovery_exact_and_recorded():
    """A tuner capped far below the survivor burst must not change the
    candidate set — overflowing rows are recovered — and the overflow shows
    in JoinStats, as in the reference."""
    rng = np.random.default_rng(5)
    args = (_boxes(rng, 48), _boxes(rng, 300), rng.random(48),
            rng.random(300), 0.4, 2, 64)
    base, _ = _stream(port_sj, *args, device="cpu")
    got, stats = _stream(port_sj, *args,
                         tuner=port_sj.KcapTuner(floor=1, ceiling=2),
                         device="cpu")
    want, want_stats = _stream(ref_sj, *args,
                               tuner=ref_sj.KcapTuner(floor=1, ceiling=2))
    np.testing.assert_array_equal(got, base)
    np.testing.assert_array_equal(got, want)
    assert stats == want_stats
    assert stats["overflow_rows"] > 0 and stats["overflow_batches"] > 0


def test_overflow_stats_recorded_without_tuner():
    """The fixed-width path records the overflow too: k=2 gives kcap 64,
    dist 2.0 makes all 400 columns survive."""
    rng = np.random.default_rng(6)
    args = (_boxes(rng, 30), _boxes(rng, 400), rng.random(30),
            rng.random(400), 2.0, 2, 400)
    got, stats = _stream(port_sj, *args, device="cpu")
    want, want_stats = _stream(ref_sj, *args)
    np.testing.assert_array_equal(got, want)
    assert stats == want_stats
    assert stats["overflow_rows"] > 0 and stats["overflow_batches"] > 0


# ------------------------------------------------ kernel per-row state ---
def test_kernel_per_row_dist_theta_qid_matches_ref():
    """The serving-layer kernel form: per-row distance/θ planes + query-id
    masking; the port's plain version against the reference's Pallas
    kernel in interpret mode."""
    from repro.kernels import ops as ref_ops
    rng = np.random.default_rng(7)
    m, n = 40, 130
    drv, dvn = (_boxes(rng, m).astype(np.float32),
                _boxes(rng, n).astype(np.float32))
    dk = rng.random(m).astype(np.float32)
    vk = rng.random(n).astype(np.float32)
    dist = (0.05 + 0.3 * rng.random(m)).astype(np.float32)
    theta = (0.6 * rng.random(m)).astype(np.float32)
    rq = rng.integers(0, 3, m).astype(np.int32)
    cq = rng.integers(0, 3, n).astype(np.int32)
    ws, wi, wc = ref_ops.fused_topk_join(drv, dvn, dk, vk, dist, theta,
                                         k=16, row_qid=rq, col_qid=cq,
                                         interpret=True)
    gs, gi, gc = ops.fused_topk_join(
        *(torch.from_numpy(x) for x in (drv, dvn, dk, vk, dist, theta)),
        k=16, row_qid=torch.from_numpy(rq), col_qid=torch.from_numpy(cq))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-6,
                               atol=1e-6)
    # qid masking really bit: cross-query pairs never surface
    gi_np = gi.numpy()
    for r in range(m):
        cols = gi_np[r][gi_np[r] >= 0]
        assert (cq[cols] == rq[r]).all()
