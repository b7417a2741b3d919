"""Port vs reference: the serving loop's crash isolation and deadlines.

The twins of the serve cases of `tests/test_fault.py`: each package runs
under its own copy of one `FaultPlan` (the port's `fused_topk_join` calls
are counted and failed at the same call indices as the reference's).
Requests and `ServeStats` must be equal, and a restarted tenant must answer
exactly as in the clean run.
"""
import dataclasses

import numpy as np
import pytest

import repro
import repro_torch
from repro.core import fault as ref_fault
from repro.core import spatial_join as ref_sj
from repro.data import synth_rdf as ref_synth
from repro.serve import spatial as ref_serve
from repro_torch.core import fault as port_fault
from repro_torch.core import spatial_join as port_sj
from repro_torch.data import synth_rdf as port_synth
from repro_torch.serve import spatial as port_serve
from test_torch_serve_spatial import assert_same_request, assert_same_serve


@pytest.fixture(autouse=True)
def _clean_fault_state():
    """Every test starts and ends with no plan and no breakers in either
    package."""
    for f in (ref_fault, port_fault):
        f.STATE.reset()
    yield
    for f in (ref_fault, port_fault):
        f.STATE.reset()


@pytest.fixture(scope="module")
def lgd():
    build = dict(n_per_class=60, seed=0, block=64)
    return ref_synth.make_lgd(**build), port_synth.make_lgd(**build)


def _serve(pkg, mod, d, queries, fused=True, max_slots=3, **kw):
    cfg = (pkg.ExecConfig(policy=pkg.BackendPolicy(join="fused"),
                          fused_batch_cols=256) if fused
           else pkg.ExecConfig())
    extra = dict(device="cpu") if pkg is repro_torch else {}
    srv = mod.SpatialServeEngine(d.store, cfg, max_slots=max_slots, **kw,
                                 **extra)
    return srv, srv.serve(queries)


def _serve_both(lgd, queries_of, **kw):
    return (_serve(repro, ref_serve, lgd[0], queries_of(lgd[0]), **kw),
            _serve(repro_torch, port_serve, lgd[1], queries_of(lgd[1]),
                   **kw))


def _fused_plan(f, call=None):
    """A plan of fault module `f` that defeats the whole chain of the fused
    join's call `call` (None: every call)."""
    return f.FaultPlan(rules=(f.FaultRule(op="fused_topk_join", call=call,
                                          attempts=99),))


def test_transient_set_names_the_reference_classes():
    assert [c.__name__ for c in port_fault.TRANSIENT] == \
        [c.__name__ for c in ref_fault.TRANSIENT]
    assert all(issubclass(c, RuntimeError) for c in port_fault.TRANSIENT)


def test_serve_deadline_tenant_partial_others_exact(lgd):
    out = []
    for pkg, mod, d in ((repro, ref_serve, lgd[0]),
                        (repro_torch, port_serve, lgd[1])):
        qs = [dataclasses.replace(q, k=40) for q in d.queries[:4]]
        extra = dict(device="cpu") if pkg is repro_torch else {}
        srv = mod.SpatialServeEngine(d.store, pkg.ExecConfig(), max_slots=2,
                                     **extra)
        reqs = [mod.SpatialRequest(rid=i, query=q) for i, q in enumerate(qs)]
        reqs[1].deadline = pkg.QueryDeadline(max_blocks=1)
        for r in reqs:
            srv.submit(r)
        srv.run()
        out.append((srv, reqs))
    assert_same_serve(*out)
    srv, reqs = out[1]
    assert all(r.done and r.error is None for r in reqs)
    assert reqs[1].stats.partial
    assert srv.stats.deadline_partials == 1
    for i in (0, 2, 3):
        want = repro_torch.StreakEngine(lgd[1].store, device="cpu").execute(
            reqs[i].query)
        np.testing.assert_array_equal(reqs[i].scores, want[0])


def test_serve_transient_fault_retries_bit_identical(lgd):
    def queries(d):
        return [dataclasses.replace(q, k=30) for q in d.queries[:4]]
    # probe runs: an empty plan's per-op counters give the clean serve's
    # dispatches, the same in both packages
    probes = [ref_fault.FaultPlan(), port_fault.FaultPlan()]
    with ref_fault.fault_plan(probes[0]), port_fault.fault_plan(probes[1]):
        clean_ref, clean = _serve_both(lgd, queries)
    assert_same_serve(clean_ref, clean)
    ncalls = probes[1].calls.get("fused_topk_join", 0)
    assert ncalls == probes[0].calls["fused_topk_join"]
    assert ncalls >= 2, "serve run never reached the fused join"
    # fail one mid-serve launch: its riders restart from fresh cursors
    plan = _fused_plan(ref_fault, ncalls // 2)
    with ref_fault.fault_plan(plan):
        faulted_ref = _serve(repro, ref_serve, lgd[0], queries(lgd[0]))
    assert plan.injected > 0
    plan = _fused_plan(port_fault, ncalls // 2)
    with port_fault.fault_plan(plan):
        srv, reqs = _serve(repro_torch, port_serve, lgd[1], queries(lgd[1]))
    assert plan.injected > 0
    assert srv.stats.faults >= 1 and srv.stats.retries >= 1
    assert all(r.done and r.error is None for r in reqs)
    for req, want in zip(reqs, clean[1]):
        np.testing.assert_array_equal(req.scores, want.scores)
        assert req.rows.n == want.rows.n
    assert_same_serve(faulted_ref, (srv, reqs))


def test_serve_retries_exhausted_surfaces_error_and_terminates(lgd):
    def queries(d):
        return [dataclasses.replace(q, k=30) for q in d.queries[:3]]
    with ref_fault.fault_plan(_fused_plan(ref_fault)):   # every call dies
        ref_run = _serve(repro, ref_serve, lgd[0], queries(lgd[0]),
                         max_retries=1)
    with port_fault.fault_plan(_fused_plan(port_fault)):
        srv, reqs = _serve(repro_torch, port_serve, lgd[1], queries(lgd[1]),
                           max_retries=1)
    assert all(r.done for r in reqs)                      # loop terminated
    assert all(isinstance(r.error, port_fault.TRANSIENT) for r in reqs)
    assert all(len(r.scores) == 0 for r in reqs)
    assert srv.stats.failed_requests == len(reqs)
    assert srv.stats.retries >= 1
    assert_same_serve(ref_run, (srv, reqs))


def test_admission_failure_surfaces_not_drops(lgd):
    def queries(d):
        good = [dataclasses.replace(q, k=20) for q in d.queries[:2]]
        bad = dataclasses.replace(good[0], spatial=None)  # cursor ctor raises
        return [good[0], bad, good[1]]
    ref_run, port_run = _serve_both(lgd, queries, fused=False, max_slots=2)
    assert_same_serve(ref_run, port_run)
    srv, reqs = port_run
    assert all(r.done for r in reqs)
    assert reqs[1].error is not None and len(reqs[1].scores) == 0
    assert srv.stats.admission_failures == 1
    for req in (reqs[0], reqs[2]):
        want = repro_torch.StreakEngine(lgd[1].store, device="cpu").execute(
            req.query)
        np.testing.assert_array_equal(req.scores, want[0])


def test_stream_entry_fault_isolates_one_rider():
    rng = np.random.default_rng(9)

    def boxes(n):
        lo = rng.random((n, 2))
        return np.concatenate([lo, lo + 0.03 * rng.random((n, 2))], axis=1)

    drv, dvn = boxes(30), boxes(120)
    dk, vk = rng.random(30), rng.random(120)

    def boom(pi, pj):
        raise RuntimeError("tenant bug")

    accs = []
    for sj, kw in ((ref_sj, {}), (port_sj, dict(device="cpu"))):
        acc: list = []
        entries = [
            sj.StreamEntry(drv, dvn, dk, vk, 0.4, 8,
                           theta_fn=lambda: -np.inf, emit=boom),
            sj.StreamEntry(drv, dvn, dk, vk, 0.4, 8,
                           theta_fn=lambda: -np.inf,
                           emit=lambda pi, pj, a=acc: a.append((pi, pj))),
        ]
        sj.fused_stream_join_multi(entries, batch_cols=64, **kw)
        assert isinstance(entries[0].error, RuntimeError)  # faulted rider
        assert entries[1].error is None and acc            # survivor emitted
        accs.append(acc)
    assert len(accs[1]) == len(accs[0])
    for (gi, gj), (wi, wj) in zip(accs[1], accs[0]):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gj, wj)


def test_whole_launch_failure_marks_every_rider():
    """A launch whose whole chain fails faults every entry riding it, and
    the call returns with no launch counted."""
    rng = np.random.default_rng(10)
    lo = rng.random((20, 2))
    drv = np.concatenate([lo, lo + 0.05], axis=1)
    entries = [port_sj.StreamEntry(drv, drv, rng.random(20), rng.random(20),
                                   0.2, 4, theta_fn=lambda: -np.inf,
                                   emit=lambda pi, pj: None)
               for _ in range(3)]
    plan = _fused_plan(port_fault)
    with port_fault.fault_plan(plan):
        assert port_sj.fused_stream_join_multi(entries, 64,
                                               device="cpu") == 0
    assert plan.calls == {"fused_topk_join": 1}
    assert all(isinstance(e.error, port_fault.FallbackExhausted)
               for e in entries)
    assert len({id(e.error) for e in entries}) == 1


def test_multi_join_without_device_raises():
    """Leaving out the device raises before any launch, as the serial join
    does, instead of running the plain versions on the CPU; no entry is
    marked."""
    rng = np.random.default_rng(11)
    lo = rng.random((8, 2))
    drv = np.concatenate([lo, lo + 0.05], axis=1)
    entry = port_sj.StreamEntry(drv, drv, rng.random(8), rng.random(8), 0.2,
                                4, theta_fn=lambda: -np.inf,
                                emit=lambda pi, pj: None)
    with pytest.raises(ValueError, match="needs a device"):
        port_sj.fused_stream_join_multi([entry], 64)
    assert entry.error is None
    with pytest.raises(ValueError, match="needs a device"):
        list(port_sj.fused_stream_join(drv, drv, rng.random(8),
                                       rng.random(8), 0.2, 4))


def test_faulted_request_results_are_typed_empty(lgd):
    """A retired request carries an empty float score array, an empty
    relation and fresh stats, as the reference's `_fail` gives."""
    with port_fault.fault_plan(_fused_plan(port_fault)):
        srv, reqs = _serve(repro_torch, port_serve, lgd[1],
                           [lgd[1].queries[0]], max_retries=0)
    with ref_fault.fault_plan(_fused_plan(ref_fault)):
        ref_run = _serve(repro, ref_serve, lgd[0], [lgd[0].queries[0]],
                         max_retries=0)
    assert_same_request(reqs[0], ref_run[1][0])
    assert reqs[0].rows.n == 0 and reqs[0].stats.driver_blocks == 0
    assert srv.stats.faults == 1 and srv.stats.retries == 0
