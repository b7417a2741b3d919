"""Port vs reference: the failover layer (the twins of `tests/test_fault.py`).

The same `FaultPlan` goes to both packages (the port's and the reference's
classes) over the same `make_lgd` data, the port on ``device="cpu"``, where a
chained op's attempts are its plain version, then the same again
("oracle"). Every injected failure must leave the port's answer equal to
its clean run's and to the reference's under the same plan.

Where a fault lands, `plan.calls` (dispatches per op) is compared between
the packages for the ops whose call sites match: `distance_join_matrix`
(the matrix join, and the overflow recovery of a fused batch),
`fused_topk_join` (a column batch), `merge_join_ranks` (every rank call,
numpy ones too), `tree_descend` (a CS group of a window), `bloom_probe` (a
frontier level or a root-path mask) and `tree_descend_sharded` (a window
of a sharded store). `bucketed_min_core` differs: the port makes one
grouped refinement launch a refine call, the reference one op call a size
bucket; answers are equal all the same.

The port's own rule is held too: only the fault layer's own failures fail
over, so an exception of any other class propagates from the attempt that
raised it, with no plain attempt run.
"""
import dataclasses
import time

import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.core import fault as ref_fault
from repro.core import shard as ref_shard
from repro.data import synth_rdf as ref_synth
from repro.kernels import ops as ref_ops
from repro_torch.core import fault
from repro_torch.core import shard as port_shard
from repro_torch.data import synth_rdf as port_synth
from repro_torch.kernels import ops, ref

PACKAGES = {"ref": (repro, ref_fault), "port": (repro_torch, fault)}
# ops whose call sites (and so `plan.calls`) match between the packages
SAME_CALL_SITES = ("distance_join_matrix", "fused_topk_join",
                   "merge_join_ranks", "tree_descend", "bloom_probe",
                   "tree_descend_sharded")


@pytest.fixture(autouse=True)
def _clean_fault_state():
    """Every test starts and ends with no plan, no breakers, no watchdog and
    no abandoned attempt, in both packages, and with no fallback count."""
    for f in (fault, ref_fault):
        f.STATE.reset()
    ops.reset_launch_counts()
    yield
    assert fault.STATE.join_abandoned(timeout=10)
    for f in (fault, ref_fault):
        f.STATE.reset()
    ops.reset_launch_counts()


@pytest.fixture(scope="module")
def lgd():
    build = dict(n_per_class=60, seed=0, block=64)
    ref_ds, port_ds = (m.make_lgd(**build) for m in (ref_synth, port_synth))
    return {"ref": ref_ds, "port": port_ds,
            "ref4": ref_shard.shard_store(ref_ds.store, 4),
            "port4": port_shard.shard_store(port_ds.store, 4)}


def _run(pkg_name, store, q, policy=None, deadline=None):
    pkg = PACKAGES[pkg_name][0]
    cfg = dict(fused_batch_cols=256)
    if policy is not None:
        cfg["policy"] = pkg.BackendPolicy(**policy)
    extra = dict(device="cpu") if pkg is repro_torch else {}
    eng = pkg.StreakEngine(store, pkg.ExecConfig(**cfg), **extra)
    return eng.execute(q, deadline=deadline)


def _assert_same(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    assert list(a[1]) == list(b[1])
    for c in b[1]:
        np.testing.assert_array_equal(a[1][c], b[1][c])
    assert dataclasses.asdict(a[2]) == dataclasses.asdict(b[2])


def _plan_of(f, **kw):
    """The same plan in the fault module `f` (rules given as tuples of
    `FaultRule` keyword dicts)."""
    rules = tuple(f.FaultRule(**r) for r in kw.pop("rules", ()))
    return f.FaultPlan(rules=rules, **kw)


def _both(lgd, q_index, policy, sharded=False, deadline=None, **plan_kw):
    """Each package's run of one query under its copy of one plan:
    {name: (answer, plan, FaultStats)}."""
    out = {}
    for name, (_, f) in PACKAGES.items():
        store = lgd[name + "4"] if sharded else lgd[name].store
        plan = _plan_of(f, **plan_kw)
        with f.fault_plan(plan):
            got = _run(name, store, lgd[name].queries[q_index], policy,
                       deadline)
        out[name] = (got, plan, dataclasses.replace(f.STATE.stats))
    return out


# ------------------------------------------------------- kernel failover ---
# each chained op, with a policy whose plan dispatches it (the sharded
# descent on the S = 4 store)
OP_CONFIGS = [
    ("distance_join_matrix", dict(join="kernel"), False),
    ("fused_topk_join", dict(join="fused"), False),
    ("bucketed_min_core", {}, False),
    ("merge_join_ranks", dict(impl="merge"), False),
    ("tree_descend", dict(descend="kernel"), False),
    ("bloom_probe", dict(probe="kernel"), False),
    ("tree_descend_sharded", dict(descend="kernel"), True),
]
# the attempt that recovers a primary failure on the CPU
RECOVERY = {op: "sequential" if op == "tree_descend_sharded" else "oracle"
            for op, _, _ in OP_CONFIGS}


@pytest.mark.parametrize("op,policy,sharded", OP_CONFIGS,
                         ids=[o for o, _, _ in OP_CONFIGS])
def test_each_op_failing_once_is_bit_identical(lgd, op, policy, sharded):
    store = lgd["port4"] if sharded else lgd["port"].store
    q = lgd["port"].queries[0]
    want = _run("port", store, q, policy)
    assert fault.STATE.stats == fault.FaultStats()
    assert not [k for k in ops.LAUNCHES if ":" in k]
    runs = _both(lgd, 0, policy, sharded,
                 rules=(dict(op=op, call=0),))
    got, plan, stats = runs["port"]
    assert plan.injected > 0, f"{op} was never dispatched under {policy}"
    assert stats.fallbacks > 0 and stats.failures == plan.injected
    assert ops.LAUNCHES[f"{op}:{RECOVERY[op]}"] >= 1
    _assert_same(got, want)
    _assert_same(got, runs["ref"][0])
    if op in SAME_CALL_SITES:
        assert plan.calls[op] == runs["ref"][1].calls[op]


def test_seeded_random_failure_rate_is_bit_identical(lgd):
    pol = dict(join="fused", descend="kernel", impl="merge")
    for qi in range(3):
        fault.STATE.reset()
        want = _run("port", lgd["port"].store, lgd["port"].queries[qi], pol)
        runs = _both(lgd, qi, pol, rate=0.05, seed=3)
        got, plan, stats = runs["port"]
        assert stats.fallbacks == plan.injected
        _assert_same(got, want)
        _assert_same(got, runs["ref"][0])
        for op in SAME_CALL_SITES:
            assert plan.calls.get(op) == runs["ref"][1].calls.get(op), op
    assert plan.injected > 0


def test_fault_plan_actions_match_reference():
    """The same rules, rate and seed inject at the same (op, call, attempt)
    coordinates in both packages."""
    ops_names = [o for o, _, _ in OP_CONFIGS]
    for kw in (dict(rate=0.05, seed=3), dict(rate=0.3, seed=11,
                                             ops=("fused_topk_join",)),
               dict(rules=(dict(op="tree_descend", call=4, attempts=2),
                           dict(op="bloom_probe", mode="corrupt"),
                           dict(op="merge_join_ranks", call=2, mode="delay",
                                delay_s=0.5)), rate=0.1, seed=7)):
        plans = [_plan_of(f, **dict(kw)) for f in (fault, ref_fault)]
        for op in ops_names:
            for _ in range(200):
                calls = [p.begin_call(op) for p in plans]
                assert calls[0] == calls[1]
                for attempt in range(3):
                    assert plans[0].action(op, calls[0], attempt) == \
                        plans[1].action(op, calls[1], attempt)
        assert plans[0].injected == plans[1].injected > 0


@pytest.mark.parametrize("op,policy,sharded", OP_CONFIGS,
                         ids=[o for o, _, _ in OP_CONFIGS])
def test_corrupt_then_detect_recovers_bit_identical(lgd, op, policy, sharded):
    store = lgd["port4"] if sharded else lgd["port"].store
    want = _run("port", store, lgd["port"].queries[0], policy)
    plan = fault.FaultPlan(rules=(fault.FaultRule(op=op, mode="corrupt"),))
    with fault.fault_plan(plan):
        got = _run("port", store, lgd["port"].queries[0], policy)
    assert plan.injected > 0
    assert fault.STATE.stats.corruptions_detected > 0
    _assert_same(got, want)


def _op_outputs():
    """A clean output of each chained op, with its validator."""
    rng = np.random.default_rng(0)
    boxes = torch.from_numpy(np.concatenate(
        [rng.random((6, 2)), rng.random((6, 2)) + 1.0], 1).astype(np.float32))
    keys = torch.zeros(6, dtype=torch.float32)
    fused = ops.fused_topk_join(boxes, boxes, keys, keys,
                                torch.full((6,), 2.0), torch.full((6,), -1.0),
                                k=4)
    pairs = ops.distance_join_pairs(boxes, boxes, 2.0)
    group = ops.min_core_group(2, [(3, 2, 2)])
    buf = group.pack()
    buf[group.header:] = rng.random(group.n_floats)
    cores = ops.bucketed_min_core_group(torch.from_numpy(buf), group)
    table = np.arange(0, 40, 3, dtype=np.int64)
    ranks = ops.merge_join_ranks(table, np.array([1, 5, 80]))
    node_keys = torch.from_numpy(ops.f64_sort_keys(rng.random((4, 5))))
    box_keys = torch.from_numpy(ops.f64_sort_keys(rng.random((2, 3, 4))))
    cs = torch.ones(5, dtype=torch.bool)
    mask = ops.tree_descend(node_keys, cs, box_keys)
    sharded = ops.tree_descend_sharded(
        torch.stack([node_keys] * 3).transpose(0, 1).contiguous()
        .transpose(0, 1), torch.ones((3, 5), dtype=torch.bool), box_keys)
    verdicts = ops.bloom_probe_any(torch.zeros((4, 8), dtype=torch.int32),
                                   np.arange(4), np.arange(3), 3)
    return {
        "distance_join_matrix": (pairs, lambda o: ops._v_pairs(o, 6, 6)),
        "fused_topk_join": (fused, lambda o: ops._v_fused(o, 6)),
        "bucketed_min_core": (cores, ops._v_min_core),
        "merge_join_ranks": (ranks, lambda o: ops._v_ranks(o, 14, "both")),
        "tree_descend": (mask, ops._v_mask01),
        "tree_descend_sharded": (sharded, ops._v_mask01),
        "bloom_probe": (verdicts, ops._v_mask01),
    }


def test_each_validator_rejects_its_corrupted_output():
    outs = _op_outputs()
    assert sorted(outs) == sorted(o for o, _, _ in OP_CONFIGS)
    for op, (out, valid) in outs.items():
        assert valid(out), op
        bad = fault._corrupt(out)
        assert not valid(bad), op
        assert valid(out), f"{op}: corruption wrote into the clean output"


def test_watchdog_timeout_falls_back_bit_identical(lgd):
    pol = dict(join="kernel")
    want = _run("port", lgd["port"].store, lgd["port"].queries[0], pol)
    plan = fault.FaultPlan(rules=(
        fault.FaultRule(op="distance_join_matrix", call=0, mode="delay",
                        delay_s=0.5),))
    with fault.fault_plan(plan), fault.watchdog(0.05):
        got = _run("port", lgd["port"].store, lgd["port"].queries[0], pol)
    assert fault.STATE.stats.timeouts > 0
    assert fault.STATE.abandoned
    _assert_same(got, want)
    assert fault.STATE.join_abandoned(timeout=10)


def test_watchdog_without_delay_runs_every_attempt_inline_equal(lgd):
    """An armed watchdog runs each attempt on a worker thread; with nothing
    slow, the primary attempts answer and nothing falls back."""
    pol = dict(join="fused", descend="kernel", probe="kernel")
    want = _run("port", lgd["port"].store, lgd["port"].queries[0], pol)
    with fault.watchdog(30.0):
        got = _run("port", lgd["port"].store, lgd["port"].queries[0], pol)
    _assert_same(got, want)
    assert fault.STATE.stats == fault.FaultStats()


def test_fallback_exhausted_when_every_attempt_fails():
    bits = torch.zeros((4, 8), dtype=torch.int32)
    fi, keys = np.arange(4), np.arange(4, dtype=np.int64)
    plan = fault.FaultPlan(rules=(
        fault.FaultRule(op="bloom_probe", attempts=99),))
    with fault.fault_plan(plan):
        with pytest.raises(fault.FallbackExhausted):
            ops.bloom_probe_any(bits, fi, keys, 3)
    assert fault.STATE.stats.exhausted == 1
    # clean chain works again (and closes the breakers it failed)
    assert not ops.bloom_probe_any(bits, fi, keys, 3).any()


# -------------------------------------------------------- circuit breaker ---
def test_circuit_breaker_state_machine():
    for f in (fault, ref_fault):
        br = f.CircuitBreaker(threshold=3, cooldown_s=0.05)
        seen = [br.allow(), br.open]
        br.fail(), br.fail()
        seen += [br.allow(), br.open]        # under threshold: still closed
        br.fail()
        seen += [br.open, br.allow()]        # opened, inside cooldown
        time.sleep(0.06)
        seen += [br.allow(), br.allow()]     # half-open: exactly one probe
        br.fail()                            # probe failed: reopen + recool
        seen += [br.open, br.allow()]
        time.sleep(0.06)
        seen.append(br.allow())
        br.ok()                              # probe succeeded: closed again
        seen += [br.open, br.allow()]
        assert seen == [True, False, True, False, True, False, True, False,
                        True, False, True, False, True], f.__name__


def test_open_breaker_demotes_policy_resolution():
    node_keys = torch.zeros((4, 4), dtype=torch.int64)
    boxes = torch.zeros((1, 2, 4), dtype=torch.int64)
    cs = torch.ones(4, dtype=torch.bool)
    plan = fault.FaultPlan(rules=(
        fault.FaultRule(op="tree_descend", attempts=99),))
    pol = repro_torch.BackendPolicy(descend="kernel")
    with fault.fault_plan(plan):
        for _ in range(fault.STATE.breaker_threshold):
            with pytest.raises(fault.FallbackExhausted):
                ops.tree_descend(node_keys, cs, boxes)
        assert fault.STATE.breaker("tree_descend", "plain").open
        assert fault.STATE.stats.breaker_opens == 2     # plain and oracle
        # plan-time reroute: later plans skip the broken backend entirely
        assert pol.resolve().descend == "numpy"
        assert fault.STATE.stats.policy_demotions == 1
        # untouched stages resolve as requested
        assert repro_torch.BackendPolicy(probe="kernel").resolve().probe \
            == "kernel"
    # with the plan gone the open breaker no longer reroutes anything
    assert fault.STATE.breaker("tree_descend", "plain").open
    assert pol.resolve().descend == "kernel"
    assert fault.STATE.stats.policy_demotions == 1
    with fault.watchdog(60.0):
        assert pol.resolve().descend == "numpy"
    assert fault.STATE.stats.policy_demotions == 2
    fault.STATE.reset()
    with fault.fault_plan(fault.FaultPlan()):
        assert pol.resolve().descend == "kernel"


def test_breakers_opened_in_the_reference_demote_alike():
    """The same three exhausted chains demote the same stages in both, at a
    `resolve()` made while the plan is installed."""
    for f, pkg, call in (
            (fault, repro_torch, lambda: ops.merge_join_ranks(
                np.arange(4), np.arange(2), backend="kernel", device="cpu")),
            (ref_fault, repro, lambda: ref_ops.merge_join_ranks(
                np.arange(4), np.arange(2), backend="kernel"))):
        with f.fault_plan(f.FaultPlan(rules=(
                f.FaultRule(op="merge_join_ranks", attempts=99),))):
            for _ in range(3):
                with pytest.raises(f.FallbackExhausted):
                    call()
            got = pkg.BackendPolicy(rank="kernel", join="fused").resolve()
        assert (got.rank, got.join) == ("numpy", "fused")


# ------------------------------------------------------- the port's rule ---
def test_non_fault_exception_propagates_without_a_plain_attempt(
        lgd, monkeypatch):
    """A failure outside the fault classes (here the descent's primary
    attempt raising as a failed launch would) reaches the caller as it is,
    plan or no plan, and no other attempt runs; it still counts."""
    calls = []

    def broken(*args):
        calls.append(args)
        raise RuntimeError("tree_descend: CUDA launch failed with error 700")

    monkeypatch.setattr(ref, "tree_descend_ref", broken)
    store, q = lgd["port"].store, lgd["port"].queries[0]
    for plan in (None, fault.FaultPlan()):
        with fault.fault_plan(plan):
            with pytest.raises(RuntimeError, match="error 700"):
                _run("port", store, q, dict(descend="kernel"))
    assert len(calls) == 2
    assert fault.STATE.stats.failures == 2
    assert fault.STATE.stats.fallbacks == fault.STATE.stats.exhausted == 0
    assert not [k for k in ops.LAUNCHES if ":" in k]
    # a breaker opened by such failures never sends a call past its
    # primary attempt while no plan is installed and no watchdog armed
    node_keys = torch.zeros((4, 4), dtype=torch.int64)
    boxes, cs = torch.zeros((1, 2, 4), dtype=torch.int64), torch.ones(
        4, dtype=torch.bool)
    with pytest.raises(RuntimeError):
        ops.tree_descend(node_keys, cs, boxes)
    assert fault.STATE.breaker("tree_descend", "plain").open
    with pytest.raises(RuntimeError, match="error 700"):
        ops.tree_descend(node_keys, cs, boxes)
    assert len(calls) == 4
    assert not [k for k in ops.LAUNCHES if ":" in k]
    # nor does it move the stage off its kernel at plan time
    assert repro_torch.BackendPolicy(descend="kernel").resolve().descend \
        == "kernel"
    assert fault.STATE.stats.policy_demotions == 0
    with pytest.raises(RuntimeError, match="error 700"):
        _run("port", store, q, dict(descend="kernel"))
    assert len(calls) == 5
    assert fault.STATE.stats.fallbacks == fault.STATE.stats.exhausted == 0


def test_chain_on_cuda_runs_the_kernel_then_the_plain_version():
    """The CUDA chain's order and counting, with stand-in attempts: the
    kernel answers; an injected fault moves to the plain version, counted
    under "<op>:plain"; a launch error propagates with no plain attempt."""
    log = []

    def kernel():
        log.append("kernel")
        return np.zeros(3, dtype=bool)

    def plain():
        log.append("plain")
        return np.zeros(3, dtype=bool)

    ops._chain("tree_descend", True, kernel, plain, ops._v_mask01)
    assert log == ["kernel"] and "tree_descend:plain" not in ops.LAUNCHES
    with fault.fault_plan(fault.FaultPlan(rules=(
            fault.FaultRule(op="tree_descend"),))):
        ops._chain("tree_descend", True, kernel, plain, ops._v_mask01)
    assert log == ["kernel", "plain"]
    assert ops.LAUNCHES["tree_descend:plain"] == 1
    assert fault.STATE.stats.fallbacks == 1

    def failed_launch():
        raise RuntimeError("tree_descend: CUDA launch failed with error 1")

    with fault.fault_plan(fault.FaultPlan()):
        with pytest.raises(RuntimeError, match="error 1"):
            ops._chain("tree_descend", True, failed_launch, plain)
    assert log == ["kernel", "plain"]
    ops.reset_launch_counts()
    assert "tree_descend:plain" not in ops.LAUNCHES
    assert set(ops.LAUNCHES) == set(ops._build.KERNELS)


# ----------------------------------------------------- deadlines / anytime --
def test_deadline_block_budget_matches_reference(lgd):
    """A block budget gives the reference's partial answer and its bound."""
    for blocks in (1, 2):
        runs = {name: _run(name, lgd[name].store, lgd[name].queries[0],
                           deadline=PACKAGES[name][1].QueryDeadline(
                               max_blocks=blocks))
                for name in PACKAGES}
        _assert_same(runs["port"], runs["ref"])
        assert runs["port"][2].partial and runs["port"][2].deadline_expired
