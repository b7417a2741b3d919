"""Differential query fuzzing on the port: random spatial top-k queries
and query shapes on small `synth_rdf` stores, the port's `StreakEngine`
against the port's `FullScanEngine`, bit for bit.

The port of `tests/test_fuzz_queries.py`. The generator (hypothesis
strategies over the query builders and grids of
`repro_torch.data.fuzz_queries`, which `chip_smoke.py` samples too) sweeps
query shape
(class pair, distance/selectivity regime, k, ranking weights, ASC/DESC,
extra-pattern counts) and engine configuration. The reference's per-stage
knobs map onto `BackendPolicy` fields (`impl`, `join`, `probe`, `rank`,
`descend`); its interpret-mode and jitted-CPU routes, which the port does
not have, map onto `kernel`, which on ``device="cpu"`` runs the kernel's
plain torch version. Scores are compared exactly — both engines
accumulate the same f64 score keys in the same term order, so any drift
is a real soundness bug, not float noise — and the shapes' rows in their
canonical order.

Runs under real `hypothesis` when installed, or the fallback shim in
tests/_hypothesis_fallback.py (seeded random sampling) otherwise.

Set ``STREAK_FAULT_RATE`` (e.g. 0.02) to run the whole module under seeded
random fault injection at the kernel dispatch seam — the failover chains
must keep every differential property bit-identical. One test runs the
shape regression corpus under a rate of 0.05 always.
"""
import os

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.core import fault
from repro_torch.core.baselines import FullScanEngine
from repro_torch.core.executor import ExecConfig, StreakEngine
from repro_torch.core.policy import BackendPolicy
from repro_torch.core.query import Query
from repro_torch.data import fuzz_queries
from repro_torch.data.synth_rdf import make_lgd

DEV = "cpu"


def _env_rate() -> float:
    return float(os.environ.get("STREAK_FAULT_RATE", "0") or 0)


def _install_env_plan() -> None:
    fault.STATE.reset()
    if _env_rate() > 0:
        fault.install_plan(fault.FaultPlan(rate=_env_rate(), seed=7))


@pytest.fixture(scope="module", autouse=True)
def _fault_rate_from_env():
    """Optional module-wide fault injection (the fault lane): every op
    chain sees a seeded `rate` of primary-attempt failures and must recover
    bit-identically through its fallbacks."""
    _install_env_plan()
    try:
        yield
    finally:
        fault.STATE.reset()


_DATASETS: dict = {}
_ENGINES: dict = {}
_ORACLE: dict = {}
_SHARDED: dict = {}


def _dataset(seed: int):
    if seed not in _DATASETS:
        _DATASETS[seed] = make_lgd(n_per_class=60, seed=seed, block=64)
    return _DATASETS[seed]


def _config(policy=None, **cfg) -> ExecConfig:
    """ExecConfig from the policy's stage names; None means "auto"."""
    stages = {k: v or "auto" for k, v in (policy or {}).items()}
    return ExecConfig(policy=BackendPolicy(**stages), **cfg)


def _key(seed, policy, cfg) -> tuple:
    return (seed, tuple(sorted((policy or {}).items())),
            tuple(sorted(cfg.items())))


def _sharded_engine(seed: int, n_shards: int, policy=None,
                    **cfg) -> StreakEngine:
    from repro_torch.core.shard import shard_store
    skey = (seed, n_shards)
    if skey not in _SHARDED:
        _SHARDED[skey] = shard_store(_dataset(seed).store, n_shards)
    ekey = (n_shards,) + _key(seed, policy, cfg)
    if ekey not in _ENGINES:
        _ENGINES[ekey] = StreakEngine(_SHARDED[skey], _config(policy, **cfg),
                                      device=DEV)
    return _ENGINES[ekey]


def _engine(seed: int, policy=None, **cfg) -> StreakEngine:
    key = _key(seed, policy, cfg)
    if key not in _ENGINES:
        _ENGINES[key] = StreakEngine(_dataset(seed).store,
                                     _config(policy, **cfg), device=DEV)
    return _ENGINES[key]


def _mk_query(seed, *shape) -> Query:
    return fuzz_queries.topk_query(_dataset(seed).ns, *shape)


def _oracle_scores(seed, shape) -> np.ndarray:
    key = (seed, shape)
    if key not in _ORACLE:
        q = _mk_query(seed, *shape)
        scores, _, _ = FullScanEngine(_dataset(seed).store,
                                      device=DEV).execute(q)
        _ORACLE[key] = scores
    return _ORACLE[key]


def _check(seed, shape, policy=None, **cfg):
    q = _mk_query(seed, *shape)
    want = _oracle_scores(seed, shape)
    got, rows, _ = _engine(seed, policy, **cfg).execute(q)
    assert len(got) == len(want), (shape, policy, cfg)
    # ties (clipped confidences) may permute boundary ROWS, never scores
    np.testing.assert_array_equal(np.sort(got), np.sort(want))
    assert rows.n == len(got)


# --------------------------------------------------------------------------
CLS = sorted(fuzz_queries.CLASSES)
_TOPK = fuzz_queries.TOPK_PARAMS

# query shape: class pair, selectivity regime, k, weights, direction,
# extra-pattern counts (weights snapped to a grid so the oracle cache hits)
QSHAPE = st.tuples(
    st.sampled_from(CLS), st.sampled_from(CLS),
    st.sampled_from(_TOPK["dist"]),                  # dist: high -> low sel.
    st.sampled_from(_TOPK["k"]),                     # k
    st.sampled_from(_TOPK["w_a"]),                   # w_a
    st.sampled_from(_TOPK["w_b"]),                   # w_b
    st.booleans(),                                   # descending
    st.integers(0, 3), st.integers(0, 2),            # extra pattern counts
)

# the reference's (join_impl, join_backend, probe_backend, rank_backend,
# sip_lookahead), as policy stages: its "interpret" probe and "cpu" rank
# routes are the port's "kernel" (the plain version on the CPU)
ECONF = st.tuples(
    st.sampled_from(["merge", "looped"]),            # impl
    st.sampled_from(["numpy", "fused"]),             # join
    st.sampled_from([None, "numpy", "kernel"]),      # probe
    st.sampled_from([None, "numpy", "kernel"]),      # rank
    st.sampled_from([1, 3, 8]),                      # sip_lookahead
)

SEED = st.sampled_from([0, 1])


@settings(max_examples=25, deadline=None)
@given(SEED, QSHAPE, ECONF)
def test_fuzz_engine_matches_full_scan(seed, shape, econf):
    impl, join, probe, rank, lookahead = econf
    _check(seed, shape, dict(impl=impl, join=join, probe=probe, rank=rank),
           sip_lookahead=lookahead, fused_batch_cols=256)


@settings(max_examples=15, deadline=None)
@given(QSHAPE)
def test_fuzz_serving_matches_full_scan(shape):
    """The same differential property through the multi-tenant slot loop:
    a fuzzed query batched against two fixed companions must still match
    the oracle exactly."""
    from repro_torch.serve.spatial import SpatialServeEngine
    ds = _dataset(0)
    q = _mk_query(0, *shape)
    companions = [ds.queries[0], ds.queries[3]]
    srv = SpatialServeEngine(
        ds.store, _config(dict(join="fused", kcap="auto"),
                          fused_batch_cols=256), max_slots=3, device=DEV)
    reqs = srv.serve([q] + companions)
    assert reqs[0].error is None
    want = _oracle_scores(0, shape)
    np.testing.assert_array_equal(np.sort(reqs[0].scores), np.sort(want))


@settings(max_examples=15, deadline=None)
@given(SEED, QSHAPE, st.sampled_from([2, 4, 8]),
       st.sampled_from(["numpy", "fused"]))
def test_fuzz_sharded_matches_unsharded(seed, shape, n_shards, join):
    """Shard-count invariance under fuzzed query shapes: the Morton-prefix
    sharded engine must be BIT-identical (same rows, same order — not just
    the same score multiset) to the unsharded engine, which itself matches
    the full-scan oracle."""
    q = _mk_query(seed, *shape)
    policy = dict(join=join)
    got0, rows0, _ = _engine(seed, policy, fused_batch_cols=256).execute(q)
    got1, rows1, _ = _sharded_engine(seed, n_shards, policy,
                                     fused_batch_cols=256).execute(q)
    np.testing.assert_array_equal(got1, got0)
    assert rows1.keys() == rows0.keys()
    for c in rows0:
        np.testing.assert_array_equal(rows1[c], rows0[c])
    np.testing.assert_array_equal(np.sort(got1),
                                  np.sort(_oracle_scores(seed, shape)))


# ---------------------------------------------------- deterministic axes ---
# exhaustive backend matrix on two fixed shapes: guarantees every axis value
# is exercised even when the fuzz sampler (or the fallback shim) misses one
_FIXED = [
    ("class:hotel", "class:park", 6.0, 25, 1.0, 1.0, False, 1, 0),
    ("class:pub", "class:police", 3.0, 10, 1.75, 0.5, True, 2, 1),
]


@pytest.mark.parametrize("impl", ["merge", "looped"])
@pytest.mark.parametrize("join", ["numpy", "fused"])
@pytest.mark.parametrize("lookahead", [1, 8])
def test_backend_matrix_matches_oracle(impl, join, lookahead):
    for shape in _FIXED:
        _check(0, shape, dict(impl=impl, join=join),
               sip_lookahead=lookahead, fused_batch_cols=256)


@pytest.mark.parametrize("probe", [None, "numpy", "kernel"])
def test_probe_backends_match_oracle(probe):
    _check(0, _FIXED[0], dict(probe=probe))


@pytest.mark.parametrize("rank", [None, "numpy", "kernel"])
def test_rank_backends_match_oracle(rank):
    _check(0, _FIXED[1], dict(rank=rank))


@pytest.mark.parametrize("descend", ["numpy", "kernel"])
def test_descend_backends_match_oracle(descend):
    _check(0, _FIXED[0], dict(descend=descend))


# ------------------------------------------------- query-shape diversity --
# Geographica-shaped non-top-k shapes (core/shapes.py): range / within /
# kNN / spatial join, each bit-identical to its FullScanEngine brute-force
# oracle — rows AND order, not just score multisets (shape output uses a
# canonical deterministic ordering, so exact comparison is well-defined).

_SHAPE_ORACLE: dict = {}


def _mk_shape_query(seed, *sshape) -> Query:
    return fuzz_queries.shape_query(_dataset(seed).ns, *sshape)


def _shape_oracle(seed, sshape):
    key = (seed, sshape)
    if key not in _SHAPE_ORACLE:
        q = _mk_shape_query(seed, *sshape)
        _SHAPE_ORACLE[key] = FullScanEngine(_dataset(seed).store,
                                            device=DEV).execute(q)
    return _SHAPE_ORACLE[key]


def _check_shape(seed, sshape, engine):
    q = _mk_shape_query(seed, *sshape)
    want_s, want_r, _ = _shape_oracle(seed, sshape)
    got_s, got_r, _ = engine.execute(q)
    np.testing.assert_array_equal(got_s, want_s)
    assert sorted(got_r.keys()) == sorted(want_r.keys()), (sshape,)
    for c in want_r.keys():
        np.testing.assert_array_equal(got_r[c], want_r[c])


@st.composite
def _sshape_strategy(draw):
    kind = draw(st.sampled_from(sorted(fuzz_queries.SHAPE_PARAMS)))
    p1s, p2s = fuzz_queries.SHAPE_PARAMS[kind]
    return (kind, draw(st.sampled_from(CLS)), draw(st.sampled_from(CLS)),
            draw(st.sampled_from(p1s)), draw(st.sampled_from(p2s)))


SSHAPE = _sshape_strategy()

SECONF = st.tuples(
    st.sampled_from(["merge", "looped"]),            # impl
    st.sampled_from(["numpy", "kernel", "fused"]),   # join
    st.sampled_from([None, "kernel"]),               # probe
)


@settings(max_examples=25, deadline=None)
@given(SEED, SSHAPE, SECONF)
def test_fuzz_shapes_match_full_scan(seed, sshape, econf):
    impl, join, probe = econf
    eng = _engine(seed, dict(impl=impl, join=join, probe=probe),
                  fused_batch_cols=256)
    _check_shape(seed, sshape, eng)


@settings(max_examples=15, deadline=None)
@given(SEED, SSHAPE, st.sampled_from([2, 4]))
def test_fuzz_shapes_sharded_match_full_scan(seed, sshape, n_shards):
    _check_shape(seed, sshape, _sharded_engine(seed, n_shards))


# fixed-seed regression corpus: shapes that exercised real bugs during
# development (kNN certification + pair-score keying, empty driven sides,
# window slivers, zero-radius within) plus one of each kind per class mix —
# deterministic, no sampler involved
_SHAPE_CORPUS = [
    ("range", "class:hotel", "class:park", 25.0, 40.0),
    ("range", "class:pub", "class:police", 95.0, 80.0),     # mostly empty
    ("within", "class:park", "class:road", 50.0, 0.0),      # zero radius
    ("within", "class:hotel", "class:pub", 30.0, 25.0),
    ("knn", "class:hotel", "class:park", 2.0, 0.0),         # cert. doubling
    ("knn", "class:police", "class:pub", 1000.0, 0.0),      # k > candidates
    ("join", "class:hotel", "class:park", 6.0, 0.0),
    ("join", "class:road", "class:police", 0.25, 0.0),      # near-empty
]
_CORPUS_IDS = [f"{s[0]}-{s[1][6:]}-{s[2][6:]}" for s in _SHAPE_CORPUS]


@pytest.mark.parametrize("sshape", _SHAPE_CORPUS, ids=_CORPUS_IDS)
def test_shape_regression_corpus(sshape):
    _check_shape(0, sshape, _engine(0))
    _check_shape(0, sshape, _sharded_engine(0, 4))


@pytest.mark.parametrize("descend", ["numpy", "kernel"])
def test_shape_descend_backends_match_oracle(descend):
    for sshape in _SHAPE_CORPUS[::3]:
        _check_shape(0, sshape, _engine(0, dict(descend=descend)))


# ------------------------------------------------------------ fault lane --
_KERNEL_POLICY = dict(join="fused", probe="kernel", rank="kernel",
                      descend="kernel")


def test_shape_corpus_under_a_fault_rate():
    """The corpus, and the two fixed top-k shapes, under a seeded fault
    rate of 0.05: every answer equals the clean oracle's, and the failover
    chains took over at least once. Clean oracles are computed first."""
    for sshape in _SHAPE_CORPUS:
        _shape_oracle(0, sshape)
    for shape in _FIXED:
        _oracle_scores(0, shape)
    fault.STATE.reset()
    fault.install_plan(fault.FaultPlan(rate=0.05, seed=7))
    try:
        for sshape in _SHAPE_CORPUS:
            _check_shape(0, sshape, StreakEngine(
                _dataset(0).store, _config(_KERNEL_POLICY), device=DEV))
        for shape in _FIXED:
            _check(0, shape, _KERNEL_POLICY)
        stats = fault.STATE.stats
        assert fault.STATE.plan.injected > 0
        assert stats.fallbacks > 0 and stats.exhausted == 0
    finally:
        _install_env_plan()
