"""Port vs reference, end to end: the same query over the same data gives
the same answer, row order, plan log and statistics.

Both engines run one policy (merge joins, fixed partial width; probe and
rank on numpy unless a test asks for their kernels) with the Phase-3 join
and the Phase-1 descent as the axes; the port runs on ``device="cpu"``,
where its kernel backends run their plain torch versions. Each case runs
over the port's own build and over `repro_torch.interop.store_from_state`
of the reference store. This file covers the quickstart workload and the
numpy join; `test_torch_engine_fused` and `test_torch_engine_kernel` cover
the other joins on make_lgd, `test_torch_engine_probe_rank` the Bloom-probe
and rank kernels.
"""
import dataclasses
import pathlib
import types

import numpy as np
import pytest

import repro
import repro_torch
from repro.data import synth_rdf as ref_synth
from repro_torch.data import synth_rdf as port_synth
from repro_torch.interop import store_from_state
from test_torch_store import state_of

SLICE_POLICY = dict(probe="numpy", rank="numpy", impl="merge", kcap="fixed")
QUICKSTART = pathlib.Path(__file__).resolve().parents[1] / "examples" \
    / "quickstart.py"


def run(pkg, store, q, join, descend, block=None, impl="merge",
        probe_rank="numpy", **engine_kw):
    """(scores, rows, stats) of one query; `probe_rank` names the backend
    of both the Bloom probes and the rank pass."""
    cfg = dict(policy=pkg.BackendPolicy(
        join=join, descend=descend,
        **dict(SLICE_POLICY, impl=impl, probe=probe_rank, rank=probe_rank)))
    if block is not None:
        cfg["block"] = block
    return pkg.StreakEngine(store, pkg.ExecConfig(**cfg), **engine_kw) \
        .execute(q)


def assert_same_answer(got, want):
    (gs, gr, gst), (ws, wr, wst) = got, want
    assert gs.dtype == ws.dtype
    np.testing.assert_array_equal(gs, ws)
    assert list(gr) == list(wr)
    for c in wr:
        np.testing.assert_array_equal(gr[c], wr[c])
    assert dataclasses.asdict(gst) == dataclasses.asdict(wst)


class Workload:
    """One dataset in both packages, with the reference's answers cached
    per (join, descend, query) so each is computed once per module."""

    def __init__(self, ref_ds, port_ds, block=None):
        self.ref, self.port, self.block = ref_ds, port_ds, block
        self.stores = {"build": port_ds.store,
                       "state": store_from_state(state_of(ref_ds.store))}
        self._answers = {}

    def check(self, join, descend, qi, store, impl="merge",
              probe_rank="numpy"):
        key = (join, descend, qi, impl, probe_rank)
        if key not in self._answers:
            self._answers[key] = run(repro, self.ref.store,
                                     self.ref.queries[qi], join, descend,
                                     self.block, impl, probe_rank)
        got = run(repro_torch, self.stores[store], self.port.queries[qi],
                  join, descend, self.block, impl, probe_rank, device="cpu")
        assert_same_answer(got, self._answers[key])


def lgd_workload():
    build = dict(n_per_class=200, seed=0)
    return Workload(ref_synth.make_lgd(**build), port_synth.make_lgd(**build))


def _quickstart(pkg_name):
    src = QUICKSTART.read_text()
    if pkg_name == "repro_torch":
        src = src.replace("from repro", "from repro_torch")
    mod = types.ModuleType("quickstart_" + pkg_name)
    exec(compile(src, str(QUICKSTART), "exec"), mod.__dict__)
    store, q = mod.build_demo()
    return types.SimpleNamespace(store=store, queries=[q])


@pytest.fixture(scope="module")
def quickstart():
    return Workload(_quickstart("repro"), _quickstart("repro_torch"),
                    block=16)


@pytest.fixture(scope="module")
def lgd():
    return lgd_workload()


@pytest.mark.parametrize("store", ["build", "state"])
@pytest.mark.parametrize("descend", ["kernel", "numpy"])
@pytest.mark.parametrize("join", ["fused", "kernel", "numpy"])
def test_quickstart_matches_reference(quickstart, join, descend, store):
    quickstart.check(join, descend, 0, store)


@pytest.mark.parametrize("store", ["build", "state"])
@pytest.mark.parametrize("descend", ["kernel", "numpy"])
@pytest.mark.parametrize("qi", range(8))
def test_lgd_numpy_join_matches_reference(lgd, qi, descend, store):
    lgd.check("numpy", descend, qi, store)


@pytest.mark.parametrize("qi", range(8))
def test_lgd_looped_join_impl_matches_reference(lgd, qi):
    """The relational joins' looped implementation, same answers."""
    lgd.check("numpy", "numpy", qi, "build", impl="looped")
