"""Port vs reference, end to end, on the YAGO-shaped queries (see
`test_torch_engine` for what is compared).

`make_yago` Q1-Q4 and Q7 are star queries ranked by plain numeric
attributes; in Q5, Q6 and Q8 the spatial variable is reached through an
object position (``?a happenedIn ?b . ?b hasGeometry ?g1``), a shape no
other workload of the corpus has. Every Phase-3 join and descent backend,
with the Bloom probes and the rank pass on numpy, then on their kernels,
over the port's own build and the reference store's state.
"""
import pytest

from repro.data import synth_rdf as ref_synth
from repro_torch.data import synth_rdf as port_synth
from test_torch_engine import Workload

BUILD = dict(n_places=600, seed=1)


@pytest.fixture(scope="module")
def yago():
    return Workload(ref_synth.make_yago(**BUILD, block=128),
                    port_synth.make_yago(**BUILD, block=128))


@pytest.mark.parametrize("store", ["build", "state"])
@pytest.mark.parametrize("descend", ["kernel", "numpy"])
@pytest.mark.parametrize("join", ["fused", "kernel", "numpy"])
@pytest.mark.parametrize("qi", range(8))
def test_yago_matches_reference(yago, qi, join, descend, store):
    yago.check(join, descend, qi, store)


@pytest.mark.parametrize("store", ["build", "state"])
@pytest.mark.parametrize("join", ["fused", "kernel"])
@pytest.mark.parametrize("qi", range(8))
def test_yago_probe_rank_kernels_match_reference(yago, qi, join, store):
    yago.check(join, "kernel", qi, store, probe_rank="kernel")
