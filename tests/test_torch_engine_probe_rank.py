"""Port vs reference, end to end, with the Bloom probes and the merge-join
rank pass on their kernel backends — the reference's accelerator policy
(see `test_torch_engine` for what is compared)."""
import pytest

from test_torch_engine import Workload, _quickstart, lgd_workload


@pytest.fixture(scope="module")
def quickstart():
    return Workload(_quickstart("repro"), _quickstart("repro_torch"),
                    block=16)


@pytest.fixture(scope="module")
def lgd():
    return lgd_workload()


@pytest.mark.parametrize("join", ["fused", "kernel", "numpy"])
def test_quickstart_probe_rank_kernels_match_reference(quickstart, join):
    quickstart.check(join, "kernel", 0, "build", probe_rank="kernel")


@pytest.mark.parametrize("descend", ["kernel", "numpy"])
@pytest.mark.parametrize("qi", range(8))
def test_lgd_probe_rank_kernels_match_reference(lgd, qi, descend):
    lgd.check("fused", descend, qi, "build", probe_rank="kernel")
