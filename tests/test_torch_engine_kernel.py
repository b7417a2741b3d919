"""Port vs reference, end to end, with the Phase-3 join on the kernel backend
(see `test_torch_engine` for what is compared)."""
import pytest

from test_torch_engine import lgd_workload


@pytest.fixture(scope="module")
def lgd():
    return lgd_workload()


@pytest.mark.parametrize("store", ["build", "state"])
@pytest.mark.parametrize("descend", ["kernel", "numpy"])
@pytest.mark.parametrize("qi", range(8))
def test_lgd_kernel_join_matches_reference(lgd, qi, descend, store):
    lgd.check("kernel", descend, qi, store)
