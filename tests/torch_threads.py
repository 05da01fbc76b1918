"""One torch thread for each of the port's CPU test modules.

The suite runs in several pytest-xdist workers on one machine (six on eight
cores in the tier-1 command), and each worker's torch would start a pool of
as many OpenMP threads as the machine has cores, which wait by spinning: the
workers' pools then take the cores from each other and from XLA. A test
module of the port imports ``one_torch_thread``, an autouse fixture that
runs the module's tests with one torch thread and restores the count after.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
