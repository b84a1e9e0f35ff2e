"""One torch intra-op thread for the port's CPU tests; each
`tests/test_torch_*.py` imports `one_torch_thread`, an autouse fixture of
module scope (not a test module itself).

The whole suite runs under six pytest-xdist workers (ROADMAP's Tier-1
command), and torch starts an intra-op thread per core in every worker,
so the port's small CPU tensors spend their time in oversubscribed thread
pools (on 8 cores a file that takes 13 s alone took 280 s of a worker's
time in a whole run). With one torch thread per worker, torch uses six
cores; JAX keeps its own pool. The previous count is restored after the
module.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
