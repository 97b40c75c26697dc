"""One PyTorch intra-op thread for the port's CPU parity tests.

The suite runs in six pytest-xdist worker processes on one machine
(ROADMAP.md, Tier-1 verify). With PyTorch's default of one OpenMP thread per
core in each worker, the threads outnumber the cores and the port's many
small CPU ops slow down by an order of magnitude: six concurrent copies of
``test_torch_loop_closure.py::test_no_loop_no_change`` took 428 s each with
the default threads and 17-20 s with one (8 cores). A port test module
imports ``one_torch_thread``; the fixture sets one thread for the module and
restores the previous count after it.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
