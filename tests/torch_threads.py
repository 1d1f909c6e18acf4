"""One torch intra-op thread per test module, for the test_torch_* files.

The suite runs in several xdist worker processes on the machine's cores,
and torch's default of one OpenMP thread per core makes concurrent workers
spin against each other: the monocular parity test that takes 33 s alone
took 815 s beside two other port test files.  Results do not depend on it:
the parity bars hold at any thread count.
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
