"""The port's CPU test files run torch on one thread: their tensors are
small, and the suite's workers share the machine's cores, which a
default thread pool in every worker would oversubscribe.  A test file
imports ``one_torch_thread`` (an autouse module fixture) to opt in."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one thread for the module; the worker's setting comes back
    after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
