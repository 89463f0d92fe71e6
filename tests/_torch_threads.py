"""A module-scoped fixture for the port's tests of small models: import
``one_torch_thread`` into a test module to run it on one torch thread."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread while the module runs: its models are small, and
    under the suite's parallel workers torch's thread pool oversubscribes
    the cores (four concurrent runs of the xLSTM gradient and decode tests
    took 227 s each with the default threads, 32 s with one; the dense
    training module took 466 s of worker time in a 6-worker run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
