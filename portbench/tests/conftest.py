"""Pytest settings of the benchmark's tests: the path to the port, the
``gpu`` marker, a CPU device."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA device (the port's kernels); skips without one")


@pytest.fixture
def cpu():
    import torch

    return torch.device("cpu")


@pytest.fixture(autouse=True)
def one_thread():
    """The tiny models gain nothing from intra-op threads; in a parallel
    test run they would only contend with the other workers for cores."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
