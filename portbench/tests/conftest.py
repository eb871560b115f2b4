"""The benchmark's own tests: on the CPU at small sizes, torch on few
threads.  A test that needs the card takes the ``card`` fixture, which
skips it elsewhere (marker ``cuda``)."""

import pytest
import torch

torch.set_num_threads(2)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU and nvcc; skips elsewhere")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU mode")
    return torch.device("cuda", 0)
