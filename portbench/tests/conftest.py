"""CPU tests of the benchmark: small shapes, one torch thread pool."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="session")
def _threads():
    torch.set_num_threads(4)
    yield
