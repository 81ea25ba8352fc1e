"""Fixtures of the benchmark's own tests: a small copy of the benchmark on the CPU, and
the card for the tests marked `gpu`."""

import pytest
import torch

from benchmark.tests.tiny import make_root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control is read at the cell's own size")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(min(4, saved))
    yield
    torch.set_num_threads(saved)
