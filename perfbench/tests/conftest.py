"""Fixtures of the benchmark's tests. Card tests (marker ``cuda``)
decide inside a fixture whether there is a card."""
import pytest
import torch


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (TF32 exists only there)")
    return torch.device("cuda", 0)
