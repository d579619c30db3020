"""The benchmark's own tests.  ``card`` marks a test that needs an NVIDIA
card; it skips without one, decided in a fixture when the test runs."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    """The CUDA device, or a skip."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the card tests need an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _threads():
    """One torch thread a test: the toy runs are small, and the tests may
    run beside others."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
