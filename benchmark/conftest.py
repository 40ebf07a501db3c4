"""The benchmark's tests.  ``card`` marks a test that needs an NVIDIA GPU:
it asks for the ``card`` fixture, which looks for one when the test runs
(never at import or collection) and skips with the reason where there is
none.  On the card: ``python -m pytest benchmark -m card``."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA GPU; skips elsewhere")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda", 0)
