"""CPU tests of the benchmark; the ones marked `chip` need a CUDA card and
skip without one (decided inside the test)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs an NVIDIA card; skips on a machine without")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: run on the card's machine")
    return torch.device("cuda")
