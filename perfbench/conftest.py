"""Pytest settings of the benchmark's own tests (``perfbench/tests``).

Tests that need an NVIDIA card carry the ``card`` marker and take the
``cuda_device`` fixture, which skips them where no card is visible; the
decision is made when the fixture runs, never at import.
"""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one); run on the card with "
                                       "python3 -m pytest perfbench/tests -m card")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card is visible")
    return torch.device("cuda", 0)
