"""Shared fixture for the port's tests that need an NVIDIA card.

Whether a card is present is decided inside the fixture, at test time,
never while a module is imported, so every test worker collects the same
tests.  Tests that use it also carry the ``cuda`` marker (registered in
``pyproject.toml``); on a host without CUDA they skip with the reason.
"""

import pytest
import torch


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused_fold kernel has no CPU "
                    "mode (run `python -m pytest -m cuda` or chip_smoke.py "
                    "on the card)")
    return torch.device("cuda")
