"""Tests of the benchmark itself (not collected by the repository's tests/
run). Run: python -m pytest perfbench/tests -q; on a card also
python -m pytest perfbench/tests -q -m gpu."""

import pytest
import torch


@pytest.fixture
def card():
    """A CUDA device, decided when the test runs; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
