"""Fixtures of the benchmark's tests."""

from __future__ import annotations

import pytest

from toy_root import make_toy


@pytest.fixture
def toy(tmp_path):
    return make_toy(tmp_path), tmp_path


@pytest.fixture
def card():
    """The card, or a skip where there is none (decided here, at run
    time, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
