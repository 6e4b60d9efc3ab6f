"""Tests of the benchmark. Run from the root of the checkout:

    python -m pytest benchmark/tests -q

Tests that need a CUDA card carry the `card` marker and take the `card`
fixture, which skips them where no card is present (decided when the
test runs, never at import). On the card: `python -m pytest
benchmark/tests -q -m card`."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped where none is present")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card in this process")
    return torch.device("cuda", 0)
