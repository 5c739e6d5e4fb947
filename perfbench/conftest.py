"""Test settings of the benchmark's own tests (``perfbench/tests``).

Tests that need the card carry the ``chip`` marker and take the ``cuda``
fixture, which skips them where this machine has no CUDA device; the
decision is made when the test runs, never when a module is imported.
On the machine with the card they run with

    python -m pytest -q perfbench/tests -m chip
"""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA device (the H100); skipped elsewhere")


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the H100); this machine has none")
    return torch.device("cuda", 0)
