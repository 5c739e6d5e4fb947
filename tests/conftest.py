import os

# Smoke tests and benches must see the real (single) CPU device; only
# launch/dryrun.py forces 512 placeholder devices — never set that here.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA device (the H100); skipped elsewhere")


@pytest.fixture(autouse=True)
def _seed():
    np.random.seed(0)

