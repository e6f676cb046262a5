import numpy as np
import pytest

import jax

# Smoke tests and benches must see 1 device (the dry-run sets 512 itself,
# in its own process).
jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running multi-process / multi-device tests")
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (the port's Hopper kernels)")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
