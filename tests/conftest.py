import os

# smoke tests/benches must see the single real CPU device -- the 512-device
# XLA_FLAGS override belongs ONLY to launch/dryrun.py (its first two lines).
assert "xla_force_host_platform_device_count" not in \
    os.environ.get("XLA_FLAGS", ""), \
    "dryrun's device-count override must not leak into the test env"

import jax
import numpy as np
import pytest

jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long jit-heavy equivalence / subprocess tests (the CI "
        'smoke job deselects them with -m "not slow")')
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device (the port's kernels have no CPU mode); "
        "skips without one")


@pytest.fixture(scope="session")
def rng():
    return np.random.RandomState(0)
