"""Shared fixtures.  NOTE: no XLA_FLAGS here — tests run on the real
1-device CPU; multi-device behaviour is tested via subprocess helpers
(tests/_multidev.py) so the main process never forces a device count."""

import numpy as np
import pytest

from repro.core import Collaboration


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; the test skips itself, inside its body, when there is none"
    )


@pytest.fixture()
def collab():
    """Two in-memory data centers × two DTNs each (the paper's testbed shape)."""
    c = Collaboration()
    c.add_datacenter("dc0", n_dtns=2)
    c.add_datacenter("dc1", n_dtns=2)
    yield c
    c.close()


@pytest.fixture()
def rng():
    return np.random.default_rng(0)
