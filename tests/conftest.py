import os
import sys

# Give the whole suite an 8-virtual-device CPU platform (powers of two up
# to (2, 4) meshes) so the sharded tests exercise real >1-shard meshes
# in-process instead of only 1-device parity.  XLA reads the flag at
# backend init, so it must be set before anything imports jax; if a
# runner imported jax first (or set its own device count) we leave the
# environment alone and the `multi_device` fixture skips with a reason.
if ("jax" not in sys.modules
        and "--xla_force_host_platform_device_count"
        not in os.environ.get("XLA_FLAGS", "")):
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                               + os.environ.get("XLA_FLAGS", "")).strip()

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def multi_device():
    """Session guarantee of >= 8 devices for real multi-shard meshes.

    Yields the device count.  Skips (with the reason) when the platform
    could not be virtualised — e.g. jax was already initialised by an
    earlier import, or a TPU/GPU runner pins its own topology."""
    import jax

    if jax.device_count() < 8:
        pytest.skip(
            f"needs 8 virtual devices, have {jax.device_count()} "
            f"(XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r} was set too "
            f"late or overridden)")
    return jax.device_count()


def make_instance(rng, n=24, k=4, c_f=0.7, scale=2.0):
    d = (rng.random(n) * scale).astype(np.float32)
    y = rng.random(n).astype(np.float32)
    x = (rng.random(n) < 0.4).astype(np.float32)
    return d, y, x, k, c_f


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skips without one")
