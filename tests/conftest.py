"""Test configuration: run on a virtual 8-device CPU mesh with float64.

Golden-value parity with the reference C implementation requires float64;
tests always run on CPU (chip_smoke.py runs the main path on a GPU). Multi-chip
sharding is exercised on a virtual 8-device host mesh (the same mechanism the
driver uses for ``dryrun_multichip``).
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# jax modules may already be partially imported by pytest plugins before this
# conftest runs (locking in env vars), so force the platform via config too.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402


DATA = os.path.join(os.path.dirname(__file__), "data")


@pytest.fixture(scope="session")
def data_dir():
    return DATA
