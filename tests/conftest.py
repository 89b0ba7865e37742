"""Test harness configuration.

Tests run on the CPU backend with 8 virtual devices (SURVEY.md §4): the
same sharding code paths as several cards, without hardware. The env
must be set BEFORE jax is imported anywhere.

Tests marked ``gpu`` need a card; the ``gpu`` fixture skips them
elsewhere. Run them on a machine with a card with

    JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
# the persistent compile cache only adds XLA:CPU machine-feature noise here
os.environ.setdefault("LDSO_NO_COMPILE_CACHE", "1")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX's default backend
    is not a GPU (decided here, at run time, never at import)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; default backend is {dev.platform}")
    return dev
