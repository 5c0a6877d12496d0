"""Test config: the tests run on the CPU backend, on a virtual 8-device
CPU mesh, so the multi-device sharding paths run without a GPU.  The
program itself runs on the GPU (``python chip_smoke.py``, and
``python chip_smoke.py --four`` for the 4-card mesh); tests that need a
card are marked ``gpu`` and skip here through the ``gpu`` fixture.

The CPU platform is forced through both the environment and
``jax.config`` before any backend is initialized, so a machine with an
accelerator plugin still runs these tests on the CPU.
"""

import os
import sys

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "true")
if os.environ.get("VBCS_TEST_ON_GPU") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"

# bench.py and chip_smoke.py live at the repository root
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

if os.environ.get("VBCS_TEST_ON_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX has none.  Decided
    here, at run time, never at import or collection, so every test
    worker collects the same tests."""
    d = jax.devices()[0]
    if d.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's first device is {d.platform}")
    return d


@pytest.fixture
def cpu_mesh_devices():
    """The virtual CPU devices of the multi-device tests (8 here)."""
    devs = jax.devices()
    if devs[0].platform != "cpu" or len(devs) < 8:
        pytest.skip("needs the virtual 8-device CPU mesh")
    return devs
