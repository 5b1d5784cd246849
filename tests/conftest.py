"""Test configuration: run on a virtual 8-device CPU mesh.

Must set platform flags before jax initializes (SURVEY.md §4: multi-host
tests are simulated via ``xla_force_host_platform_device_count``; GPU runs
happen through ``chip_smoke.py`` and ``bench.py``, not the unit suite).
Kernel tests run the Pallas-Triton kernels through the interpreter
(``ops._common.interpret_kernels``).
"""

import os
import sys

# SPUTNIK_TEST_GPU=1 leaves the platform to JAX (the card-only tests,
# ``pytest tests -m gpu``, on a machine with a GPU)
ON_CARD = os.environ.get("SPUTNIK_TEST_GPU") == "1"
if not ON_CARD:
    os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

if not ON_CARD:
    jax.config.update("jax_platforms", "cpu")
# Finite-difference grad checks need f64; explicit f32 arrays are unaffected.
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _seed():
    np.random.seed(0)


@pytest.fixture
def gpu():
    """The GPU devices, or a skip: for tests marked ``gpu`` (decided at
    run time, never at import, so every worker collects the same tests)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (on the card: SPUTNIK_TEST_GPU=1 "
                    "python -m pytest tests -m gpu)")
    return jax.devices()
