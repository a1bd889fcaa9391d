import os
import json
import pathlib

# Pin the CPU with a virtual 8-device mesh BEFORE jax initializes, so the
# sharded code paths are testable without a card.  The card's own tests
# (marker "gpu") run with JAX_PLATFORMS=cuda instead; see README.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("XLA_FLAGS",
                      "--xla_force_host_platform_device_count=8")

import jax

jax.config.update("jax_enable_x64", True)

from emme_tpu import accel  # noqa: E402

# persistent compile cache: the suite is compile-dominated, and repeated
# runs on a host reuse every jitted solve instead of recompiling
accel.enable_compile_cache()

import pytest

GOLDEN_DIR = pathlib.Path(__file__).parent / "goldens"


@pytest.fixture(scope="session")
def goldens_dir():
    return GOLDEN_DIR


@pytest.fixture(scope="session")
def golden_eigenvalues():
    with open(GOLDEN_DIR / "eigenvalues.json") as f:
        return json.load(f)


def load_input(name):
    with open(GOLDEN_DIR / "inputs" / name) as f:
        return json.load(f)


@pytest.fixture(scope="session")
def tokamak_cfg():
    return load_input("tokamak.json")


@pytest.fixture(scope="session")
def stellarator_cfg():
    return load_input("stellarator.json")


@pytest.fixture
def gpu():
    """Skip unless the default device is a GPU (decided at run time, never
    at import: every xdist worker must collect the same tests)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: run with JAX_PLATFORMS=cuda -m gpu")
