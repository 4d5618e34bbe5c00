"""Test configuration: run everything on a virtual 8-device CPU mesh.

The reference can only exercise its multi-GPU paths on real hardware; we test
both distribution modes without a GPU by forcing the XLA host platform to
expose 8 devices (SURVEY.md §4).  Must run before jax is imported anywhere.

Tests marked `gpu` take the `gpu` fixture, which skips them off the card.
On the card, run them with the CPU forcing off:

    SBLAS_TEST_ON_DEVICE=1 python -m pytest tests/ -m gpu -p no:cacheprovider
"""

import os

ON_DEVICE = os.environ.get("SBLAS_TEST_ON_DEVICE") == "1"

# Force CPU for the test mesh.  A pytest plugin may import jax before this
# conftest runs, so env vars alone can be too late — use config updates,
# which take effect until backends initialize.
if not ON_DEVICE:
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

if not ON_DEVICE:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)

# Tests never write the persistent compilation cache (CLI entry points
# point it at the checkout; test workers must not share or fill it).
jax.config.update("jax_enable_compilation_cache", False)

# Double precision on the CPU test mesh: lets us verify at the reference's
# 1e-3 *absolute* tolerance exactly as its double-precision drivers do.
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from sblas.containers import CsrMatrix  # noqa: E402

REFERENCE_ASH85 = "/root/reference/ash85.mtx"


@pytest.fixture
def gpu():
    """The first device when it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (platform is {dev.platform}); run on the "
                    f"card with SBLAS_TEST_ON_DEVICE=1 -m gpu")
    return dev


@pytest.fixture(scope="session")
def ash85() -> CsrMatrix:
    """The reference's checked-in fixture, read from the read-only mount;
    falls back to a structure-matched synthetic when absent."""
    if os.path.exists(REFERENCE_ASH85):
        return CsrMatrix.from_mtx(REFERENCE_ASH85)
    from sblas.io.generate import pattern_symmetric
    return pattern_symmetric()


@pytest.fixture(scope="session")
def rng() -> np.random.RandomState:
    return np.random.RandomState(0)
